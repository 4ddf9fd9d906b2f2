"""The window/cycle core: one deliver -> update -> collocate body.

Port of ``repro.core.schedule`` (single host). The engine advances the
network in windows of ``D`` cycles, parameterized by an exchange
(:mod:`repro_torch.core.exchange`):

* ``conventional``: the long-range pathway runs every cycle;
* ``structure_aware``: long-range spikes accumulate for the whole window and
  travel once, at its end. Causal because every inter-area delay is >= D
  steps; bit-identical because delivery weights live on the 1/256 grid.

Where the JAX package has ``lax.scan`` loops this has Python loops. The
structure-aware superstep (blocked ring read over the live window buffer) is
therefore one loop whether ``superstep_unroll`` is set or not; the legacy
``superstep=False`` window is the per-cycle reference.

The resilient run loop (:func:`run_windows` with a :class:`SimCheckpointer`,
a fault plan or a stop flag) and :func:`restore_sim` keep the JAX package's
checkpoint format, config hash and manifest, so a checkpoint written by
either package resumes bitwise in the other. They run the single-host
engine and the distributed one alike: on a mesh every rank runs the loop on
its own shard, and the loop answers for the whole network (spike counts,
blocks, one checkpoint, one stop window), as the reference's single
controller does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core import faults as faults_lib
from repro_torch.core import neuron as neuron_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core import ring_buffer

__all__ = [
    "CONVENTIONAL",
    "STRUCTURE_AWARE",
    "SimState",
    "SimCheckpointer",
    "area_groups",
    "state_from_numpy",
    "host_state",
    "check_seed_stim",
    "RunResult",
    "make_update_fn",
    "make_window_fn",
    "make_overlap_window_fn",
    "restore_sim",
    "resume_config_hash",
    "run_windows",
]

CONVENTIONAL = "conventional"
STRUCTURE_AWARE = "structure_aware"


@dataclasses.dataclass
class SimState:
    neuron: Any                 # LIFState or IafState
    ring: torch.Tensor          # [A, n_pad, R] f32
    t: int                      # absolute cycle index (host-side)
    spike_count: torch.Tensor   # [A, n_pad] int32 cumulative spikes
    # Spikes dropped by a fixed-size event packet: an int32 device scalar
    # once an event packet was bounded, else 0. Nonzero means the run is no
    # longer exact (raise s_max_headroom / s_max_floor, or go adaptive).
    overflow: Any = 0
    # Wire bytes the exchanges shipped (0 on a single host).
    shipped_bytes: float = 0.0
    # Optional per-neuron drive seed ([A, n_pad] int64 holding uint32
    # values), read by the counter-based drive in place of cfg.seed; a
    # broadcast cfg.seed is bitwise the int-seed path. None adds no leaf.
    seed: Any = None
    # Optional per-neuron stimulus scale ([A, n_pad] f32) on the drive rate;
    # all ones is bitwise None (x * 1.0f is exact).
    stim: Any = None


def state_from_numpy(arrays: dict, *, device) -> SimState:
    """A :class:`SimState` on ``device`` from numpy leaves.

    ``arrays`` holds ``ring``, ``t``, ``spike_count`` and either ``v``,
    ``i_syn``, ``refrac`` (LIF) or ``countdown`` (ignore-and-fire); optional
    ``overflow`` and ``shipped_bytes`` -- the JAX package's ``SimState``
    leaves as ``np.asarray`` gives them.
    """
    dev = torch.device(device)

    def leaf(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    if "countdown" in arrays:
        neuron = neuron_lib.IafState(countdown=leaf("countdown"))
    else:
        neuron = neuron_lib.LIFState(v=leaf("v"), i_syn=leaf("i_syn"), refrac=leaf("refrac"))
    return SimState(
        neuron=neuron, ring=leaf("ring"), t=int(arrays["t"]),
        spike_count=leaf("spike_count"),
        overflow=int(arrays.get("overflow", 0)),
        shipped_bytes=float(arrays.get("shipped_bytes", 0.0)))


def host_state(state: SimState) -> SimState:
    """A host copy of ``state`` (numpy leaves) in the JAX package's leaf
    dtypes: ``t`` and ``overflow`` int32, ``shipped_bytes`` f32, ``seed``
    uint32. Copies device tensors on the caller's thread and stream (and
    reading a device ``overflow`` waits for the device)."""
    def host(x):
        return x.detach().to("cpu", copy=True).numpy()

    neuron = dataclasses.replace(state.neuron, **{
        f.name: host(getattr(state.neuron, f.name))
        for f in dataclasses.fields(state.neuron)})
    return SimState(
        neuron=neuron, ring=host(state.ring), t=np.int32(state.t),
        spike_count=host(state.spike_count), overflow=np.int32(int(state.overflow)),
        shipped_bytes=np.float32(state.shipped_bytes),
        seed=None if state.seed is None else host(state.seed).astype(np.uint32),
        stim=None if state.stim is None else host(state.stim))


def check_seed_stim(cfg) -> None:
    """Refuse per-neuron ``seed`` / ``stim`` leaves where the engine would
    ignore them (the JAX engine's rules): LIF only, and not under
    ``superstep_kernel``."""
    if cfg.neuron_model != "lif":
        raise ValueError(
            "per-trial seed/stim drive the LIF Poisson input; "
            "ignore_and_fire has no seed or input dependence")
    if cfg.superstep_kernel:
        raise ValueError(
            "per-trial seed/stim are not supported under "
            "superstep_kernel (the fused kernel bakes cfg.seed in)")


def make_update_fn(cfg, spec, dt_ms: float, lif_params, fused_lif: Callable | None):
    """The neuron-update closure ``update(neuron_state, i_in, t, net, gids,
    seed=None, stim=None) -> (state', spikes)``. The LIF drive rate is
    ``rate_hz * (ext_rate_hz / 2.5)``, the JAX package's one expression;
    ``seed`` / ``stim`` (the ``SimState`` leaves) replace ``cfg.seed`` and
    scale the rate."""
    drive_scale = spec.ext_rate_hz / 2.5

    def update(neuron_state, i_in, t, net, gids, seed=None, stim=None):
        if cfg.neuron_model == "lif":
            rate = net.rate_hz * drive_scale
            if stim is not None:
                rate = rate * stim
            drive = neuron_lib.poisson_drive(
                cfg.seed if seed is None else seed, t, gids, rate, dt_ms, spec.w_ext)
            if fused_lif is not None:
                return fused_lif(neuron_state, i_in + drive, net.alive)
            return neuron_lib.lif_update(
                neuron_state, i_in + drive, net.alive, lif_params)
        return neuron_lib.ignore_and_fire_update(
            neuron_state, i_in, net.alive, net.rate_hz, dt_ms)

    return update


def make_window_fn(
    cfg, exchange, update_fn: Callable, *, fused_superstep: Callable | None = None,
) -> Callable:
    """Build ``window(state, net, gids) -> (state', block [D, A, n] bool)``.

    The input state is left as it was: the ring is cloned once per window
    and then updated in place. ``fused_superstep`` (``(neuron, fut, t0) ->
    (neuron', block, fut')``, :func:`engine.make_fused_superstep`) replaces
    the structure-aware in-window loop with the fused superstep kernel; the
    lumped exchange still goes through the exchange hook.
    """
    compute_window = _make_compute_window(cfg, exchange, update_fn, fused_superstep)
    blocked = bool(cfg.use_superstep)

    def window(state: SimState, net, gids):
        t0 = state.t
        state, block = compute_window(state, state.ring.clone(), net, gids)
        if cfg.schedule == CONVENTIONAL:
            return state, block
        # The lumped global exchange: every inter-area delay is >= D, so
        # slot (t0 + s + d) lies strictly after the window.
        ring, d_over, d_ship = exchange.window_end(
            state.ring, block, t0, net, gids, blocked=blocked)
        return dataclasses.replace(
            state, ring=ring, overflow=state.overflow + d_over,
            shipped_bytes=state.shipped_bytes + d_ship), block

    return window


def _make_compute_window(cfg, exchange, update_fn, fused_superstep):
    """The window body without the structure-aware window-end exchange:
    ``compute(state, ring, net, gids) -> (state', block)``, where ``ring`` is
    the caller's own copy of ``state.ring``, updated in place. Under the
    conventional schedule this is the whole window (the cycle hook runs the
    long-range pathway too)."""

    def compute_window(state: SimState, ring, net, gids):
        D = net.delay_ratio
        t0 = state.t
        neuron, over, shipped = state.neuron, state.overflow, state.shipped_bytes
        cols = []
        if cfg.use_superstep:
            # The window's D input slots are one contiguous ring block (t0 and
            # ring_len are multiples of D); cycles read columns of the live
            # buffer `fut`, and `t` handed to the cycle hook is the slot index.
            fut, ring = ring_buffer.open_window(ring, t0, D, net.live_window)
            if fused_superstep is not None:
                neuron, block, fut = fused_superstep(neuron, fut, t0)
            else:
                for s in range(D):
                    neuron, spikes = update_fn(neuron, fut[..., s], t0 + s, net, gids,
                                               seed=state.seed, stim=state.stim)
                    fut, d_over, d_ship = exchange.cycle(
                        fut, spikes, s, net, gids, inter_now=False)
                    over, shipped = over + d_over, shipped + d_ship
                    cols.append(spikes)
                block = torch.stack(cols)
            ring = ring_buffer.merge_window_tail(ring, fut[..., D:], t0 + D)
        else:
            inter_now = cfg.schedule == CONVENTIONAL
            for s in range(D):
                i_in, ring = ring_buffer.read_and_clear(ring, t0 + s)
                neuron, spikes = update_fn(neuron, i_in, t0 + s, net, gids,
                                           seed=state.seed, stim=state.stim)
                ring, d_over, d_ship = exchange.cycle(
                    ring, spikes, t0 + s, net, gids, inter_now=inter_now)
                over, shipped = over + d_over, shipped + d_ship
                cols.append(spikes)
            block = torch.stack(cols)
        return dataclasses.replace(
            state, neuron=neuron, ring=ring, t=t0 + D,
            spike_count=state.spike_count + block.sum(0, dtype=torch.int32),
            overflow=over, shipped_bytes=shipped), block

    return compute_window


def make_overlap_window_fn(
    cfg, exchange, update_fn: Callable, *, fused_superstep: Callable | None = None,
) -> tuple[Callable, Callable]:
    """Build the double-buffered window pair ``(window_overlap, drain)``.

    ``window_overlap(state, inflight, net, gids) -> (state', inflight',
    block)`` first finishes the previous window's in-flight exchange (its
    earliest deposit lands on the first ring slot this window reads), then
    runs the window's compute, then starts this window's exchange and hands
    it back in flight. ``drain(state, inflight, net, gids) -> state'``
    retires an in-flight window, so a drained pipeline is bitwise the
    sequential trajectory. Neither modifies its input state.
    """
    if cfg.schedule == CONVENTIONAL:
        raise ValueError(
            "overlap_exchange requires the structure-aware schedule: the "
            "conventional schedule has no lumped window-end exchange to "
            "overlap with compute")
    compute_window = _make_compute_window(cfg, exchange, update_fn, fused_superstep)
    blocked = bool(cfg.use_superstep)

    def window_overlap(state: SimState, inflight, net, gids):
        ring = exchange.finish_window_end(
            state.ring.clone(), inflight, net, gids, blocked=blocked)
        t0 = state.t
        state, block = compute_window(state, ring, net, gids)
        inflight, d_over, d_ship = exchange.start_window_end(
            block, t0, net, gids, blocked=blocked)
        return dataclasses.replace(
            state, overflow=state.overflow + d_over,
            shipped_bytes=state.shipped_bytes + d_ship), inflight, block

    def drain(state: SimState, inflight, net, gids):
        if inflight.wire is None:
            return state
        ring = exchange.finish_window_end(
            state.ring.clone(), inflight, net, gids, blocked=blocked)
        return dataclasses.replace(state, ring=ring)

    return window_overlap, drain


# ---------------------------------------------------------------------------
# Windowed checkpoint / resume / fault-tolerant run loop
# ---------------------------------------------------------------------------
#
# Checkpoints are taken only at window boundaries: there t ≡ 0 (mod D), the
# live window buffer is merged back and the ring's phase alignment is the
# one a fresh init has, so a restored state re-enters the superstep exactly
# where the uninterrupted run would. The drive is a counter-based function
# of (seed, t, gid), so the seed and t in the manifest are its whole RNG
# state: resume is bitwise, not statistical.


# Config fields that are layout, not trajectory: every value gives the same
# spike trains, so checkpoints stay exchangeable across them. Recorded in the
# manifest payload, left out of the compatibility hash and the mismatch diff.
_LAYOUT_KEYS = frozenset(
    {"shard_inter_tables", "subgroup_inter_tables", "overlap_exchange",
     "sharded_build"})


def resume_config_hash(cfg, net, *, exchange: str | None = None):
    """``(hash, payload)`` identifying what a checkpoint can resume into:
    the JAX package's payload and 16-hex digest for the same config and
    network. Covers what changes the trajectory (neuron model, schedule,
    exchange, adaptive flag, backend, seed, packet bounds) and the network
    invariants the state's shapes encode (D, ring length, area grid);
    ``_LAYOUT_KEYS`` ride in the payload outside the hash. ``exchange``
    overrides ``cfg.exchange`` (launchers hash the requested exchange)."""
    payload = {
        "neuron_model": cfg.neuron_model,
        "schedule": cfg.schedule,
        "exchange": cfg.exchange if exchange is None else exchange,
        "adaptive_exchange": bool(cfg.adaptive_exchange),
        "delivery_backend": cfg.backend,
        "seed": int(cfg.seed),
        "s_max_headroom": float(cfg.s_max_headroom),
        "s_max_floor": int(cfg.s_max_floor),
        "delay_ratio": int(net.delay_ratio),
        "ring_len": int(net.ring_len),
        "n_areas": int(net.n_areas),
        "n_pad": int(net.n_pad),
        "shard_inter_tables": bool(cfg.shard_inter_tables),
        "subgroup_inter_tables": bool(cfg.subgroup_inter_tables),
        "overlap_exchange": bool(cfg.overlap_exchange),
        "sharded_build": bool(cfg.sharded_build),
    }
    hashed = {k: v for k, v in payload.items() if k not in _LAYOUT_KEYS}
    digest = hashlib.sha256(
        json.dumps(hashed, sort_keys=True).encode()).hexdigest()[:16]
    return digest, payload


def area_groups(engine) -> int:
    """The group count a checkpoint records: the product of a distributed
    engine's area axes (the reference CLI records ``mesh.shape['data']``), 1
    on a single host."""
    mesh = engine.mesh
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in mesh.axis_names[:-1])


class SimCheckpointer:
    """Windowed ``SimState`` checkpoints through ``checkpoint.AsyncWriter``.

    ``save`` copies the whole state to the host (:func:`host_state`, on the
    caller's thread) and submits it with the reference's manifest: window
    phase, seed, group count (:func:`area_groups`) and resume-config hash.
    The step id is the count of completed windows (``t // D``).

    On a distributed engine every rank holds one: ``save`` gathers the
    whole state on every rank (a collective, so every rank calls it), rank
    0 alone writes it, and ``close`` holds every rank at a barrier until
    rank 0's writes are on disk.
    """

    def __init__(
        self,
        directory: str,
        engine,
        net,
        *,
        every: int = 50,
        keep: int = 3,
        exchange: str | None = None,
        injector: faults_lib.FaultInjector | None = None,
        retries: int = 3,
        backoff_s: float = 0.05,
    ):
        from repro_torch.checkpoint import manager as ckpt_manager

        self.directory = directory
        self.every = every
        self.delay_ratio = int(engine.delay_ratio)
        self.seed = int(engine.config.seed)
        self.n_groups = area_groups(engine)
        self.mesh = engine.mesh
        self._gather = engine.gather_state
        self.config_hash, self.config_payload = resume_config_hash(
            engine.config, net, exchange=exchange)
        save_fn = None
        if injector is not None and injector.cfg.ckpt_write_failures > 0:
            save_fn = injector.wrap_save(ckpt_manager.save)
        self.writer = None
        if self.mesh is None or self.mesh.rank == 0:
            self.writer = ckpt_manager.AsyncWriter(
                directory, keep=keep, retries=retries, backoff_s=backoff_s,
                save_fn=save_fn)
        self.saved_windows: list[int] = []

    def due(self, window: int) -> bool:
        """Does the cadence fire at this completed-window count? The
        overlapped loop asks before it touches the state, so the in-flight
        window can drain first."""
        w = int(window)
        return self.every > 0 and w > 0 and w % self.every == 0

    def maybe_save(self, state: SimState, window: int | None = None) -> int | None:
        """Save when the completed-window count hits the cadence."""
        w = int(state.t) // self.delay_ratio if window is None else int(window)
        if self.due(w):
            return self.save(state)
        return None

    def save(self, state: SimState) -> int:
        """Submit a window-boundary checkpoint; returns the step id."""
        t = int(state.t)
        if t % self.delay_ratio != 0:
            raise ValueError(
                f"checkpoint requested mid-window (t={t}, D="
                f"{self.delay_ratio}): only window boundaries keep the ring "
                f"phase alignment a resumed superstep needs")
        w = t // self.delay_ratio
        if self.saved_windows and self.saved_windows[-1] == w:
            return w  # boundary already checkpointed (cadence + preemption)
        ring_len = int(state.ring.shape[-1])
        extra = {
            "kind": "simstate",
            "t": t,
            "window": w,
            "window_phase": 0,
            "delay_ratio": self.delay_ratio,
            "ring_len": ring_len,
            "ring_phase": t % ring_len,
            "seed": self.seed,
            "n_groups": self.n_groups,
            "config_hash": self.config_hash,
            "config": self.config_payload,
        }
        if self.mesh is not None:
            state = self._gather(state)
        if self.writer is not None:
            self.writer.submit(w, host_state(state), extra=extra)
        self.saved_windows.append(w)
        return w

    @property
    def retry_count(self) -> int:
        return 0 if self.writer is None else self.writer.retry_count

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))


def _state_template(cfg, net, keys) -> SimState:
    """A whole-network ``SimState`` of meta tensors with the engine's shapes
    and dtypes (no device memory), with ``seed`` / ``stim`` where the
    checkpoint has them."""
    a, n_pad = net.n_areas, net.n_pad

    def meta(dtype, *tail):
        return torch.empty((a, n_pad, *tail), dtype=dtype, device="meta")

    if cfg.neuron_model == "lif":
        neuron = neuron_lib.LIFState(v=meta(torch.float32), i_syn=meta(torch.float32),
                                     refrac=meta(torch.int32))
    else:
        neuron = neuron_lib.IafState(countdown=meta(torch.int32))
    return SimState(
        neuron=neuron, ring=meta(torch.float32, net.ring_len), t=0,
        spike_count=meta(torch.int32), overflow=0, shipped_bytes=0.0,
        seed=meta(torch.int64) if ".seed" in keys else None,
        stim=meta(torch.float32) if ".stim" in keys else None)


def _permute_areas(state: SimState, order: np.ndarray) -> SimState:
    """Re-order the leading area axis of every area-keyed leaf."""
    n_areas = int(state.spike_count.shape[0])
    idx = torch.as_tensor(np.asarray(order), dtype=torch.long)

    def permute(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 and x.shape[0] == n_areas:
            return x.index_select(0, idx.to(x.device))
        return x

    neuron = dataclasses.replace(state.neuron, **{
        f.name: permute(getattr(state.neuron, f.name))
        for f in dataclasses.fields(state.neuron)})
    return dataclasses.replace(
        state, neuron=neuron, ring=permute(state.ring), spike_count=permute(state.spike_count),
        seed=permute(state.seed), stim=permute(state.stim))


def restore_sim(
    directory: str,
    engine,
    net,
    *,
    exchange: str | None = None,
):
    """Restore the latest ``SimState`` checkpoint into ``engine``,
    resharding when the group count changed.

    Fails fast, before any array is read, when the checkpoint's
    resume-config hash differs from this run's (the reference's
    field-by-field error), when its window phase is unaligned, when its
    areas cannot rebalance onto this engine's group count
    (:func:`area_groups`), or when it holds ``seed`` / ``stim`` leaves the
    engine would ignore (``Engine.init``'s refusals). On another group count
    the elastic reshard plan (:func:`~repro_torch.core.partition.
    elastic_reshard_plan`) re-orders the area rows (the identity for the
    contiguous plans it makes), as the reference does.

    ``net`` is the whole network (its ``alive`` gives the area sizes): on a
    mesh the global one every rank built, or
    :func:`~repro_torch.core.dist_engine.shape_network` after a host-free
    build. A single host loads the arrays straight into device tensors on
    ``net``'s device; on a mesh every rank reads the whole state to the host
    and keeps its own block (``engine.shard_state``). ``overflow`` comes
    back as the engine's windows keep it (an int32 device scalar where the
    static packets count drops, else an int), ``seed`` / ``stim`` where the
    checkpoint has them. Returns ``(state, info)``, ``info`` holding the
    manifest, the step and the reshard accounting.
    """
    from repro_torch.checkpoint import manager as ckpt_manager

    manifest, step = ckpt_manager.read_manifest(directory)
    extra = manifest.get("extra", {})
    cfg = engine.config
    expect_hash, payload = resume_config_hash(cfg, net, exchange=exchange)
    got_hash = extra.get("config_hash")
    if got_hash is not None and got_hash != expect_hash:
        old = extra.get("config", {})
        diffs = [
            f"  {k}: checkpoint={old.get(k)!r} != run={v!r}"
            for k, v in payload.items()
            if k not in _LAYOUT_KEYS and old.get(k) != v
        ] or [f"  config hash {got_hash} != {expect_hash}"]
        raise ValueError(
            "checkpoint is incompatible with this run's config -- resuming "
            "would not reproduce the uninterrupted trajectory:\n"
            + "\n".join(diffs))
    if extra.get("window_phase", 0) != 0:
        raise ValueError(
            f"checkpoint at step {step} is not window-phase aligned "
            f"(window_phase={extra.get('window_phase')}); only "
            f"window-boundary checkpoints can resume the D-cycle superstep")
    if ".seed" in manifest["keys"] or ".stim" in manifest["keys"]:
        check_seed_stim(cfg)
    n_groups = area_groups(engine)
    old_groups = int(extra.get("n_groups", n_groups))
    order = reshard_info = None
    if n_groups != old_groups:
        sizes = net.alive.sum(dim=1).cpu().numpy().astype(int)
        placement = partition_lib.placement_from_sizes(sizes, old_groups, n_pad=int(net.n_pad))
        # Raises (before any array is read) when the areas cannot rebalance.
        plan = partition_lib.elastic_reshard_plan(placement, n_groups)
        order = partition_lib.reshard_area_order(plan)
        reshard_info = {"old_n_groups": old_groups, "new_n_groups": n_groups,
                        "moved_areas": partition_lib.reshard_moves(plan)}

    mesh = engine.mesh
    dev = net.device if mesh is None else torch.device("cpu")
    state, _ = ckpt_manager.restore(
        directory, _state_template(cfg, net, manifest["keys"]), step, device=dev)
    if order is not None and not np.array_equal(order, np.arange(order.size)):
        state = _permute_areas(state, order)
    if mesh is not None:
        state = engine.shard_state(state)
        dev = mesh.device
    if counts_overflow(cfg):
        state.overflow = torch.tensor(state.overflow, dtype=torch.int32, device=dev)
    return state, {"step": step, "manifest": manifest, "reshard": reshard_info}


def counts_overflow(cfg) -> bool:
    """Whether the engine's windows keep ``overflow`` as a device scalar:
    the static event packets, and the routed exchange's static packets on
    every backend."""
    return ((cfg.backend == "event" or cfg.exchange == "routed")
            and not cfg.adaptive_exchange)


@dataclasses.dataclass
class RunResult:
    """Outcome of :func:`run_windows` (also carried by ``Preempted``)."""

    state: SimState
    spikes_per_window: np.ndarray   # [windows_done] int64
    window_times_s: np.ndarray      # wall per window, injected jitter included
    windows_done: int               # completed in this call
    injected_sleep_s: float = 0.0
    overlapped: bool = False        # ran the double-buffered pipeline
    drains: int = 0                 # in-flight windows retired at boundaries


def _preempted(window: int, path: str | None, result: RunResult) -> faults_lib.Preempted:
    exc = faults_lib.Preempted(window, path)
    exc.result = result
    return exc


def _wait(x: torch.Tensor) -> None:
    """Block until the device has finished the work that produces ``x``."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def run_windows(
    engine,
    state: SimState,
    n_windows: int,
    *,
    checkpointer: SimCheckpointer | None = None,
    faults: faults_lib.FaultConfig | faults_lib.FaultInjector | None = None,
    on_window: Callable[[int, SimState], None] | None = None,
    on_block: Callable[[int, Any], None] | None = None,
    stop_requested: Callable[[], bool] | None = None,
) -> RunResult:
    """The resilient run loop: windowed, checkpointed, fault-aware.

    After every window it waits for the device, then submits a checkpoint
    when the cadence fires, sleeps the injected faults, and stops -- a final
    checkpoint first, then :class:`~repro_torch.core.faults.Preempted` with
    the result as ``exc.result`` -- on simulated preemption or when
    ``stop_requested()`` turns true (a signal handler's flag).

    With the overlapped pipeline (``engine.window_overlap`` set) the loop
    threads the in-flight window through and drains it before a checkpoint,
    on a stop and at the end, so every saved or returned state is the
    sequential trajectory's. Injected sleeps model the pipeline: ``compute +
    comm`` a window when sequential, ``max(compute, previous comm)`` when
    pipelined, the last comm paid at the drain. ``faults`` defaults to
    ``engine.config.faults``; an injector can be shared across resume legs.

    ``on_block(w, block)`` fires after every window with its ``[D, A, n]``
    bool spike block, ``on_window(w, state)`` with the new state (under the
    pipeline its ring may still lack the window's long-range deposits).

    On a distributed engine every rank runs the loop. The spikes a window
    are the whole network's (one sum over the ranks), ``on_block`` gets the
    whole block (gathered only when it is set), the injector draws for
    ``mesh.size`` devices (keyed by ``(seed, window)``, so every rank sleeps
    the same jitter), and ``stop_requested()`` is agreed by one max over the
    ranks a window: a signal that reaches one rank stops every rank at the
    same window. ``on_window`` gets this rank's shard of the state.
    """
    mesh = engine.mesh
    fault_arg = faults if faults is not None else engine.config.faults
    if isinstance(fault_arg, faults_lib.FaultInjector):
        injector = fault_arg
    elif fault_arg is not None and fault_arg.any_enabled:
        injector = faults_lib.FaultInjector(
            fault_arg, n_devices=1 if mesh is None else mesh.size,
            delay_ratio=engine.delay_ratio)
    else:
        injector = None

    overlapped = engine.window_overlap is not None
    inflight = engine.init_inflight() if overlapped else None
    in_flight_dirty = False
    pending_comm = 0.0
    drains = 0

    D = int(engine.delay_ratio)
    w_done = int(state.t) // D  # absolute windows completed
    spikes: list[int] = []
    times: list[float] = []
    slept = 0.0

    def result() -> RunResult:
        return RunResult(
            state=state,
            spikes_per_window=np.asarray(spikes, dtype=np.int64),
            window_times_s=np.asarray(times, dtype=np.float64),
            windows_done=len(times),
            injected_sleep_s=slept,
            overlapped=overlapped,
            drains=drains,
        )

    def drain_pipeline():
        """Retire the in-flight window (and pay its modelled comm time)."""
        nonlocal state, inflight, in_flight_dirty, pending_comm, slept, drains
        if not overlapped or not in_flight_dirty:
            return
        state = engine.drain(state, inflight)
        inflight = engine.init_inflight()
        _wait(state.ring)
        if injector is not None and pending_comm > 0.0:
            slept += injector.inject(pending_comm)
        pending_comm = 0.0
        in_flight_dirty = False
        drains += 1

    for _ in range(n_windows):
        t0 = time.perf_counter()
        if overlapped:
            state, inflight, block = engine.window_overlap(state, inflight)
            in_flight_dirty = True
        else:
            state, block = engine.window(state)
        _wait(state.ring)
        w_done += 1
        if injector is not None:
            comp = injector.window_jitter_s(w_done)
            comm_s = injector.window_comm_jitter_s(w_done)
            if overlapped:
                # This window's compute straggler overlaps the previous
                # window's exchange; its own exchange is next window's
                # in-flight time.
                slept += injector.inject(max(comp, pending_comm))
                pending_comm = comm_s
            else:
                slept += injector.inject(comp + comm_s)
        times.append(time.perf_counter() - t0)
        if mesh is None:
            spikes.append(int(block.sum()))
        else:
            total = comm.all_reduce(block.sum(dtype=torch.int64).reshape(1), mesh,
                                    mesh.axis_names, op="sum")
            spikes.append(int(total[0]))
        if on_block is not None:
            on_block(w_done, block if mesh is None else engine.gather_block(block))
        if checkpointer is not None and checkpointer.due(w_done):
            drain_pipeline()
            checkpointer.maybe_save(state, window=w_done)
        if on_window is not None:
            on_window(w_done, state)
        stop = stop_requested is not None and stop_requested()
        if stop_requested is not None and mesh is not None:
            asked = torch.tensor([int(stop)], dtype=torch.int64, device=mesh.device)
            stop = bool(comm.all_reduce(asked, mesh, mesh.axis_names, op="max")[0])
        if (injector is not None and injector.preempt_now(w_done)) or stop:
            drain_pipeline()
            path = None
            if checkpointer is not None:
                checkpointer.save(state)   # the SIGTERM-grace checkpoint
                checkpointer.close()
                path = checkpointer.directory
            # Raised unbound: a local holding the exception would tie this
            # frame (engine, network, state) into a cycle with its traceback.
            raise _preempted(w_done, path, result())
    drain_pipeline()
    return result()
