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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import neuron as neuron_lib
from repro_torch.core import ring_buffer

__all__ = [
    "CONVENTIONAL",
    "STRUCTURE_AWARE",
    "SimState",
    "state_from_numpy",
    "RunResult",
    "make_update_fn",
    "make_window_fn",
    "make_overlap_window_fn",
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


def make_update_fn(cfg, spec, dt_ms: float, lif_params, fused_lif: Callable | None):
    """The neuron-update closure ``update(neuron_state, i_in, t, net, gids)
    -> (state', spikes)``. The LIF drive rate is ``rate_hz * (ext_rate_hz /
    2.5)``, the JAX package's one expression."""
    drive_scale = spec.ext_rate_hz / 2.5

    def update(neuron_state, i_in, t, net, gids):
        if cfg.neuron_model == "lif":
            drive = neuron_lib.poisson_drive(
                cfg.seed, t, gids, net.rate_hz * drive_scale, dt_ms, spec.w_ext)
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
                    neuron, spikes = update_fn(neuron, fut[..., s], t0 + s, net, gids)
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
                neuron, spikes = update_fn(neuron, i_in, t0 + s, net, gids)
                ring, d_over, d_ship = exchange.cycle(
                    ring, spikes, t0 + s, net, gids, inter_now=inter_now)
                over, shipped = over + d_over, shipped + d_ship
                cols.append(spikes)
            block = torch.stack(cols)
        return SimState(
            neuron=neuron, ring=ring, t=t0 + D,
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


@dataclasses.dataclass
class RunResult:
    """Outcome of :func:`run_windows`."""

    state: SimState
    spikes_per_window: np.ndarray   # [windows_done] int64
    window_times_s: np.ndarray      # wall per window
    windows_done: int
    overlapped: bool = False        # ran the double-buffered pipeline
    drains: int = 0                 # in-flight windows retired at boundaries


def run_windows(
    engine,
    state: SimState,
    n_windows: int,
    *,
    checkpointer=None,
    faults=None,
    on_window: Callable[[int, SimState], None] | None = None,
    on_block: Callable[[int, Any], None] | None = None,
    stop_requested: Callable[[], bool] | None = None,
) -> RunResult:
    """The windowed run loop: one window at a time, synchronised and timed.

    ``on_block(w, block)`` fires after every window with its ``[D, A, n]``
    bool spike block, ``on_window(w, state)`` with the new state. When the
    engine carries the overlapped pipeline (``engine.window_overlap`` is
    set), the loop threads the in-flight window through and drains it at the
    end of the run, so the returned state is the sequential trajectory's;
    the state ``on_window`` sees may still lack its window's long-range
    deposits. Checkpointing, fault injection and preemption
    (``checkpointer``, ``faults``, ``stop_requested``) are not ported yet
    and raise.
    """
    if checkpointer is not None or faults is not None or stop_requested is not None:
        raise NotImplementedError(
            "checkpointer / faults / stop_requested are not ported yet "
            "(ROADMAP: resilience)")
    overlapped = getattr(engine, "window_overlap", None) is not None
    inflight = engine.init_inflight() if overlapped else None
    drains = 0
    D = int(engine.delay_ratio)
    w_done = state.t // D
    spikes, times = [], []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        if overlapped:
            state, inflight, block = engine.window_overlap(state, inflight)
        else:
            state, block = engine.window(state)
        spikes.append(int(block.sum()))  # waits for the window to finish
        times.append(time.perf_counter() - t0)
        w_done += 1
        if on_block is not None:
            on_block(w_done, block)
        if on_window is not None:
            on_window(w_done, state)
    if overlapped and len(times):
        state = engine.drain(state, inflight)
        drains += 1
    return RunResult(
        state=state,
        spikes_per_window=np.asarray(spikes, dtype=np.int64),
        window_times_s=np.asarray(times, dtype=np.float64),
        windows_done=len(times),
        overlapped=overlapped,
        drains=drains)
