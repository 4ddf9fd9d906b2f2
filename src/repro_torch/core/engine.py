"""Single-host engine: a thin assembly over the window core.

Port of ``repro.core.engine`` (the distributed assembly is
:mod:`repro_torch.core.dist_engine`). The engine advances the network in windows of
``D`` cycles (``D`` = delay ratio, paper eq. (1)); each cycle is the paper's
deliver -> update -> collocate sequence. The conventional and structure-aware
schedules produce bit-identical spike trains. :class:`EngineConfig` keeps the
JAX package's field names, defaults and rules, the distributed ones
included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import delivery as delivery_lib
from repro_torch.core import exchange as exchange_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import neuron as neuron_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.areas import MultiAreaSpec
from repro_torch.core.connectivity import Network
from repro_torch.core.schedule import CONVENTIONAL, STRUCTURE_AWARE, SimState
from repro_torch.kernels.lif_update import f32

__all__ = [
    "ConfigError",
    "ConfigViolation",
    "EngineConfig",
    "SimState",
    "Engine",
    "resolve_params",
    "make_fused_lif_update",
    "make_fused_superstep",
    "CONVENTIONAL",
    "STRUCTURE_AWARE",
]


@dataclasses.dataclass(frozen=True)
class ConfigViolation:
    """One broken EngineConfig rule: which field, what's wrong, how to fix."""

    field: str
    problem: str
    remedy: str

    def __str__(self) -> str:
        return f"{self.field}: {self.problem} [remedy: {self.remedy}]"


class ConfigError(ValueError):
    """All of a config's rule violations in one error (``.violations``)."""

    def __init__(self, violations):
        self.violations: tuple[ConfigViolation, ...] = tuple(violations)
        n = len(self.violations)
        lines = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(
            f"invalid EngineConfig ({n} rule"
            f"{'s' if n != 1 else ''} violated):\n{lines}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's engine config, field for field (see its docs)."""

    neuron_model: str = "lif"  # 'lif' | 'ignore_and_fire'
    schedule: str = STRUCTURE_AWARE  # 'conventional' | 'structure_aware'
    seed: int = 42
    lif: neuron_lib.LIFParams = dataclasses.field(
        default_factory=neuron_lib.LIFParams)
    # 'onehot' | 'scatter' | 'pallas' | 'event'; '' means 'onehot'.
    delivery_backend: str = ""
    exchange: str = ""
    shard_inter_tables: bool = True
    subgroup_inter_tables: bool = True
    # Run the update phase through the fused LIF kernel. None = exactly when
    # delivery_backend is 'pallas'.
    fused_update: bool | None = None
    s_max_headroom: float = 8.0
    s_max_floor: int = 16
    s_max_burst: int = 1
    adaptive_exchange: bool = False
    # Run the structure-aware window as one D-cycle superstep over the live
    # window buffer. None = on for structure_aware; False = the legacy
    # per-cycle window (the semantic reference).
    superstep: bool | None = None
    # Accepted for parity; in eager PyTorch the superstep is one Python loop
    # either way.
    superstep_unroll: bool = False
    # Run each structure-aware window (update + intra delivery of all D
    # cycles) as one fused superstep kernel call (kernels/cycle.py).
    superstep_kernel: bool = False
    overlap_exchange: bool = False
    sharded_build: bool = False
    # Host-side fault plan (repro_torch.core.faults.FaultConfig), read by
    # the windowed run loop (schedule.run_windows) only; None injects nothing.
    faults: faults_lib.FaultConfig | None = None

    def __post_init__(self) -> None:
        self.check()

    def validate(self, *, distributed: bool | None = None) -> list[ConfigViolation]:
        """Evaluate every config rule and return the full violation list."""
        v: list[ConfigViolation] = []
        if self.neuron_model not in ("lif", "ignore_and_fire"):
            v.append(ConfigViolation(
                "neuron_model", f"unknown neuron model {self.neuron_model!r}",
                "use 'lif' or 'ignore_and_fire'"))
        if self.schedule not in (CONVENTIONAL, STRUCTURE_AWARE):
            v.append(ConfigViolation(
                "schedule", f"unknown schedule {self.schedule!r}",
                f"use {CONVENTIONAL!r} or {STRUCTURE_AWARE!r}"))
        if self.delivery_backend not in ("",) + delivery_lib.BACKENDS:
            v.append(ConfigViolation(
                "delivery_backend",
                f"unknown delivery_backend {self.delivery_backend!r} "
                f"(expected one of {delivery_lib.BACKENDS})",
                "pick a listed backend, or '' for the default"))
        if self.exchange not in ("",) + exchange_lib.EXCHANGES:
            v.append(ConfigViolation(
                "exchange",
                f"unknown exchange {self.exchange!r} "
                f"(expected one of {exchange_lib.EXCHANGES})",
                "pick a listed exchange, or '' for the default"))
        if self.s_max_burst < 1:
            v.append(ConfigViolation(
                "s_max_burst",
                f"s_max_burst={self.s_max_burst} would shrink the "
                "whole-network event bound's burst slack below its floor",
                "use an integer >= 1 (B for a B-trial folded batch)"))
        if self.exchange == "routed" and self.schedule != STRUCTURE_AWARE:
            v.append(ConfigViolation(
                "exchange",
                "exchange='routed' routes the structure-aware window's "
                "lumped global pathway; the conventional schedule has none",
                "use schedule='structure_aware', or exchange='dense'"))
        if self.superstep is True and self.schedule != STRUCTURE_AWARE:
            v.append(ConfigViolation(
                "superstep",
                "superstep=True requires the structure-aware schedule; the "
                "conventional schedule exchanges every cycle and has no "
                "window to fuse",
                "use schedule='structure_aware', or superstep=None"))
        if self.superstep_kernel:
            if self.schedule != STRUCTURE_AWARE:
                v.append(ConfigViolation(
                    "superstep_kernel",
                    "superstep_kernel fuses the structure-aware window; the "
                    "conventional schedule has no window to fuse",
                    "use schedule='structure_aware'"))
            if self.superstep is False:
                v.append(ConfigViolation(
                    "superstep_kernel",
                    "superstep_kernel=True conflicts with superstep=False",
                    "drop one of the two flags"))
        if self.overlap_exchange and self.schedule != STRUCTURE_AWARE:
            v.append(ConfigViolation(
                "overlap_exchange",
                "overlap_exchange double-buffers the structure-aware "
                "window-end exchange; the conventional schedule has no "
                "lumped exchange to overlap",
                "use schedule='structure_aware', or drop overlap_exchange"))
        if self.sharded_build:
            if self.backend != "event":
                v.append(ConfigViolation(
                    "sharded_build",
                    "sharded_build generates the event path's inbound/"
                    "outgoing tables; dense backends read the global "
                    "incoming tensors it never materialises",
                    "use delivery_backend='event'"))
            if not self.shard_inter_tables:
                v.append(ConfigViolation(
                    "sharded_build",
                    "sharded_build emits per-shard inbound inter slices; "
                    "shard_inter_tables=False asks for the replicated "
                    "layout it exists to avoid",
                    "keep shard_inter_tables=True"))
            if self.schedule != STRUCTURE_AWARE:
                v.append(ConfigViolation(
                    "sharded_build",
                    "sharded_build targets the structure-aware placement "
                    "(area groups x subgroup lanes); the conventional "
                    "schedule slices a host-built network",
                    "use schedule='structure_aware'"))
        if distributed is False:
            if self.exchange not in ("", "local"):
                v.append(ConfigViolation(
                    "exchange",
                    f"exchange={self.exchange!r} needs a device mesh; the "
                    "single-host engine is exchange-free "
                    "(use make_dist_engine)",
                    "pass mesh=... to make_simulation, or use exchange=''"))
            if self.sharded_build:
                v.append(ConfigViolation(
                    "sharded_build",
                    "sharded_build is a distributed construction mode; the "
                    "single-host engine holds the whole network anyway "
                    "(use make_dist_engine)",
                    "pass mesh=... to make_simulation"))
        if distributed is True:
            if self.superstep_kernel:
                v.append(ConfigViolation(
                    "superstep_kernel",
                    "superstep_kernel is single-host only; the distributed "
                    "engine fuses the window at the jnp level "
                    "(use_superstep)",
                    "drop superstep_kernel (the jnp superstep fusion is "
                    "the distributed default)"))
        return v

    def check(self, *, distributed: bool | None = None) -> None:
        """Raise :class:`ConfigError` listing every violated rule, if any."""
        violations = self.validate(distributed=distributed)
        if violations:
            raise ConfigError(violations)

    @property
    def backend(self) -> str:
        """The resolved delivery backend ('' defaults to 'onehot')."""
        return self.delivery_backend or "onehot"

    @property
    def fused(self) -> bool:
        """Whether the update phase runs the fused LIF kernel."""
        if self.fused_update is None:
            return self.backend == "pallas"
        return self.fused_update

    @property
    def use_superstep(self) -> bool:
        """Whether the window runs as one D-cycle superstep."""
        if self.schedule != STRUCTURE_AWARE:
            return False
        return True if self.superstep is None else self.superstep


@dataclasses.dataclass(frozen=True)
class Engine:
    init: Callable[[], SimState]
    # Advance one window of D cycles; returns (state', spikes [D, A, n_pad] bool).
    window: Callable[[SimState], tuple[SimState, torch.Tensor]]
    # Advance n windows; returns (state', total spikes per window [n] int32).
    run: Callable[[SimState, int], tuple[SimState, torch.Tensor]]
    config: EngineConfig
    delay_ratio: int
    # The overlapped pipeline (overlap_exchange=True; None otherwise):
    # window_overlap(state, inflight) -> (state', inflight', block),
    # drain(state, inflight) -> state', init_inflight() -> empty inflight.
    window_overlap: Callable | None = None
    drain: Callable | None = None
    init_inflight: Callable | None = None
    # Static mesh-total wire bytes per window of the exchange (all zeros on
    # a single host).
    wire_bytes: dict | None = None
    # Distributed engines only (None on a single host): shard_state(global
    # state) -> this rank's block; gather_state(state) / gather_block(block)
    # -> the whole network's, on every rank; the process mesh.
    shard_state: Callable | None = None
    gather_state: Callable | None = None
    gather_block: Callable | None = None
    mesh: object = None


def make_fused_lif_update(params: neuron_lib.LIFParams):
    """An ``(state, i_in, alive) -> (state', spikes)`` closure over the fused
    LIF kernel, signature-compatible with :func:`neuron.lif_update`."""
    from repro_torch.kernels import ops as kops

    kw = dict(p11=params.p11, p21=params.p21, p22=params.p22,
              v_th=params.v_th_mv, v_reset=params.v_reset_mv,
              t_ref_steps=params.t_ref_steps)

    def update(state, i_in, alive):
        v, i_syn, refrac, spikes = kops.lif_update(
            state.v, state.i_syn, state.refrac, i_in, alive, **kw)
        return neuron_lib.LIFState(v=v, i_syn=i_syn, refrac=refrac), spikes

    return update


def resolve_params(net: Network, spec: MultiAreaSpec, cfg: EngineConfig):
    """``(lif_params, drive_rate)`` as the engine runs them: the dt-corrected
    LIF propagators and the per-neuron drive rate
    ``rate_hz * (ext_rate_hz / 2.5)``, the expression of
    :func:`schedule.make_update_fn`, so the fused superstep drives the same
    math bit for bit."""
    lif_params = cfg.lif
    if abs(lif_params.dt_ms - net.dt_ms) > 1e-12:
        lif_params = dataclasses.replace(lif_params, dt_ms=net.dt_ms)
    return lif_params, net.rate_hz * (spec.ext_rate_hz / 2.5)


def make_fused_superstep(
    net: Network,
    spec: MultiAreaSpec,
    cfg: EngineConfig,
    lif_params: neuron_lib.LIFParams,
    drive_rate: torch.Tensor,
    gids: torch.Tensor,
):
    """A ``(neuron_state, fut, t0) -> (state', spikes [D, A, n] bool, fut')``
    closure over the fused superstep kernels (:mod:`repro_torch.kernels.cycle`).

    One call advances all D cycles of a window and the window's intra
    deposits into the live buffer ``fut`` (in place), bitwise equal to the
    unfused window: the same LIF propagators, the same counter-based drive,
    1/256-grid deposits.
    """
    from repro_torch.kernels import ops as kops

    D = net.delay_ratio
    steps_lo = net.steps_lo_intra
    r_span = net.r_span_intra if net.k_intra > 0 else 0
    tables = (net.src_intra, net.w_intra, net.delay_intra)

    if cfg.neuron_model == "lif":
        p = lif_params
        drive_p = drive_rate * f32(net.dt_ms * 1e-3)
        kw = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
                  v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps,
                  seed=cfg.seed, w_ext=spec.w_ext)

        def run_lif(neuron_state, fut, t0):
            v, i_syn, refrac, fut, spikes = kops.superstep_lif(
                neuron_state.v, neuron_state.i_syn, neuron_state.refrac, fut,
                drive_p, gids, net.alive, *tables, t0,
                d_win=D, steps_lo=steps_lo, r_span=r_span, **kw)
            return neuron_lib.LIFState(v=v, i_syn=i_syn, refrac=refrac), spikes, fut

        return run_lif

    # ignore_and_fire: the same static interval/phase rule as the unfused update.
    interval = neuron_lib.iaf_interval(net.rate_hz, net.dt_ms)

    def run_iaf(neuron_state, fut, t0):
        del t0  # emission is input- and time-base-independent
        cd, fut, spikes = kops.superstep_iaf(
            neuron_state.countdown, fut, interval, net.alive, *tables,
            d_win=D, steps_lo=steps_lo, r_span=r_span)
        return neuron_lib.IafState(countdown=cd), spikes, fut

    return run_iaf


def _per_neuron(x, dtype, shape, dev) -> torch.Tensor:
    """``x`` (a scalar or array) broadcast to a ``shape`` tensor; a seed
    keeps its uint32 value, as the JAX engine casts it."""
    if dtype == torch.int64:
        x = np.asarray(x).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(x, dtype=dtype).to(dev).expand(shape).contiguous()


def _make_engine(
    net: Network,
    spec: MultiAreaSpec,
    config: EngineConfig = EngineConfig(),
    *,
    gids: torch.Tensor | None = None,
) -> Engine:
    """Build the single-host engine for ``net``, on ``net``'s device.

    ``gids`` overrides the global-id table fed to the counter-based drive and
    the iaf phase rule (default ``arange(A * n_pad)``).
    """
    cfg = config
    cfg.check(distributed=False)
    if cfg.backend == "event" and net.tgt_intra is None:
        raise ValueError("event delivery needs build_network(outgoing=True)")
    A, n_pad = net.alive.shape
    dev = net.device
    lif_params, drive_rate = resolve_params(net, spec, cfg)
    fused_lif = make_fused_lif_update(lif_params) if cfg.fused else None
    if gids is None:
        gids = torch.arange(A * n_pad, dtype=torch.int32, device=dev).view(A, n_pad)

    exchange = exchange_lib.LocalExchange(net, cfg)
    update_fn = schedule_lib.make_update_fn(cfg, spec, net.dt_ms, lif_params, fused_lif)
    fused_window = (
        make_fused_superstep(net, spec, cfg, lif_params, drive_rate, gids)
        if cfg.superstep_kernel else None)
    window_body = schedule_lib.make_window_fn(
        cfg, exchange, update_fn, fused_superstep=fused_window)

    overlap = drain = init_inflight = None
    if cfg.overlap_exchange:
        overlap_body, drain_body = schedule_lib.make_overlap_window_fn(
            cfg, exchange, update_fn, fused_superstep=fused_window)

        def overlap(state: SimState, inflight):
            return overlap_body(state, inflight, net, gids)

        def drain(state: SimState, inflight) -> SimState:
            return drain_body(state, inflight, net, gids)

        def init_inflight():
            return exchange.init_inflight(net)

        # The compatibility `window`: one overlapped window drained on the
        # spot, bitwise the sequential window.
        def window(state: SimState) -> tuple[SimState, torch.Tensor]:
            st, inflight, block = overlap(state, init_inflight())
            return drain(st, inflight), block
    else:
        def window(state: SimState) -> tuple[SimState, torch.Tensor]:
            return window_body(state, net, gids)

    def init(seed=None, stim=None) -> SimState:
        """A fresh state; ``seed`` / ``stim`` (scalars broadcast) become the
        per-neuron drive seed and stimulus scale leaves, as in the JAX
        engine: LIF only, and not under ``superstep_kernel``."""
        if seed is not None or stim is not None:
            schedule_lib.check_seed_stim(cfg)
        if cfg.neuron_model == "lif":
            nstate = neuron_lib.lif_init((A, n_pad), dev)
        else:
            nstate = neuron_lib.ignore_and_fire_init(
                net.alive, net.rate_hz, net.dt_ms, gids)
        return SimState(
            neuron=nstate,
            ring=torch.zeros((A, n_pad, net.ring_len), dtype=torch.float32, device=dev),
            t=0,
            spike_count=torch.zeros((A, n_pad), dtype=torch.int32, device=dev),
            seed=None if seed is None else _per_neuron(seed, torch.int64, (A, n_pad), dev),
            stim=None if stim is None else _per_neuron(stim, torch.float32, (A, n_pad), dev),
        )

    def run(state: SimState, n_windows: int):
        """n windows; the overlapped pipeline carries its in-flight window
        from one to the next and drains it once at the end."""
        totals = []
        inflight = init_inflight() if overlap is not None else None
        for _ in range(n_windows):
            if overlap is not None:
                state, inflight, block = overlap(state, inflight)
            else:
                state, block = window_body(state, net, gids)
            totals.append(block.sum(dtype=torch.int32))
        if overlap is not None:
            state = drain(state, inflight)
        return state, (torch.stack(totals) if totals
                       else torch.zeros(0, dtype=torch.int32, device=dev))

    return Engine(init=init, window=window, run=run, config=cfg,
                  delay_ratio=net.delay_ratio, window_overlap=overlap,
                  drain=drain, init_inflight=init_inflight,
                  wire_bytes=exchange.wire_bytes(net))
