"""End-to-end wall-clock cost model (reproduces Figs. 1b, 4, 7a, 8, 9).

The port's own copy of ``repro.core.cost_model`` (pure numpy over
:mod:`repro_torch.core.sync_model` and :mod:`repro_torch.core.delivery_model`),
function for function. The paper's scaling figures come from 16-128 nodes of
a cluster, so they are reproduced through a calibrated performance model --
the kind of semi-empirical model the paper calls for in its Discussion ("it
is time for ... more advanced performance modeling"). The model composes:

  per-cycle, per-process compute time
      t_cycle = t_deliver + t_update + t_collocate           (paper eq. 18)
  + a collective-communication model  t_coll = alpha(M) + bytes/beta   (Fig. 4)
  + the order-statistics synchronization model of §2.2 (sync_model)
  + the cache model of §2.3 (delivery_model) feeding t_deliver.

Calibration constants are fitted to the published SuperMUC-NG numbers (RTF
9.4 -> 22.7 conventional and 8.5 -> 15.7 structure-aware across M = 16..128,
Fig. 7a) and are documented inline. The machines are the paper's; no GPU
constants are fitted.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import delivery_model, sync_model

__all__ = [
    "CollectiveModel",
    "SUPERMUC_MPI",
    "JURECA_MPI",
    "MachineModel",
    "SUPERMUC",
    "JURECA",
    "WorkloadModel",
    "PhaseBreakdown",
    "receive_time_s",
    "exchange_time_s",
    "simulate_rtf",
]


@dataclasses.dataclass(frozen=True)
class CollectiveModel:
    """t(one collective call) = alpha(M) + total_bytes / beta.

    ``alpha`` captures per-call dispatch/latency (and its growth with
    participant count -- OpenMPI algorithm switches appear as jumps, Fig. 4);
    ``beta`` is the effective aggregate bandwidth.
    """

    alpha_us_by_log2m: tuple[float, ...]  # alpha for M = 2^i
    beta_gbps: float

    def alpha_us(self, m: int) -> float:
        i = min(max(int(round(math.log2(max(m, 1)))), 0),
                len(self.alpha_us_by_log2m) - 1)
        return self.alpha_us_by_log2m[i]

    def call_time_s(self, m: int, total_bytes: float) -> float:
        return self.alpha_us(m) * 1e-6 + total_bytes / (self.beta_gbps * 1e9)


# Calibrated to Fig. 4 (MPI_Alltoall on SuperMUC-NG, OpenMPI): latency-
# dominated at the paper's spike-buffer sizes; jumps at 64/128 ranks.
SUPERMUC_MPI = CollectiveModel(
    alpha_us_by_log2m=(5, 8, 12, 18, 26, 40, 65, 120),  # M=1..128
    beta_gbps=10.0,
)
# JURECA-DC: InfiniBand HDR100, slightly lower latency, higher bandwidth.
JURECA_MPI = CollectiveModel(
    alpha_us_by_log2m=(4, 6, 9, 14, 20, 32, 50, 90),
    beta_gbps=12.5,
)


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Per-node compute constants + the interconnect model."""

    name: str
    t_m: int                   # hardware threads per node (T_M)
    c_update_ns: float         # neuron state update, per neuron (LIF)
    c_update_iaf_ns: float     # ignore-and-fire update, per neuron
    c_syn_seq_ns: float        # delivery, per synapse, sequential (cached)
    c_syn_irr_ns: float        # delivery, per synapse, irregular (first touch)
    c_collocate_ns: float      # per emitted spike
    mpi: CollectiveModel = SUPERMUC_MPI
    # Relative per-process jitter of cycle times (body of Fig. 7b, CV ~ 0.04
    # after removing systematic process offsets) + serial correlation.
    cycle_cv: float = 0.028
    ar1_rho: float = 0.6
    minor_mode_weight: float = 0.02
    minor_mode_rel_shift: float = 0.185
    minor_mode_dwell: float = 5.0


# Calibration notes (SuperMUC-NG, T_M = 48): constants are *per-thread*
# nanoseconds; update and deliver parallelise over the T_M OpenMP threads,
# collocate runs on the master thread only (paper §2.4.3). With N_M = 130k,
# K_N = 6000, rate 2.5 Hz, dt 0.1 ms this puts the mean conventional cycle
# time at ~1.6 ms for M = 128 (Fig. 7b: 1.62 ms) with update ~ 0.5 ms and
# deliver ~ 1.0 ms, and reproduces RTF 9.4 -> 22.7 (conv) / 8.5 -> 15.7
# (struct) across M = 16..128 (Fig. 7a) to within ~15 %.
SUPERMUC = MachineModel(
    name="SuperMUC-NG",
    t_m=48,
    c_update_ns=300.0,
    c_update_iaf_ns=190.0,
    c_syn_seq_ns=55.0,
    c_syn_irr_ns=370.0,
    c_collocate_ns=900.0,
    mpi=SUPERMUC_MPI,
)
JURECA = MachineModel(
    name="JURECA-DC",
    t_m=128,
    c_update_ns=260.0,
    c_update_iaf_ns=170.0,
    c_syn_seq_ns=50.0,
    c_syn_irr_ns=330.0,
    c_collocate_ns=900.0,
    mpi=JURECA_MPI,
    # More cores absorb imbalance better (paper §2.4.3: V2's +68% spikes cost
    # +24% cycle time on SuperMUC-NG but only +7% on JURECA-DC).
    cycle_cv=0.022,
)


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Per-process workload of a multi-area simulation (weak-scaling cell)."""

    n_m: int = 130_000        # neurons per process (mean area size)
    k_n: int = 6000           # synapses per neuron
    k_intra_frac: float = 0.5
    rate_hz: float = 2.5
    dt_ms: float = 0.1
    d: int = 10               # delay ratio D
    neuron_model: str = "iaf"  # 'iaf' (MAM-benchmark) or 'lif' (MAM)
    area_size_cv: float = 0.0  # Fig. 8a heterogeneity
    rate_cv: float = 0.0       # Fig. 8b heterogeneity
    bytes_per_spike: float = 4.0

    def spikes_per_proc_cycle(self) -> float:
        return self.n_m * self.rate_hz * self.dt_ms * 1e-3


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Real-time factors per phase (wall time / model time), Fig. 7a style."""

    update: float
    deliver: float
    collocate: float
    communicate: float  # pure data exchange
    synchronize: float

    @property
    def total(self) -> float:
        return (self.update + self.deliver + self.collocate
                + self.communicate + self.synchronize)

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self) | {"total": self.total}


def _phase_means(
    wl: WorkloadModel, hw: MachineModel, m: int, schedule: str
) -> tuple[float, float, float]:
    """Expected per-cycle (update, deliver, collocate) seconds per process."""
    c_upd = hw.c_update_iaf_ns if wl.neuron_model == "iaf" else hw.c_update_ns
    # Update parallelises over the T_M threads.
    t_update = wl.n_m * c_upd * 1e-9 / hw.t_m

    # Delivery: per process and cycle, the emitted spikes network-wide fan out
    # to K_N synapses each; 1/M of those synapse events land locally, i.e.
    # exactly spikes_per_proc_cycle * K_N events. The per-event cost blends
    # sequential and irregular access with the §2.3 fractions; threads share
    # the work.
    n = wl.n_m * m
    syn_events = wl.spikes_per_proc_cycle() * wl.k_n
    if schedule == "conventional":
        f_irr = delivery_model.f_irr_conventional(n, wl.k_n, m, hw.t_m)
    else:
        f_irr = delivery_model.f_irr_structure_aware(
            n, wl.k_n, m, hw.t_m,
            k_intra=wl.k_n * wl.k_intra_frac,
            k_inter=wl.k_n * (1 - wl.k_intra_frac),
        )
    per_syn = (f_irr * hw.c_syn_irr_ns + (1 - f_irr) * hw.c_syn_seq_ns) * 1e-9
    t_deliver = syn_events * per_syn / hw.t_m

    # Collocation runs on the master thread only (paper §2.4.3).
    t_collocate = wl.spikes_per_proc_cycle() * hw.c_collocate_ns * 1e-9
    return t_update, t_deliver, t_collocate


def receive_time_s(syn_touches: float, hw: MachineModel) -> float:
    """Receive-side scatter seconds for ``syn_touches`` synapse-table
    touches (per device, per window).

    The event receive path's work is ids_scattered x receive-table width --
    the counter :func:`repro_torch.core.exchange.inter_table_report` reports for
    the replicated vs sharded table layouts (the sharded layout divides the
    width by ~the shard count, the NEST every-rank-scans-everything fix of
    arXiv:2109.11358). Each touch is one sequential table read + ring
    accumulate, priced at the cache-model's sequential per-synapse cost and
    parallelised over the ``T_M`` threads -- the same constants the deliver
    phase of :func:`simulate_rtf` uses, so before/after receive times are
    comparable with the phase breakdowns.
    """
    return syn_touches * hw.c_syn_seq_ns * 1e-9 / hw.t_m


def exchange_time_s(
    counts_bytes: float,
    payload_bytes: float,
    m: int,
    mpi: CollectiveModel = SUPERMUC_MPI,
) -> float:
    """Wall seconds of one adaptive two-phase exchange.

    Two dependent collective calls: phase 1 moves the tiny count packet
    (latency-dominated -- ``alpha(M)`` plus a few int32 words), phase 2 the
    right-sized payload. The two phases cannot overlap (the payload size is
    a function of the counts), so the times add: the adaptive exchange buys
    its byte savings at the price of one extra ``alpha(M)`` dispatch per
    window -- worth it exactly when ``saved_bytes / beta > alpha(M)``,
    which at brain-scale static bounds (8x-expectation headroom) it is (cf.
    Du et al. 2022: count-first exchanges amortize at scale). Byte inputs
    come from ``exchange.adaptive_wire_bytes`` (modelled) or
    ``SimState.shipped_bytes`` (measured); pass ``counts_bytes=0`` to price
    the static single-phase exchange with the same constants.
    """
    t = mpi.call_time_s(m, payload_bytes)
    if counts_bytes > 0:
        t += mpi.call_time_s(m, counts_bytes)
    return t


def simulate_rtf(
    wl: WorkloadModel,
    hw: MachineModel,
    m: int,
    schedule: str,
    *,
    t_model_s: float = 1.0,
    seed: int = 0,
    bytes_per_window: float | None = None,
) -> PhaseBreakdown:
    """Monte-Carlo the full schedule and return per-phase real-time factors.

    Mirrors the paper's instrumentation: per-phase times are averaged over
    processes; synchronization is the mean waiting time at the barrier before
    the collective; communicate is the pure data exchange (Fig. 1b).

    ``bytes_per_window`` overrides the analytic spike-buffer estimate with a
    measured mesh-total wire volume -- the static counters the exchange
    layer reports (``repro_torch.core.exchange``, ``Engine.wire_bytes``), so the
    model can price the dense vs connectivity-routed global pathway from
    the same numbers the engines ship.
    """
    rng = np.random.default_rng(seed)
    s = int(round(t_model_s / (wl.dt_ms * 1e-3)))
    d = wl.d if schedule == "structure_aware" else 1
    s -= s % max(wl.d, 1)

    t_upd, t_dlv, t_col = _phase_means(wl, hw, m, schedule)
    mu = t_upd + t_dlv + t_col

    # Systematic per-process offsets from heterogeneity: area size scales all
    # compute phases; rate scales delivery/collocation only.
    size_f = np.maximum(1 + wl.area_size_cv * rng.standard_normal(m), 0.1)
    rate_f = np.maximum(1 + wl.rate_cv * rng.standard_normal(m), 0.1)
    proc_mu = t_upd * size_f + t_dlv * size_f * rate_f + t_col * rate_f

    model = sync_model.CycleTimeModel(
        mu=1.0,  # placeholder; we inject proc_mu directly below
        sigma=hw.cycle_cv,
        rho=hw.ar1_rho,
        minor_mode_shift=hw.minor_mode_rel_shift,
        minor_mode_weight=hw.minor_mode_weight,
        minor_mode_dwell=hw.minor_mode_dwell,
    )
    # Relative jitter matrix around 1.0 (shared across schedules comparisons
    # when the same seed is used -- common random numbers).
    jitter = model.sample(m, s, rng) / 1.0
    cycle_t = proc_mu[:, None] * jitter  # [M, S]

    # Lump into communication windows of length d.
    lumped = cycle_t.reshape(m, s // d, d).sum(axis=2)  # [M, S/d]
    wall_compute_wait = lumped.max(axis=0).sum()
    mean_compute = cycle_t.sum(axis=1).mean()
    t_sync = wall_compute_wait - mean_compute

    # Data exchange: spikes from d cycles, all processes' buffers -- unless
    # the caller supplies the exchange layer's measured wire volume.
    if bytes_per_window is None:
        spikes_per_window = wl.spikes_per_proc_cycle() * d
        bytes_per_window = spikes_per_window * wl.bytes_per_spike * m
    n_windows = s // d
    t_comm = n_windows * hw.mpi.call_time_s(m, bytes_per_window)
    # The structure-aware local exchange is a buffer swap -- negligible, but
    # modelled as one dispatch per cycle on the local tier.
    if schedule == "structure_aware":
        t_comm += (s - n_windows) * 0.2e-6

    return PhaseBreakdown(
        update=float(t_upd * s / t_model_s) * float(np.mean(size_f)),
        deliver=float(t_dlv * s / t_model_s) * float(np.mean(size_f * rate_f)),
        collocate=float(t_col * s / t_model_s),
        communicate=float(t_comm / t_model_s),
        synchronize=float(t_sync / t_model_s),
    )
