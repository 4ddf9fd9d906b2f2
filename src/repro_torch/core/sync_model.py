"""§2.2 -- statistical model of synchronization time (order statistics).

The port's own copy of ``repro.core.sync_model`` (pure numpy; the port
imports nothing of the JAX package), function for function.

The paper models per-process, per-cycle compute times as t ~ N(mu, sigma^2).
With blocking collectives, every cycle costs the *maximum* over the M
processes (eq. 3); lumping D cycles between synchronizations (eq. 4-5) turns
the per-sync distribution into N(D mu, D sigma^2) (eq. 6, CLT), cutting the
coefficient of variation by 1/sqrt(D) (eq. 7) and the expected total
synchronization time by the same factor (eq. 11).

This module provides:
  * the analytic pieces (Blom's E[max] approximation, eq. 8-12),
  * a Monte-Carlo simulator that *also* models what the paper measures but
    the CLT argument ignores -- AR(1) serial correlation of per-process cycle
    times and the bimodal cycle-time distribution (Fig. 7b / Fig. 12) -- which
    reproduces the measured CV-ratio gap (0.71 observed vs 0.32 predicted).

No scipy available: Phi and Phi^{-1} are implemented via math.erf and
Acklam's rational approximation (|rel err| < 1.15e-9).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "norm_cdf",
    "norm_pdf",
    "norm_ppf",
    "blom_xi",
    "expected_wall_conventional",
    "expected_wall_structure_aware",
    "expected_max_normals",
    "expected_wall_overlapped",
    "sync_time_ratio",
    "max_tail_probability",
    "tail_for_max_coverage",
    "CycleTimeModel",
    "simulate_schedules",
    "ScheduleSample",
]


def norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def norm_pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


# Acklam's inverse normal CDF coefficients.
_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)


def norm_ppf(p: float) -> float:
    """Inverse standard normal CDF (Acklam's approximation)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0,1), got {p}")
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4]) * q + _C[5]) / \
               ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1)
    if p > p_high:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4]) * q + _C[5]) / \
                ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4]) * r + _A[5]) * q / \
           (((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r + _B[4]) * r + 1)


def blom_xi(m: int, alpha: float = 0.375) -> float:
    """Blom (1958): E[max of m iid N(0,1)] ~= Phi^{-1}((m - alpha)/(m - 2 alpha + 1)).

    This is the xi_M factor of paper eqs. (8)-(9): how many standard
    deviations above the mean the expected per-cycle maximum sits.
    """
    if m < 1:
        raise ValueError("m >= 1 required")
    if m == 1:
        return 0.0
    return norm_ppf((m - alpha) / (m - 2 * alpha + 1))


def expected_wall_conventional(s: int, m: int, mu: float, sigma: float) -> float:
    """Paper eq. (8): E[T_wall^conv] = S mu + S xi_M sigma."""
    return s * mu + s * blom_xi(m) * sigma


def expected_wall_structure_aware(
    s: int, d: int, m: int, mu: float, sigma: float
) -> float:
    """Paper eq. (9): E[T_wall^struc] = S mu + (S/sqrt(D)) xi_M sigma."""
    if s % d != 0:
        raise ValueError("S must be a multiple of D")
    return s * mu + (s / math.sqrt(d)) * blom_xi(m) * sigma


def sync_time_ratio(d: int) -> float:
    """Paper eq. (11): E[T_sync^struc] / E[T_sync^conv] = 1/sqrt(D)."""
    return 1.0 / math.sqrt(d)


def expected_max_normals(
    mu1: float, sigma1: float, mu2: float, sigma2: float
) -> float:
    """Clark (1961): E[max(X1, X2)] for independent normals.

    With theta = sqrt(sigma1^2 + sigma2^2) and delta = (mu1 - mu2)/theta:
    ``E[max] = mu1 Phi(delta) + mu2 Phi(-delta) + theta phi(delta)``.
    This is the analytic heart of the overlapped-schedule claim: when the
    window-end exchange of window ``w`` runs concurrently with the compute
    of ``w+1``, the per-window wall is governed by the *maximum* of the two
    straggler times, not their sum -- the correction term ``theta phi``
    vanishes as the means separate, so a pipeline dominated by either phase
    costs exactly that phase.
    """
    theta = math.hypot(sigma1, sigma2)
    if theta == 0.0:
        return max(mu1, mu2)
    delta = (mu1 - mu2) / theta
    return (mu1 * norm_cdf(delta) + mu2 * norm_cdf(-delta)
            + theta * norm_pdf(delta))


def expected_wall_overlapped(
    n_windows: int,
    compute_window_s: float,
    compute_spread_s: float,
    comm_window_s: float,
    comm_spread_s: float,
) -> float:
    """Expected pipelined wall over ``n_windows``: the steady-state window
    costs E[max(compute, comm)] (the exchange of window ``w`` hides behind
    the compute of ``w+1``), plus the pipeline's fill/drain edges -- the
    first window has no in-flight exchange to hide and the last exchange has
    no compute left to hide behind. The sequential reference over the same
    windows is ``n_windows * (compute + comm)``."""
    if n_windows < 1:
        raise ValueError("n_windows >= 1 required")
    steady = expected_max_normals(
        compute_window_s, compute_spread_s, comm_window_s, comm_spread_s)
    return compute_window_s + (n_windows - 1) * steady + comm_window_s


def max_tail_probability(p_tail: float, m: int) -> float:
    """Paper eq. (12): P(max falls in a tail of per-process probability p)."""
    return 1.0 - (1.0 - p_tail) ** m


def tail_for_max_coverage(coverage: float, m: int) -> float:
    """Invert eq. (12): the per-process tail probability whose maxima cover
    ``coverage`` of the per-cycle maxima distribution (e.g. 0.99 -> 3.5% for
    M=128, the number quoted in §2.2)."""
    return 1.0 - (1.0 - coverage) ** (1.0 / m)


@dataclasses.dataclass(frozen=True)
class CycleTimeModel:
    """Generative model of per-process cycle times.

    ``mu``/``sigma``: body of the distribution. ``rho``: AR(1) serial
    correlation of each process's successive cycle times. ``minor_mode_*``:
    bimodal mixture (Fig. 7b: major mode ~1.62 ms, minor ~1.90 ms) modelled as
    a *sticky* two-state Markov chain with mean dwell ``minor_mode_dwell``
    cycles -- Fig. 12 shows elevated phases persisting over thousands of
    cycles, which is precisely what breaks the CLT independence assumption and
    caps the realised synchronization gain (§2.4.1). ``process_spread``:
    per-process *systematic* mean offsets (heterogeneous areas -> slow/fast
    processes; drives Fig. 8a/9).
    """

    mu: float = 1.62e-3
    sigma: float = 0.05e-3
    rho: float = 0.0
    minor_mode_shift: float = 0.0
    minor_mode_weight: float = 0.0
    minor_mode_dwell: float = 500.0
    process_spread: float = 0.0

    def sample(self, m: int, s: int, rng: np.random.Generator) -> np.ndarray:
        """[M, S] per-process cycle times."""
        proc_mu = self.mu + self.process_spread * rng.standard_normal(m)
        if self.rho > 0:
            # AR(1) with stationary variance sigma^2.
            eps = rng.standard_normal((m, s)) * self.sigma * math.sqrt(1 - self.rho**2)
            x = np.empty((m, s))
            x[:, 0] = rng.standard_normal(m) * self.sigma
            for t in range(1, s):
                x[:, t] = self.rho * x[:, t - 1] + eps[:, t]
            noise = x
        else:
            noise = rng.standard_normal((m, s)) * self.sigma
        t = proc_mu[:, None] + noise
        if self.minor_mode_weight > 0 and self.minor_mode_shift != 0:
            w, dwell = self.minor_mode_weight, max(self.minor_mode_dwell, 1.0)
            p_exit = 1.0 / dwell
            p_enter = w * p_exit / max(1.0 - w, 1e-9)
            state = rng.random(m) < w  # stationary start
            hits = np.empty((m, s), dtype=bool)
            u = rng.random((m, s))
            for step in range(s):
                state = np.where(
                    state, u[:, step] >= p_exit, u[:, step] < p_enter
                )
                hits[:, step] = state
            t = t + hits * self.minor_mode_shift
        return np.maximum(t, 0.0)


@dataclasses.dataclass(frozen=True)
class ScheduleSample:
    """Monte-Carlo outcome for one schedule."""

    wall: float          # total compute+wait time (excl. data exchange)
    compute: float       # mean over processes of their own compute time
    sync: float          # wall - compute: the synchronization overhead
    cv_lumped: float     # CV of the (lumped) cycle-time distribution
    n_syncs: int


def simulate_schedules(
    model: CycleTimeModel,
    m: int,
    s: int,
    d: int,
    seed: int = 0,
) -> tuple[ScheduleSample, ScheduleSample]:
    """Simulate conventional vs structure-aware totals on one cycle-time draw.

    Uses a *common random numbers* design: both schedules see the same [M, S]
    cycle-time matrix, exactly like the paper's pairing of benchmark runs.
    Returns (conventional, structure_aware).
    """
    if s % d != 0:
        raise ValueError("S must be a multiple of D")
    rng = np.random.default_rng(seed)
    t = model.sample(m, s, rng)  # [M, S]

    compute = float(t.mean(axis=1).sum())  # == mean process compute * S
    mean_compute = float(t.sum(axis=1).mean())

    # Conventional: synchronize after every cycle (eq. 3).
    wall_conv = float(t.max(axis=0).sum())
    conv = ScheduleSample(
        wall=wall_conv,
        compute=mean_compute,
        sync=wall_conv - mean_compute,
        cv_lumped=float(t.std() / t.mean()),
        n_syncs=s,
    )

    # Structure-aware: lump D cycles (eq. 4-5).
    lumped = t.reshape(m, s // d, d).sum(axis=2)  # [M, S/D]
    wall_struc = float(lumped.max(axis=0).sum())
    struc = ScheduleSample(
        wall=wall_struc,
        compute=mean_compute,
        sync=wall_struc - mean_compute,
        cv_lumped=float(lumped.std() / lumped.mean()),
        n_syncs=s // d,
    )
    del compute
    return conv, struc
