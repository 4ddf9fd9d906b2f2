"""Multi-area network specifications (numpy; a copy of ``repro.core.areas``).

The paper studies two models:

* **MAM** -- the multi-area model of macaque visual cortex (Schmidt et al. 2018):
  32 areas, heterogeneous sizes (CV ~= 0.2 around a mean of ~130k neurons),
  ~6000 synapses per neuron of which ~1800 are long-range (inter-area),
  integrate-and-fire dynamics, ground state at ~2.5 spikes/s.

* **MAM-benchmark** -- a deliberately homogeneous variant: equal area sizes,
  equal intra/inter in-degrees (K_intra = K_inter ~= 3000), *ignore-and-fire*
  neurons that spike at a fixed interval/phase independent of input, so the
  workload is constant under scaling.

Both are described here by :class:`MultiAreaSpec`, which carries everything the
network construction, the engines, the partitioner and the analytic models need.
All delays are expressed on the simulation grid ``dt_ms`` (= the overall minimum
delay ``d_min`` of the paper). The delay ratio ``D = d_min_inter / d_min``
(paper eq. (1)) controls the structure-aware communication interval.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "AreaSpec",
    "MultiAreaSpec",
    "mam_benchmark_spec",
    "mam_spec",
    "ring_area_adjacency",
    "MAM_AREA_NAMES",
]


# The 32 vision-related areas of macaque cortex used by the MAM
# (Schmidt, Bakker, Hilgetag, Diesmann & van Albada 2018).
MAM_AREA_NAMES: tuple[str, ...] = (
    "V1", "V2", "VP", "V3", "V3A", "MT", "V4t", "V4", "VOT", "MSTd",
    "PIP", "PO", "DP", "MIP", "MDP", "VIP", "LIP", "PITv", "PITd", "MSTl",
    "CITv", "CITd", "FEF", "TF", "AITv", "FST", "7a", "STPp", "STPa", "46",
    "AITd", "TH",
)


@dataclasses.dataclass(frozen=True)
class AreaSpec:
    """One cortical area.

    Attributes:
      name: area label (e.g. ``"V1"``).
      n_neurons: number of (live) neurons in the area.
      rate_hz: target/drive spike rate for the area's neurons. For the
        ignore-and-fire model this is the exact emission rate; for the LIF
        model it parameterises the external Poisson drive.
    """

    name: str
    n_neurons: int
    rate_hz: float = 2.5

    def __post_init__(self) -> None:
        if self.n_neurons <= 0:
            raise ValueError(f"area {self.name!r}: n_neurons must be > 0")
        if self.rate_hz < 0:
            raise ValueError(f"area {self.name!r}: rate_hz must be >= 0")


@dataclasses.dataclass(frozen=True)
class MultiAreaSpec:
    """Full multi-area network specification.

    Delay conventions (paper §2.1): the simulation step is ``dt_ms`` which
    equals the overall minimum delay ``d_min``. Intra-area delays live on
    ``[dt_ms, delay_intra_max_ms]``; inter-area delays are cut off below at
    ``d_min_inter_ms`` (the paper imposes the same cutoff on the MAM) and live
    on ``[d_min_inter_ms, delay_inter_max_ms]``. ``D`` is the integer ratio
    ``d_min_inter / d_min`` of eq. (1).
    """

    areas: tuple[AreaSpec, ...]
    # -- temporal structure -------------------------------------------------
    dt_ms: float = 0.1
    d_min_inter_ms: float = 1.0
    delay_intra_mean_ms: float = 1.25
    delay_intra_std_ms: float = 0.625
    delay_inter_mean_ms: float = 5.0
    delay_inter_std_ms: float = 2.5
    delay_intra_max_ms: float = 3.0
    delay_inter_max_ms: float = 10.0
    # -- connectivity -------------------------------------------------------
    k_intra: int = 3000
    k_inter: int = 3000
    # Optional area->area adjacency mask: ``area_adjacency[src][tgt]`` truthy
    # iff source area ``src`` is allowed to project into target area ``tgt``.
    # ``None`` means all-to-all (every other area), the MAM default. A sparse
    # mask restricts the inter-area source draws in ``build_network`` -- the
    # connectivity-routed global pathway (``core/exchange.RoutedExchange``)
    # then ships spike packets only along edges that exist. Stored as nested
    # tuples so the spec stays hashable/frozen; see
    # :func:`ring_area_adjacency` for a canonical sparse example.
    area_adjacency: tuple[tuple[int, ...], ...] | None = None
    exc_fraction: float = 0.8
    # Weights are drawn on a 1/256 grid (exactly representable in f32) so that
    # ring-buffer accumulation is associative-exact and the conventional and
    # structure-aware schedules produce bit-identical spike trains. Units: pA
    # current impulses into an iaf_psc_exp with C_m = 250 pF (NEST defaults);
    # w_exc ~= 88 pA is the canonical 0.15 mV PSP.
    w_exc: float = 88.0
    g: float = 4.0  # inhibition dominance: w_inh = -g * w_exc
    # -- external drive (LIF only) -------------------------------------------
    ext_rate_hz: float = 2000.0  # rate of the external Poisson drive per neuron
    # Calibrated so the ground state sits at ~2.5 spikes/s (fluctuation-driven
    # regime just below threshold), matching the MAM ground state.
    w_ext: float = 282.0

    def __post_init__(self) -> None:
        if not self.areas:
            raise ValueError("MultiAreaSpec needs at least one area")
        if self.dt_ms <= 0:
            raise ValueError("dt_ms must be > 0")
        ratio = self.d_min_inter_ms / self.dt_ms
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(
                "d_min_inter_ms must be an integer multiple of dt_ms "
                f"(got ratio {ratio})"
            )
        if round(ratio) < 1:
            raise ValueError("d_min_inter_ms must be >= dt_ms")
        if self.delay_inter_max_ms < self.d_min_inter_ms:
            raise ValueError("delay_inter_max_ms must be >= d_min_inter_ms")
        if self.delay_intra_max_ms < self.dt_ms:
            raise ValueError("delay_intra_max_ms must be >= dt_ms")
        if self.k_intra < 0 or self.k_inter < 0:
            raise ValueError("in-degrees must be >= 0")
        if len(self.areas) == 1 and self.k_inter > 0:
            raise ValueError("single-area network cannot have inter-area synapses")
        if self.area_adjacency is not None:
            a = len(self.areas)
            adj = np.asarray(self.area_adjacency, dtype=bool)
            if adj.shape != (a, a):
                raise ValueError(
                    f"area_adjacency must be [{a}, {a}], got {adj.shape}"
                )
            if self.k_inter > 0:
                valid = adj & ~np.eye(a, dtype=bool)
                if not valid.any(axis=0).all():
                    raise ValueError(
                        "area_adjacency must give every target area at least "
                        "one non-self source area when k_inter > 0"
                    )

    # -- derived quantities ---------------------------------------------------

    @property
    def n_areas(self) -> int:
        return len(self.areas)

    @property
    def delay_ratio(self) -> int:
        """``D`` of paper eq. (1): d_min_inter / d_min."""
        return int(round(self.d_min_inter_ms / self.dt_ms))

    @property
    def n_total(self) -> int:
        """Total number of live neurons."""
        return sum(a.n_neurons for a in self.areas)

    @property
    def n_max_area(self) -> int:
        """Largest area size (before padding)."""
        return max(a.n_neurons for a in self.areas)

    def padded_area_size(self, multiple: int = 1) -> int:
        """Padded per-area neuron count ``N_max``.

        All areas are padded to the size of the largest area (the paper's
        'ghost neuron' construction, §4.1.1), rounded up to ``multiple`` so
        device sharding and VMEM tiling divide evenly.
        """
        n = self.n_max_area
        return ((n + multiple - 1) // multiple) * multiple

    @property
    def steps_intra_max(self) -> int:
        return int(round(self.delay_intra_max_ms / self.dt_ms))

    @property
    def steps_inter_min(self) -> int:
        return self.delay_ratio

    @property
    def steps_inter_max(self) -> int:
        return int(round(self.delay_inter_max_ms / self.dt_ms))

    @property
    def ring_len(self) -> int:
        """Ring-buffer length: one slot per step up to the maximum delay.

        A spike emitted at step ``t`` with delay ``d`` lands in slot
        ``(t + d) % ring_len``; the slot for step ``t`` is read (and cleared)
        at the start of step ``t``, so ``max_delay + 1`` slots suffice. The
        length is rounded up to a multiple of the delay ratio ``D`` so that
        window starts (``t0 ≡ 0 mod D``) always land on a slot-block boundary
        -- the engines' fused D-cycle superstep reads and clears one
        contiguous ``[.., D]`` block per window instead of one slot per cycle
        (see ``repro.core.ring_buffer.read_and_clear_block``).
        """
        base = max(self.steps_intra_max, self.steps_inter_max) + 1
        d = self.delay_ratio
        return ((base + d - 1) // d) * d

    @property
    def k_total(self) -> int:
        return self.k_intra + self.k_inter

    def area_sizes(self) -> np.ndarray:
        return np.asarray([a.n_neurons for a in self.areas], dtype=np.int32)

    def area_rates(self) -> np.ndarray:
        return np.asarray([a.rate_hz for a in self.areas], dtype=np.float32)

    def steps_for(self, t_model_ms: float) -> int:
        """Number of simulation cycles covering ``t_model_ms`` of model time."""
        s = t_model_ms / self.dt_ms
        if abs(s - round(s)) > 1e-9:
            raise ValueError("t_model_ms must be a multiple of dt_ms")
        return int(round(s))

    def adjacency_matrix(self) -> np.ndarray:
        """The [A, A] bool source->target adjacency this spec allows.

        ``None`` (the default) means all-to-all minus the diagonal; inter-area
        self-projections never exist (intra-area synapses are the separate
        short-range tier).
        """
        a = self.n_areas
        if self.area_adjacency is None:
            adj = ~np.eye(a, dtype=bool)
        else:
            adj = np.asarray(self.area_adjacency, dtype=bool) & ~np.eye(
                a, dtype=bool)
        if self.k_inter == 0:
            adj = np.zeros((a, a), dtype=bool)
        return adj


def ring_area_adjacency(
    n_areas: int, width: int = 1
) -> tuple[tuple[int, ...], ...]:
    """A deliberately sparse area graph: a directed ring of degree ``width``.

    ``adj[src][tgt]`` is 1 iff ``(tgt - src) mod A`` is in ``[1, width]`` --
    each area projects only to its next ``width`` neighbours, so a
    connectivity-routed exchange genuinely skips most group->group edges
    (the all-to-all MAM default makes every edge exist). Used by the
    exchange equivalence/wire-volume suites.
    """
    if not 1 <= width < n_areas:
        raise ValueError(f"width must be in [1, {n_areas - 1}]")
    return tuple(
        tuple(1 if ((t - s) % n_areas) in range(1, width + 1) else 0
              for t in range(n_areas))
        for s in range(n_areas)
    )


def mam_benchmark_spec(
    n_areas: int = 4,
    n_per_area: int = 200,
    k_intra: int = 16,
    k_inter: int = 16,
    rate_hz: float = 2.5,
    *,
    dt_ms: float = 0.1,
    d_min_inter_ms: float = 1.0,
    area_size_cv: float = 0.0,
    rate_cv: float = 0.0,
    seed: int = 12,
    area_adjacency: tuple[tuple[int, ...], ...] | None = None,
) -> MultiAreaSpec:
    """The homogeneous MAM-benchmark (paper §4.2), arbitrarily scalable.

    The paper's production setting is ``n_areas = M``, ``n_per_area ~= 130_000``,
    ``k_intra = k_inter ~= 3000``; the defaults here are laptop-scale and are
    overridden by configs/benchmarks. ``area_size_cv`` and ``rate_cv`` enable
    the controlled heterogeneity sweeps of Fig. 8: sizes/rates are drawn from
    normal distributions with fixed means (as in the paper).
    """
    rng = np.random.default_rng(seed)
    sizes = np.full(n_areas, n_per_area, dtype=np.int64)
    if area_size_cv > 0:
        draw = rng.normal(n_per_area, area_size_cv * n_per_area, size=n_areas)
        sizes = np.maximum(8, np.round(draw)).astype(np.int64)
    rates = np.full(n_areas, rate_hz, dtype=np.float64)
    if rate_cv > 0:
        draw = rng.normal(rate_hz, rate_cv * rate_hz, size=n_areas)
        rates = np.maximum(0.1, draw)
    areas = tuple(
        AreaSpec(name=f"A{i:02d}", n_neurons=int(sizes[i]), rate_hz=float(rates[i]))
        for i in range(n_areas)
    )
    # Benchmark delay statistics from the paper: intra ~ N(1.25, 0.625) ms,
    # inter ~ N(5, 2.5) ms, cut off below at dt and d_min_inter respectively.
    return MultiAreaSpec(
        areas=areas,
        dt_ms=dt_ms,
        d_min_inter_ms=d_min_inter_ms,
        k_intra=k_intra if n_areas > 1 else k_intra + k_inter,
        k_inter=k_inter if n_areas > 1 else 0,
        area_adjacency=area_adjacency,
    )


# Relative area sizes for the 32-area MAM. Derived from the published model's
# property that neuron densities vary across areas with CV ~= 0.2 around a mean
# of ~130k per 1 mm^2 patch; V1 is the largest area. The exact per-area neuron
# counts of Schmidt et al. (2018) require the experimental datasets which are
# not redistributable here; these deterministic relative sizes reproduce the
# published mean/CV/rank structure used by the performance study.
_MAM_REL_SIZES: tuple[float, ...] = (
    1.53, 1.48, 1.13, 1.11, 0.93, 0.88, 1.04, 1.24, 0.96, 0.85,
    0.95, 0.89, 0.98, 0.82, 0.80, 0.92, 1.01, 1.02, 0.97, 0.83,
    0.94, 0.96, 1.07, 1.18, 0.91, 0.86, 1.09, 1.12, 0.87, 1.15,
    0.90, 0.79,
)

# Per-area ground-state firing rates (spikes/s). The MAM ground state has a
# network mean of ~2.5 Hz with V2 ~68% above the mean (paper §2.4.3).
_MAM_REL_RATES: tuple[float, ...] = (
    1.10, 1.68, 1.05, 0.95, 0.90, 1.22, 0.86, 1.15, 0.82, 0.95,
    0.88, 0.78, 1.02, 0.72, 0.70, 1.08, 1.18, 0.92, 0.90, 0.85,
    0.96, 0.98, 1.25, 0.88, 0.80, 0.84, 1.12, 1.06, 0.78, 1.30,
    0.82, 0.68,
)


def mam_spec(
    *,
    scale: float = 1.0,
    mean_area_size: int = 130_000,
    mean_rate_hz: float = 2.5,
    k_intra: int = 4200,
    k_inter: int = 1800,
    d_min_inter_ms: float = 1.0,
    size_multiple: int = 8,
) -> MultiAreaSpec:
    """The 32-area multi-area model of macaque visual cortex (performance view).

    ``scale`` shrinks neuron counts and in-degrees together for laptop-scale
    validation (scale=1 is the production model: ~4.2M neurons, ~6000 synapses
    per neuron of which ~1800 are inter-area).
    """
    if not (0 < scale <= 1.0):
        raise ValueError("scale must be in (0, 1]")
    sizes = [
        max(size_multiple, int(round(r * mean_area_size * scale)))
        for r in _MAM_REL_SIZES
    ]
    rates = [mean_rate_hz * r for r in _MAM_REL_RATES]
    areas = tuple(
        AreaSpec(name=MAM_AREA_NAMES[i], n_neurons=sizes[i], rate_hz=rates[i])
        for i in range(32)
    )
    ki = max(1, int(round(k_intra * scale)))
    ke = max(1, int(round(k_inter * scale)))
    return MultiAreaSpec(
        areas=areas,
        d_min_inter_ms=d_min_inter_ms,
        k_intra=ki,
        k_inter=ke,
    )
