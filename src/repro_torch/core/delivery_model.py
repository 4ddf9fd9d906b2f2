"""§2.3 -- cache model of spike delivery (irregular memory access fractions).

The port's own copy of ``repro.core.delivery_model`` (pure numpy),
function for function.

Delivering a spike to its *first* target synapse on a thread is an irregular
(uncached) access; subsequent targets on the same thread are sequential. The
paper derives the fraction of irregular accesses for both placements
(eqs. 13-17); the structure-aware placement keeps all intra-area targets on
one process, so its advantage grows with M and T_M (Fig. 6b).

The formulas only count first-touch probabilities, so they carry over to
any placement unit that plays the role of the paper's thread.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "p_target_conventional",
    "f_irr_conventional",
    "p_target_intra",
    "p_target_inter",
    "f_irr_structure_aware",
    "fig6b_reduction",
]


def p_target_conventional(n: int, n_t: float, k_n: float) -> float:
    """Eq. (13): P(a neuron has >= 1 target on a specific thread)."""
    return 1.0 - (1.0 - 1.0 / n) ** (n_t * k_n)


def f_irr_conventional(n: int, k_n: float, m: int, t_m: int) -> float:
    """Eq. (14): irregular-access fraction, round-robin placement."""
    t = m * t_m
    n_t = n / t
    return p_target_conventional(n, n_t, k_n) * t / k_n


def p_target_intra(n_m: float, n_t: float, k_intra: float) -> float:
    """Eq. (15): >= 1 intra-area target on a thread of the hosting process."""
    return 1.0 - (1.0 - 1.0 / n_m) ** (n_t * k_intra)


def p_target_inter(n: int, n_m: float, n_t: float, k_inter: float) -> float:
    """Eq. (16): >= 1 inter-area target on a thread of a remote process."""
    return 1.0 - (1.0 - 1.0 / (n - n_m)) ** (n_t * k_inter)


def f_irr_structure_aware(
    n: int,
    k_n: float,
    m: int,
    t_m: int,
    k_intra: float | None = None,
    k_inter: float | None = None,
) -> float:
    """Eq. (17): irregular-access fraction, structure-aware placement.

    Defaults to the paper's equal split K_intra = K_inter = K_N / 2 and equal
    area sizes N_M = N / M.
    """
    if k_intra is None:
        k_intra = k_n / 2
    if k_inter is None:
        k_inter = k_n / 2
    n_m = n / m
    n_t = n / (m * t_m)
    p_i = p_target_intra(n_m, n_t, k_intra)
    p_e = p_target_inter(n, n_m, n_t, k_inter) if m > 1 else 0.0
    return (p_i * t_m + p_e * t_m * (m - 1)) / k_n


def fig6b_reduction(
    m: int,
    t_m: int,
    n_m: int = 130_000,
    k_n: int = 6000,
) -> tuple[float, float, float]:
    """Weak-scaling point of Fig. 6b: (f_conv, f_struc, relative reduction).

    Weak scaling: N = M * N_M. The paper quotes reductions of 12 % (M=32,
    T_M=48), 29 % (M=32, T_M=128), 37 % (M=128, T_M=48), 43 % (M=128,
    T_M=128); tests assert these within rounding.
    """
    n = m * n_m
    f_c = f_irr_conventional(n, k_n, m, t_m)
    f_s = f_irr_structure_aware(n, k_n, m, t_m)
    return f_c, f_s, 1.0 - f_s / f_c
