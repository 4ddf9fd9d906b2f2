"""The port's copies of the §2.2 / §2.3 analytics against the JAX package's.

``repro_torch.core.sync_model`` and ``delivery_model`` are numpy copies; the
cases of ``tests/test_theory.py`` that use them run on the port, and every
function gives the reference's value on a grid of inputs (``simulate_schedules``
on the same seeds). Tolerance: equal floats (the same numpy expressions),
except the paper's quoted numbers, held as ``tests/test_theory.py`` holds them.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import delivery_model as jdm
from repro.core import sync_model as jsm
from repro_torch.core import delivery_model as dm
from repro_torch.core import sync_model as sm


def test_norm_ppf_cdf_roundtrip():
    for p in (0.001, 0.035, 0.5, 0.9, 0.999):
        assert abs(sm.norm_cdf(sm.norm_ppf(p)) - p) < 1e-7


def test_blom_xi_monotone_and_magnitude():
    xis = [sm.blom_xi(m) for m in (2, 16, 32, 64, 128)]
    assert all(b > a for a, b in zip(xis, xis[1:]))
    assert 2.4 < sm.blom_xi(128) < 2.8


def test_sync_ratio_eq11():
    assert sm.sync_time_ratio(10) == pytest.approx(1 / math.sqrt(10))
    c = sm.expected_wall_conventional(1000, 128, 1.6e-3, 0.05e-3)
    s = sm.expected_wall_structure_aware(1000, 10, 128, 1.6e-3, 0.05e-3)
    assert (s - 1.6) / (c - 1.6) == pytest.approx(1 / math.sqrt(10))


def test_eq12_quantile_band():
    tail = sm.tail_for_max_coverage(0.99, 128)
    assert 0.03 < tail < 0.04
    assert sm.max_tail_probability(0.035, 128) == pytest.approx(0.99, abs=0.01)


def test_monte_carlo_iid_matches_eq11():
    model = sm.CycleTimeModel(mu=1.6e-3, sigma=0.08e-3)
    conv, struc = sm.simulate_schedules(model, m=128, s=20000, d=10, seed=0)
    assert struc.sync / conv.sync == pytest.approx(1 / math.sqrt(10), rel=0.12)
    assert struc.n_syncs == conv.n_syncs // 10


@pytest.mark.parametrize("m,t_m,expected_pct", [
    (32, 48, 12), (32, 128, 29), (128, 48, 37), (128, 128, 43),
])
def test_fig6b_reductions_match_paper(m, t_m, expected_pct):
    _, _, red = dm.fig6b_reduction(m, t_m)
    assert abs(100 * red - expected_pct) < 1.6, (m, t_m, red)


def test_f_irr_bounds():
    for m, t_m in ((16, 48), (128, 128)):
        f_c = dm.f_irr_conventional(m * 130_000, 6000, m, t_m)
        f_s = dm.f_irr_structure_aware(m * 130_000, 6000, m, t_m)
        assert 0 < f_s <= f_c <= 1.0


def test_sync_model_equals_the_references():
    for p in (1e-4, 0.01, 0.02425, 0.3, 0.5, 0.97576, 0.999):
        assert sm.norm_ppf(p) == jsm.norm_ppf(p)
        assert sm.norm_cdf(p * 4 - 2) == jsm.norm_cdf(p * 4 - 2)
        assert sm.norm_pdf(p) == jsm.norm_pdf(p)
    for m in (1, 2, 7, 128, 4096):
        assert sm.blom_xi(m) == jsm.blom_xi(m)
        assert sm.expected_wall_conventional(500, m, 1.6e-3, 5e-5) == \
            jsm.expected_wall_conventional(500, m, 1.6e-3, 5e-5)
        assert sm.expected_wall_structure_aware(500, 10, m, 1.6e-3, 5e-5) == \
            jsm.expected_wall_structure_aware(500, 10, m, 1.6e-3, 5e-5)
        assert sm.tail_for_max_coverage(0.99, m) == jsm.tail_for_max_coverage(0.99, m)
        assert sm.max_tail_probability(0.035, m) == jsm.max_tail_probability(0.035, m)
    for args in ((1.0, 0.1, 1.2, 0.3), (2.0, 0.0, 1.0, 0.0), (0.5, 0.2, 0.5, 0.2)):
        assert sm.expected_max_normals(*args) == jsm.expected_max_normals(*args)
        assert sm.expected_wall_overlapped(17, *args) == jsm.expected_wall_overlapped(17, *args)
    assert sm.sync_time_ratio(10) == jsm.sync_time_ratio(10)


@pytest.mark.parametrize("kw", [
    dict(mu=1.6e-3, sigma=0.08e-3),
    dict(mu=1.6e-3, sigma=0.065e-3, rho=0.6, minor_mode_shift=0.3e-3,
         minor_mode_weight=0.02, minor_mode_dwell=5.0, process_spread=1e-5),
], ids=["iid", "correlated"])
def test_monte_carlo_equals_the_references(kw):
    got = sm.simulate_schedules(sm.CycleTimeModel(**kw), 16, 2000, 10, seed=5)
    want = jsm.simulate_schedules(jsm.CycleTimeModel(**kw), 16, 2000, 10, seed=5)
    assert [dataclasses.asdict(x) for x in got] == [dataclasses.asdict(x) for x in want]
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert np.array_equal(sm.CycleTimeModel(**kw).sample(4, 50, rng_a),
                          jsm.CycleTimeModel(**kw).sample(4, 50, rng_b))


def test_delivery_model_equals_the_references():
    for m in (2, 16, 32, 128):
        for t_m in (1, 48, 128):
            assert dm.fig6b_reduction(m, t_m) == jdm.fig6b_reduction(m, t_m)
            n = m * 130_000
            assert dm.f_irr_conventional(n, 6000, m, t_m) == \
                jdm.f_irr_conventional(n, 6000, m, t_m)
            assert dm.f_irr_structure_aware(n, 6000, m, t_m, 4200, 1800) == \
                jdm.f_irr_structure_aware(n, 6000, m, t_m, 4200, 1800)
    assert dm.p_target_inter(1000, 100, 3.5, 20) == jdm.p_target_inter(1000, 100, 3.5, 20)
    assert dm.p_target_intra(100, 3.5, 20) == jdm.p_target_intra(100, 3.5, 20)
    assert dm.p_target_conventional(1000, 3.5, 20) == jdm.p_target_conventional(1000, 3.5, 20)
