"""The port's copies of the §2.2 / §2.3 analytics and of the cost model
against the JAX package's.

``repro_torch.core.sync_model``, ``delivery_model`` and ``cost_model`` are
numpy copies; the cases of ``tests/test_theory.py`` that use them run on the
port (and the cost-model cases of ``tests/test_exchange.py:448`` and
``tests/test_adaptive.py:332``), and every function gives the reference's
value on a grid of inputs (``simulate_schedules`` and ``simulate_rtf`` on
the same seeds). Tolerance: equal floats (the same numpy expressions),
except the paper's quoted numbers, held as ``tests/test_theory.py`` holds them.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.core import delivery_model as jdm
from repro.core import sync_model as jsm
from repro_torch.core import cost_model as cm
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


# ----------------------------------------------------------- cost model


def test_fig7a_weak_scaling_reproduction():
    """Calibrated model reproduces Fig. 7a within ~20%: conv 9.4 -> 22.7,
    struct 8.5 -> 15.7; struct strictly faster, gap grows with M."""
    wl = cm.WorkloadModel()
    conv16 = cm.simulate_rtf(wl, cm.SUPERMUC, 16, "conventional", seed=1).total
    conv128 = cm.simulate_rtf(wl, cm.SUPERMUC, 128, "conventional", seed=1).total
    str16 = cm.simulate_rtf(wl, cm.SUPERMUC, 16, "structure_aware", seed=1).total
    str128 = cm.simulate_rtf(wl, cm.SUPERMUC, 128, "structure_aware", seed=1).total
    assert conv16 == pytest.approx(9.4, rel=0.25)
    assert conv128 == pytest.approx(22.7, rel=0.25)
    assert str16 == pytest.approx(8.5, rel=0.25)
    assert str128 == pytest.approx(15.7, rel=0.25)
    assert str128 < conv128 and str16 <= conv16 * 1.02
    assert (conv128 - str128) > (conv16 - str16)


def test_fig7a_phase_reductions_at_m128():
    wl = cm.WorkloadModel()
    c = cm.simulate_rtf(wl, cm.SUPERMUC, 128, "conventional", seed=1)
    s = cm.simulate_rtf(wl, cm.SUPERMUC, 128, "structure_aware", seed=1)
    assert 0.15 < 1 - s.deliver / c.deliver < 0.45          # paper: 25 %
    assert 0.6 < 1 - s.communicate / c.communicate < 0.97   # paper: 76 %
    assert 0.25 < 1 - s.synchronize / c.synchronize < 0.65  # paper: 48 %


def test_fig8a_area_size_heterogeneity_increases_sync():
    s0 = cm.simulate_rtf(cm.WorkloadModel(area_size_cv=0.0), cm.SUPERMUC, 64,
                         "structure_aware", seed=2)
    s2 = cm.simulate_rtf(cm.WorkloadModel(area_size_cv=0.2), cm.SUPERMUC, 64,
                         "structure_aware", seed=2)
    assert s2.synchronize > s0.synchronize * 1.5
    assert s2.total > s0.total


def test_fig8c_diminishing_returns_in_d():
    """Communication gain saturates for D > 10 (paper Fig. 8c / eq. 11)."""
    totals = {d: cm.simulate_rtf(cm.WorkloadModel(d=d), cm.SUPERMUC, 64,
                                 "structure_aware", seed=3).total
              for d in (1, 5, 10, 20)}
    assert totals[5] < totals[1]
    gain_1_5 = totals[1] - totals[5]
    assert totals[5] - totals[10] < gain_1_5, "gain must shrink past D=5"
    assert totals[10] - totals[20] < 0.5 * gain_1_5, "gain must be marginal past D=10"


def test_fig9_jureca_vs_supermuc():
    """JURECA (128 threads) is faster and less imbalance-sensitive (§2.4.3)."""
    wl = cm.WorkloadModel(area_size_cv=0.2, rate_cv=0.25, neuron_model="lif")
    sm_ = cm.simulate_rtf(wl, cm.SUPERMUC, 32, "structure_aware", seed=4)
    ju = cm.simulate_rtf(wl, cm.JURECA, 32, "structure_aware", seed=4)
    assert ju.total < sm_.total
    assert ju.deliver < sm_.deliver


def test_collective_model_sublinear():
    """Fig. 4: one D-sized message beats D unit messages (latency regime)."""
    mpi = cm.SUPERMUC_MPI
    b = 317 * 128  # buffer/rank x ranks at M=128
    assert mpi.call_time_s(128, 10 * b) < 0.3 * 10 * mpi.call_time_s(128, b)


def test_cost_model_prices_wire_counters():
    """``tests/test_exchange.py:448`` on the port: strictly fewer routed
    bytes price out as a strictly cheaper communicate RTF."""
    from repro_torch.core import exchange as exchange_lib
    from repro_torch.core.areas import mam_benchmark_spec, ring_area_adjacency
    from repro_torch.core.connectivity import area_adjacency, build_network

    spec = mam_benchmark_spec(n_areas=8, n_per_area=64, k_intra=8, k_inter=8,
                              area_adjacency=ring_area_adjacency(8, width=2))
    net = build_network(spec, seed=12, outgoing=True, device="cpu")
    rep = exchange_lib.wire_report(net, area_adjacency(net, spec), backend="event",
                                   n_groups=8, gsz=2)
    wl = cm.WorkloadModel(n_m=64, k_n=16)
    rtf = {name: cm.simulate_rtf(wl, cm.SUPERMUC, 16, "structure_aware", seed=3,
                                 bytes_per_window=rep[name]["total_bytes"]).communicate
           for name in ("dense", "routed")}
    assert rep["routed"]["total_bytes"] < rep["dense"]["total_bytes"]
    assert rtf["routed"] < rtf["dense"]
    wjl = jcm.WorkloadModel(n_m=64, k_n=16)
    assert rtf["routed"] == jcm.simulate_rtf(
        wjl, jcm.SUPERMUC, 16, "structure_aware", seed=3,
        bytes_per_window=rep["routed"]["total_bytes"]).communicate


def test_adaptive_two_phase_cost():
    """``tests/test_adaptive.py:332``'s pricing on the port: one extra alpha
    dispatch, won back by the byte saving at scale."""
    from repro_torch.core import exchange as exchange_lib
    from repro_torch.core.areas import mam_benchmark_spec, ring_area_adjacency
    from repro_torch.core.connectivity import area_adjacency, build_network

    spec = mam_benchmark_spec(n_areas=8, n_per_area=256, k_intra=8, k_inter=8,
                              area_adjacency=ring_area_adjacency(8, width=2))
    net = build_network(spec, seed=12, outgoing=True, device="cpu")
    rep = exchange_lib.wire_report(net, area_adjacency(net, spec), backend="event",
                                   n_groups=8, gsz=2, headroom=8.0, floor=4)
    mpi = cm.SUPERMUC_MPI
    ad = rep["routed"]["adaptive"]
    assert ad["saved_bytes"] > 0
    two_t = cm.exchange_time_s(ad["counts_bytes"], ad["payload_bytes_expected"], 16, mpi)
    assert two_t == pytest.approx(mpi.call_time_s(16, ad["counts_bytes"])
                                  + mpi.call_time_s(16, ad["payload_bytes_expected"]))
    assert cm.exchange_time_s(64, 1000, 16, mpi) > cm.exchange_time_s(0, 1000, 16, mpi)
    big_static, big_adapt = 140 * 2**20, 26 * 2**20
    assert cm.exchange_time_s(340_000, big_adapt, 256, mpi) < \
        cm.exchange_time_s(0, big_static, 256, mpi)


def test_cost_model_equals_the_reference():
    """Every public function and constant on a grid of inputs, equal floats;
    the TPU's collective model has no counterpart."""
    assert set(cm.__all__) == set(jcm.__all__) - {"TPU_ICI"}
    assert not hasattr(cm, "TPU_ICI")
    for name in ("SUPERMUC_MPI", "JURECA_MPI", "SUPERMUC", "JURECA"):
        assert dataclasses.asdict(getattr(cm, name)) == dataclasses.asdict(getattr(jcm, name))
    for mpi, jmpi in ((cm.SUPERMUC_MPI, jcm.SUPERMUC_MPI), (cm.JURECA_MPI, jcm.JURECA_MPI)):
        for m in (0, 1, 2, 3, 16, 100, 128, 256, 4096):
            assert mpi.alpha_us(m) == jmpi.alpha_us(m)
            for b in (0.0, 64.0, 1e6, 3.3e9):
                assert mpi.call_time_s(m, b) == jmpi.call_time_s(m, b)
                assert cm.exchange_time_s(b / 7, b, m, mpi) == \
                    jcm.exchange_time_s(b / 7, b, m, jmpi)
                assert cm.exchange_time_s(0, b, m, mpi) == jcm.exchange_time_s(0, b, m, jmpi)
    for touches in (0.0, 1.0, 3.9e6, 1.1e9):
        for hw, jhw in ((cm.SUPERMUC, jcm.SUPERMUC), (cm.JURECA, jcm.JURECA)):
            assert cm.receive_time_s(touches, hw) == jcm.receive_time_s(touches, jhw)
    workloads = [dict(), dict(neuron_model="lif", rate_cv=0.25, area_size_cv=0.2),
                 dict(d=5, k_intra_frac=0.7, rate_hz=7.0), dict(n_m=64, k_n=16, d=1)]
    for kw in workloads:
        wl, jwl = cm.WorkloadModel(**kw), jcm.WorkloadModel(**kw)
        assert wl.spikes_per_proc_cycle() == jwl.spikes_per_proc_cycle()
        for (hw, jhw), m, sched, seed, b in (
                ((cm.SUPERMUC, jcm.SUPERMUC), 16, "conventional", 0, None),
                ((cm.SUPERMUC, jcm.SUPERMUC), 128, "structure_aware", 1, None),
                ((cm.JURECA, jcm.JURECA), 32, "structure_aware", 4, 2.5e6),
                ((cm.JURECA, jcm.JURECA), 64, "conventional", 7, 1e3)):
            got = cm.simulate_rtf(wl, hw, m, sched, seed=seed, t_model_s=0.2,
                                  bytes_per_window=b)
            want = jcm.simulate_rtf(jwl, jhw, m, sched, seed=seed, t_model_s=0.2,
                                    bytes_per_window=b)
            assert got.as_dict() == want.as_dict()
            assert got.total == want.total
