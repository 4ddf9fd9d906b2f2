"""The port's single-host exchange against the JAX package's, on the CPU:
the adaptive packet ladders, the overlapped window-end pipeline and the
config rules that come with them.

Mirrors the single-host cases of ``tests/test_adaptive.py`` and
``tests/test_overlap.py`` (2-4 areas x 32 neurons, K 4). Tolerance: bitwise
for every leaf, overflow included.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.areas import mam_benchmark_spec as jax_spec  # noqa: E402
from repro.core.connectivity import build_network as jax_build  # noqa: E402
from repro.core.engine import ConfigError as JaxConfigError  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.factory import make_simulation as jax_make  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConfigError, EngineConfig, make_simulation, mam_benchmark_spec, run_windows,
)
from test_torch_engine import assert_same, snapshot  # noqa: E402
from test_torch_event import carry  # noqa: E402


def leaves(state, block) -> dict:
    return dict(snapshot(state, block), overflow=int(state.overflow))


# ---------------------------------------------------------------------------
# Adaptive ladders (tests/test_adaptive.py, single host)
# ---------------------------------------------------------------------------

ADAPTIVE_SIZE = dict(n_areas=4, n_per_area=32, k_intra=4, k_inter=4, rate_hz=1000.0)


@functools.lru_cache(maxsize=None)
def adaptive_reference():
    """The JAX onehot reference (blocks and ring) on the adaptive tests'
    network, and the busiest cycle's whole-network count."""
    spec = jax_spec(**ADAPTIVE_SIZE)
    net = jax_build(spec, seed=12, size_multiple=8, outgoing=True)
    eng = jax_make(spec, JaxConfig(neuron_model="ignore_and_fire"), net=net)
    st, snaps = eng.init(), []
    for _ in range(4):
        st, blk = eng.window(st)
        snaps.append(leaves(st, blk))
    max_cycle = max(int(s["block"].reshape(s["block"].shape[0], -1).sum(1).max())
                    for s in snaps)
    return net, snaps, max_cycle


@pytest.mark.parametrize("superstep", [None, False], ids=["superstep", "legacy"])
@pytest.mark.parametrize("floor", ["max_cycle", "max_cycle-1", "1"])
def test_adaptive_event_engine_bitwise_with_zero_overflow(floor, superstep):
    """The floor rung pinned exactly on the busiest cycle's count, one below
    it, and 1: every window equals the JAX reference (the JAX adaptive event
    engine, leaf for leaf), overflow stays 0."""
    net, ref, max_cycle = adaptive_reference()
    assert max_cycle > 1, "workload must spike"
    floor = {"max_cycle": max_cycle, "max_cycle-1": max_cycle - 1, "1": 1}[floor]
    kw = dict(neuron_model="ignore_and_fire", delivery_backend="event",
              adaptive_exchange=True, s_max_headroom=0.0, s_max_floor=floor,
              superstep=superstep)
    jeng = jax_make(jax_spec(**ADAPTIVE_SIZE), JaxConfig(**kw), net=net)
    teng = make_simulation(mam_benchmark_spec(**ADAPTIVE_SIZE), EngineConfig(**kw),
                           net=carry(net), device="cpu")
    js, ts = jeng.init(), teng.init()
    for w in range(4):
        js, jb = jeng.window(js)
        ts, tb = teng.window(ts)
        got = leaves(ts, tb)
        assert_same(got, leaves(js, jb), (floor, w))
        for k in ("block", "ring", "spike_count"):
            assert np.array_equal(got[k], ref[w][k]), (floor, w, k)
    assert int(ts.overflow) == 0


def test_adaptive_eliminates_forced_overflow():
    """``headroom=0, floor=1`` makes the static bounds drop spikes; the
    adaptive engine with the same config drops none and equals the
    reference ring."""
    net, ref, _ = adaptive_reference()
    spec = mam_benchmark_spec(**ADAPTIVE_SIZE)
    kw = dict(neuron_model="ignore_and_fire", delivery_backend="event",
              s_max_headroom=0.0, s_max_floor=1)
    static = make_simulation(spec, EngineConfig(**kw), net=carry(net), device="cpu")
    adaptive = make_simulation(spec, EngineConfig(adaptive_exchange=True, **kw),
                               net=carry(net), device="cpu")
    ss, sa = static.init(), adaptive.init()
    for _ in range(4):
        ss, _ = static.window(ss)
        sa, _ = adaptive.window(sa)
    assert int(ss.overflow) > 0 and int(sa.overflow) == 0
    assert np.array_equal(sa.ring.numpy(), ref[-1]["ring"])


# ---------------------------------------------------------------------------
# Overlapped pipeline (tests/test_overlap.py, single host)
# ---------------------------------------------------------------------------

OVERLAP_SIZE = dict(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)


@functools.lru_cache(maxsize=None)
def overlap_network():
    return carry(jax_build(jax_spec(**OVERLAP_SIZE), seed=12, outgoing=True))


def overlap_engine(**kw):
    cfg = EngineConfig(neuron_model="lif", delivery_backend="event", s_max_floor=4, **kw)
    return make_simulation(mam_benchmark_spec(**OVERLAP_SIZE), cfg, net=overlap_network(),
                           device="cpu")


def assert_states_equal(a, b, where):
    assert a.t == b.t, where
    assert int(a.overflow) == int(b.overflow), where
    assert float(a.shipped_bytes) == float(b.shipped_bytes), where
    for name in ("ring", "spike_count"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (where, name)
    for name in vars(a.neuron):
        assert torch.equal(getattr(a.neuron, name), getattr(b.neuron, name)), (where, name)


@pytest.mark.parametrize("superstep", [True, False], ids=["superstep", "legacy"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_overlap_bitwise_equals_sequential(adaptive, superstep):
    """run_windows, Engine.run and the compatibility window of the overlapped
    engine all reproduce the sequential trajectory."""
    seq = overlap_engine(superstep=superstep, adaptive_exchange=adaptive)
    ovl = overlap_engine(superstep=superstep, adaptive_exchange=adaptive,
                         overlap_exchange=True)
    assert ovl.window_overlap is not None and seq.window_overlap is None

    blocks = {"seq": [], "ovl": []}
    ref = run_windows(seq, seq.init(), 6, on_block=lambda w, b: blocks["seq"].append(b))
    res = run_windows(ovl, ovl.init(), 6, on_block=lambda w, b: blocks["ovl"].append(b))
    assert len(blocks["ovl"]) == 6
    assert all(map(torch.equal, blocks["ovl"], blocks["seq"]))
    assert res.overlapped and res.drains == 1
    assert not ref.overlapped and ref.drains == 0
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window)
    assert_states_equal(res.state, ref.state, "run_windows")

    st_r, tot_r = seq.run(seq.init(), 6)
    st_o, tot_o = ovl.run(ovl.init(), 6)
    assert torch.equal(tot_o, tot_r)
    assert_states_equal(st_o, st_r, "Engine.run")

    st_a, blk_a = seq.window(seq.init())
    st_b, blk_b = ovl.window(ovl.init())
    assert torch.equal(blk_a, blk_b)
    assert_states_equal(st_a, st_b, "compatibility window")


def test_overlap_matches_jax_and_drains_to_the_sequential_state():
    """The port's overlapped pipeline window by window against the JAX
    package's (``window_overlap``, then ``drain``), with forced overflow so
    that the in-flight accounting is exercised."""
    kw = dict(neuron_model="ignore_and_fire", delivery_backend="event",
              s_max_headroom=0.0, s_max_floor=1, overlap_exchange=True)
    spec = dict(n_areas=2, n_per_area=64, k_intra=4, k_inter=4, rate_hz=2000.0)
    jnet = jax_build(jax_spec(**spec), seed=12, outgoing=True)
    jeng = jax_make(jax_spec(**spec), JaxConfig(**kw), net=jnet)
    teng = make_simulation(mam_benchmark_spec(**spec), EngineConfig(**kw), net=carry(jnet),
                           device="cpu")
    js, ji = jeng.init(), jeng.init_inflight()
    ts, ti = teng.init(), teng.init_inflight()
    assert ti.wire is None
    for w in range(5):
        js, ji, jb = jeng.window_overlap(js, ji)
        ts, ti, tb = teng.window_overlap(ts, ti)
        assert_same(leaves(ts, tb), leaves(js, jb), ("in flight", w))
        jd, td = jeng.drain(js, ji), teng.drain(ts, ti)
        assert_same(leaves(td, tb), leaves(jd, jb), ("drained", w))
    assert int(ts.overflow) > 0


# ---------------------------------------------------------------------------
# Config rules
# ---------------------------------------------------------------------------


def violations(err):
    return [(v.field, v.problem, v.remedy) for v in err.value.violations]


@pytest.mark.parametrize("fields", [
    dict(s_max_burst=-1),
    dict(s_max_burst=0),
    dict(schedule="conventional", overlap_exchange=True),
    dict(schedule="conventional", overlap_exchange=True, s_max_burst=0,
         superstep_kernel=True),
], ids=["burst_-1", "burst_0", "overlap_conventional", "three_rules"])
def test_config_rules_match_jax(fields):
    with pytest.raises(JaxConfigError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ConfigError) as err:
        EngineConfig(**fields)
    assert violations(err) == violations(jerr)


@pytest.mark.parametrize("burst", [1, 2])
def test_valid_event_configs_are_accepted(burst):
    for kw in (dict(s_max_burst=burst), dict(delivery_backend="event", s_max_burst=burst,
                                             adaptive_exchange=True, overlap_exchange=True)):
        assert JaxConfig(**kw).validate() == []
        assert EngineConfig(**kw).validate() == []


def test_event_backend_needs_outgoing_tables_as_in_jax():
    spec = dict(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)
    jnet = jax_build(jax_spec(**spec), seed=12)
    cfg = dict(delivery_backend="event")
    with pytest.raises(ValueError) as jerr:
        jax_make(jax_spec(**spec), JaxConfig(**cfg), net=jnet)
    with pytest.raises(ValueError) as err:
        make_simulation(mam_benchmark_spec(**spec), EngineConfig(**cfg), net=carry(jnet),
                        device="cpu")
    assert str(err.value) == str(jerr.value)
