"""The port's single-host engine against the JAX engine, window by window.

Sizes mirror ``tests/test_system.py`` (4 areas x 48 neurons, K 8/8). The JAX
reference is the jitted ``pallas``-backend engine; the port runs on the CPU,
where its kernels take their plain PyTorch versions. Both engines get the
same network, carried across with ``network_from_numpy``, so engine parity
is tested apart from construction parity. Tolerance: bitwise for every leaf
-- spike blocks, ``spike_count``, ring and neuron state -- after every window.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.areas import mam_benchmark_spec as jax_spec  # noqa: E402
from repro.core.connectivity import build_network as jax_build  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.factory import make_simulation as jax_make  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConfigError,
    EngineConfig,
    build_network,
    make_simulation,
    mam_benchmark_spec,
    network_from_numpy,
    run_windows,
    state_from_numpy,
)
from repro_torch.core.faults import Preempted  # noqa: E402

SIZE = dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
# neuron model -> (area rate Hz, build seed, windows), as in test_system.py
CASES = {"ignore_and_fire": (30.0, 91856, 12), "lif": (2.5, 12, 30)}
TABLES = ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra",
          "src_inter", "w_inter", "delay_inter")
STATIC = ("n_pad", "n_areas", "ring_len", "delay_ratio", "dt_ms",
          "steps_lo_intra", "r_span_intra", "steps_lo_inter", "r_span_inter")
SCHEDULES = ("conventional", "structure_aware")


@functools.lru_cache(maxsize=None)
def jax_network(model):
    rate, seed, _ = CASES[model]
    spec = jax_spec(**SIZE, rate_hz=rate)
    return spec, jax_build(spec, seed=seed)


def port_spec(model):
    return mam_benchmark_spec(**SIZE, rate_hz=CASES[model][0])


def carried_network(model):
    _, jnet = jax_network(model)
    return network_from_numpy(
        {f: np.asarray(getattr(jnet, f)) for f in TABLES}, device="cpu",
        **{f: getattr(jnet, f) for f in STATIC})


def snapshot(state, block) -> dict:
    """Every leaf of a (state, block) pair as numpy, from either package."""
    def np_(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {"block": np_(block), "ring": np_(state.ring), "t": int(state.t),
           "spike_count": np_(state.spike_count)}
    neuron = state.neuron
    names = (neuron._fields if hasattr(neuron, "_fields")
             else [f.name for f in dataclasses.fields(neuron)])
    out.update({n: np_(getattr(neuron, n)) for n in names})
    return out


@functools.lru_cache(maxsize=None)
def jax_trajectory(model, schedule):
    """Snapshots after every window of the JAX pallas engine."""
    spec, net = jax_network(model)
    eng = jax_make(spec, JaxConfig(neuron_model=model, schedule=schedule,
                                   delivery_backend="pallas"), net=net)
    st, snaps = eng.init(), []
    for _ in range(CASES[model][2]):
        st, blk = eng.window(st)
        snaps.append(snapshot(st, blk))
    return snaps


def assert_same(got: dict, want: dict, where):
    assert got.keys() == want.keys(), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)


def port_engine(model, schedule, net=None, **cfg):
    cfg.setdefault("delivery_backend", "pallas")
    return make_simulation(
        port_spec(model), EngineConfig(neuron_model=model, schedule=schedule, **cfg),
        net=carried_network(model) if net is None else net, device="cpu")


@pytest.mark.parametrize("model", list(CASES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_engine_matches_jax_pallas_engine(schedule, model):
    want = jax_trajectory(model, schedule)
    eng = port_engine(model, schedule)
    st = eng.init()
    for w, snap in enumerate(want):
        st, blk = eng.window(st)
        assert_same(snapshot(st, blk), snap, (schedule, model, w))
    assert int(st.spike_count.sum()) > 0


@pytest.mark.parametrize("model,schedule,start",
                         [("lif", "structure_aware", 10), ("ignore_and_fire", "conventional", 5)])
def test_engine_resumes_from_a_jax_state(model, schedule, start):
    """A JAX mid-run state carried across continues bitwise."""
    want = jax_trajectory(model, schedule)
    leaves = {k: v for k, v in want[start - 1].items() if k != "block"}
    st = state_from_numpy(leaves, device="cpu")
    eng = port_engine(model, schedule)
    for w in range(start, len(want)):
        st, blk = eng.window(st)
        assert_same(snapshot(st, blk), want[w], (model, schedule, w))


@pytest.mark.parametrize("model", list(CASES))
def test_superstep_scan_unroll_legacy_bitwise(model):
    engines = [port_engine(model, "structure_aware", **kw)
               for kw in ({}, dict(superstep_unroll=True), dict(superstep=False))]
    states = [e.init() for e in engines]
    for w in range(CASES[model][2]):
        snaps = []
        for i, eng in enumerate(engines):
            states[i], blk = eng.window(states[i])
            snaps.append(snapshot(states[i], blk))
        for s in snaps[1:]:
            assert_same(s, snaps[0], (model, w))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_delivery_backends_bitwise(schedule):
    engines = [port_engine("ignore_and_fire", schedule, delivery_backend=b)
               for b in ("onehot", "scatter", "pallas")]
    states = [e.init() for e in engines]
    for w in range(12):
        snaps = []
        for i, eng in enumerate(engines):
            states[i], blk = eng.window(states[i])
            snaps.append(snapshot(states[i], blk))
        for s in snaps[1:]:
            assert_same(s, snaps[0], (schedule, w))
    assert int(states[0].spike_count.sum()) > 0


def test_port_built_network_gives_the_same_trajectory():
    want = jax_trajectory("lif", "structure_aware")
    net = build_network(port_spec("lif"), seed=CASES["lif"][1], device="cpu")
    eng = port_engine("lif", "structure_aware", net=net)
    st = eng.init()
    for w, snap in enumerate(want):
        st, blk = eng.window(st)
        assert_same(snapshot(st, blk), snap, w)


def test_run_and_run_windows_count_the_same_spikes():
    want = [int(s["block"].sum()) for s in jax_trajectory("ignore_and_fire", "structure_aware")]
    eng = port_engine("ignore_and_fire", "structure_aware")
    st, totals = eng.run(eng.init(), len(want))
    assert totals.tolist() == want and st.t == len(want) * eng.delay_ratio
    blocks = []
    res = run_windows(eng, eng.init(), len(want), on_block=lambda w, b: blocks.append(w))
    assert res.spikes_per_window.tolist() == want and blocks == list(range(1, len(want) + 1))
    assert torch.equal(res.state.ring, st.ring)
    # The resilient loop is ported: a stop request ends the run at the first
    # window boundary, with the windows done so far on the exception.
    with pytest.raises(Preempted) as stop:
        run_windows(eng, eng.init(), len(want), stop_requested=lambda: True)
    assert stop.value.window == 1 and stop.value.result.spikes_per_window.tolist() == want[:1]


def test_make_simulation_defaults_to_cuda(monkeypatch):
    """No device given means CUDA; without a GPU that raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(delivery_backend="pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_simulation(port_spec("lif"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_simulation(port_spec("lif"), cfg, net=carried_network("lif"))


def test_unported_features_are_reported_with_their_roadmap_item():
    # Every feature of the config is ported: the routed exchange and the
    # host-free build are accepted by the construction rules, and only the
    # single-host rules refuse them (they need a mesh).
    cfg = EngineConfig(delivery_backend="event", adaptive_exchange=True,
                       overlap_exchange=True, exchange="routed", sharded_build=True)
    assert cfg.validate() == [] and cfg.validate(distributed=True) == []
    assert [v.field for v in cfg.validate(distributed=False)] == ["exchange", "sharded_build"]
    assert not any("ROADMAP" in v.remedy for v in cfg.validate(distributed=False))
    with pytest.raises(ConfigError, match="distributed construction mode"):
        make_simulation(port_spec("lif"), EngineConfig(
            delivery_backend="event", sharded_build=True), device="cpu")
    with pytest.raises(ConfigError, match="superstep=True requires"):
        EngineConfig(schedule="conventional", superstep=True)
