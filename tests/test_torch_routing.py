"""The routed exchange's host-side parts against the JAX package, free of any
process world: ``build_routing`` (with the hierarchical round order), the
wire reports (``routed_wire_bytes``, ``adaptive_wire_bytes``,
``inter_table_report``, ``priced_inter_table_report``, ``wire_report``),
``area_adjacency``, the plan cache (the cases of ``tests/test_plan_cache.py``)
and the routed config refusals (``tests/test_exchange.py:374-428``, the
mesh cases in a one-rank gloo world in this process). Tolerance: equal
dicts, arrays and plans; bitwise trajectories.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import connectivity as jconn  # noqa: E402
from repro.core import delivery as jdelivery  # noqa: E402
from repro.core import exchange as jexchange  # noqa: E402
from repro.core.areas import mam_benchmark_spec as jax_spec  # noqa: E402
from repro.core.areas import ring_area_adjacency as jax_ring  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import delivery as tdelivery  # noqa: E402
from repro_torch.core import exchange as texchange  # noqa: E402
from repro_torch.core import schedule as tschedule  # noqa: E402
from repro_torch.core.areas import mam_benchmark_spec, ring_area_adjacency  # noqa: E402
from test_torch_event import carry  # noqa: E402
from test_torch_shard_tables import one_rank_world  # noqa: E402,F401

BLOCK_DIAGONAL = np.zeros((8, 8), dtype=bool)
BLOCK_DIAGONAL[:4, :4] = ~np.eye(4, dtype=bool)
BLOCK_DIAGONAL[4:, 4:] = ~np.eye(4, dtype=bool)
BLOCK_DIAGONAL[0, 4] = True  # one pod-crossing edge

# (adjacency, n_groups, build_routing kwargs)
ROUTING_CASES = {
    "ring16 on 8 groups": (np.asarray(jax_ring(16, width=1), bool), 8, {}),
    "all-to-all 16 on 8 groups": (~np.eye(16, dtype=bool), 8, {}),
    "block-diagonal, 2 pods": (BLOCK_DIAGONAL, 8, dict(intra_tier=4)),
    "all-to-all, 2 pods": (~np.eye(8, dtype=bool), 8, dict(intra_tier=4)),
    "ring8 width 2 on 4 groups": (np.asarray(jax_ring(8, width=2), bool), 4, {}),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_build_routing_matches_jax(case):
    """Projection, group graph, rounds (offsets, pairs, per-edge bounds)
    and their order equal the JAX package's; with ``intra_tier`` the rounds
    run group-local, then intra-pod, then pod-crossing, each tier in
    ascending offsets, and ship the same packets as the flat order."""
    adj, groups, kw = ROUTING_CASES[case]
    args = dict(exp_area_spikes=1.0, headroom=8.0, floor=2, **kw)
    got = texchange.build_routing(adj, groups, **args)
    want = jexchange.build_routing(adj, groups, **args)
    assert got.n_groups == want.n_groups
    assert np.array_equal(got.proj, want.proj) and np.array_equal(got.group_adj, want.group_adj)
    assert [dataclasses.astuple(r) for r in got.rounds] == [
        dataclasses.astuple(r) for r in want.rounds]
    assert (got.n_edges, got.n_wire_rounds) == (want.n_edges, want.n_wire_rounds)
    if "intra_tier" in kw:
        tier = kw["intra_tier"]

        def level(rnd):
            if rnd.offset == 0:
                return 0
            return 1 if all(g // tier == h // tier for g, h in rnd.pairs) else 2

        levels = [level(r) for r in got.rounds]
        assert levels == sorted(levels)
        for lv in set(levels):
            offs = [r.offset for r, v in zip(got.rounds, levels) if v == lv]
            assert offs == sorted(offs)
        flat = texchange.build_routing(adj, groups, exp_area_spikes=1.0, headroom=8.0, floor=2)
        assert {dataclasses.astuple(r) for r in flat.rounds} == {
            dataclasses.astuple(r) for r in got.rounds}
    with pytest.raises(ValueError, match="divisible"):
        texchange.build_routing(adj, groups + 1 if adj.shape[0] % (groups + 1) else 3,
                                **args)


def networks(k_inter=4):
    """The sparse-graph network of ``tests/test_exchange.py``'s report
    tests, in both packages (the port's carried from the JAX build)."""
    kw = dict(n_areas=8, n_per_area=64, k_intra=4, k_inter=k_inter)
    jspec = jax_spec(**kw, area_adjacency=jax_ring(8, width=2))
    jnet = jconn.build_network(jspec, seed=12, outgoing=True)
    return jspec, jnet, carry(jnet)


def report(pkg, name, net, adj, backend, schedule):
    """One wire report of ``pkg`` (the JAX or the port exchange module)."""
    common = dict(n_groups=4, gsz=2, headroom=8.0, floor=16)
    exp = (jdelivery if pkg is jexchange else tdelivery).expected_area_spikes(net)
    routing = pkg.build_routing(adj, 4, exp_area_spikes=exp, headroom=8.0, floor=16)
    if name == "routed_wire_bytes":
        return pkg.routed_wire_bytes(net, routing, backend=backend, gsz=2, headroom=8.0,
                                     floor=16)
    if name == "adaptive_wire_bytes dense":
        return pkg.adaptive_wire_bytes(net, backend=backend, schedule=schedule, **common)
    if name == "adaptive_wire_bytes routed":
        return pkg.adaptive_wire_bytes(net, backend=backend, routing=routing, **common)
    if name == "inter_table_report":
        return pkg.inter_table_report(net, schedule=schedule, routing=routing, subgroup=2,
                                      **common)
    if name == "priced_inter_table_report":
        return pkg.priced_inter_table_report(net, schedule=schedule, routing=routing,
                                             subgroup=2, **common)
    return pkg.wire_report(net, adj, backend=backend, n_groups=4, gsz=2)


REPORTS = ("routed_wire_bytes", "adaptive_wire_bytes dense", "adaptive_wire_bytes routed",
           "inter_table_report", "priced_inter_table_report", "wire_report")


@pytest.mark.parametrize("backend", ["event", "scatter"])
@pytest.mark.parametrize("name", REPORTS)
def test_wire_reports_match_jax(name, backend):
    """Every wire report returns the JAX package's dict on the same
    network (the conventional schedule for the dense adaptive model and
    the table reports on ``scatter``); on id packets both ways the sparse
    ring graph ships fewer routed than dense global bytes, in fewer
    rounds."""
    jspec, jnet, tnet = networks()
    adj = jconn.area_adjacency(jnet, jspec)
    schedule = "conventional" if backend == "scatter" else "structure_aware"
    got = report(texchange, name, tnet, adj, backend, schedule)
    want = report(jexchange, name, jnet, adj, backend, schedule)
    assert got == want
    if name == "wire_report" and backend == "event":
        assert got["routed"]["global_bytes"] < got["dense"]["global_bytes"]
        assert got["routed"]["rounds"] < got["routed"]["dense_rounds"]


@pytest.mark.parametrize("source", ["host build", "host-free plan", "no inter"])
def test_area_adjacency_matches_jax(source):
    """The realised adjacency from the global tables, from the host-free
    plan (carried on the network as ``area_adj``), and all-False without
    inter synapses; a cut network is refused."""
    jspec, jnet, tnet = networks(k_inter=0 if source == "no inter" else 4)
    want = jconn.area_adjacency(jnet, jspec)
    if source == "host-free plan":
        spec = mam_benchmark_spec(n_areas=8, n_per_area=64, k_intra=4, k_inter=4,
                                  area_adjacency=ring_area_adjacency(8, width=2))
        plan = tconn.sharded_build_plan(spec, 12, 4, device="cpu")
        tnet = dataclasses.replace(tnet, area_adj=plan.area_adj)
    got = tconn.area_adjacency(tnet)
    assert got.dtype == bool and np.array_equal(got, want)
    if source == "host build":
        assert not want.all()
        with pytest.raises(ValueError, match="global"):
            tconn.area_adjacency(dataclasses.replace(tnet, src_inter=tnet.src_inter[:2]))


# ---------------------------------------------------------------------------
# The plan cache (tests/test_plan_cache.py)
# ---------------------------------------------------------------------------


def plan_spec(**kw):
    kw = {"n_areas": 4, "n_per_area": 64, "k_intra": 8, "k_inter": 12, **kw}
    return mam_benchmark_spec(**kw)


@pytest.fixture
def fresh_memo():
    tconn._PLAN_MEMO.clear()
    yield
    tconn._PLAN_MEMO.clear()


def cache_equals_direct(tmp_path, monkeypatch):
    spec = plan_spec()
    direct = tconn.sharded_build_plan(spec, 12, 2, subgroup=2, device="cpu")
    cached = tconn.cached_sharded_build_plan(spec, 12, 2, subgroup=2, cache_dir=str(tmp_path),
                                             device="cpu")
    assert cached == direct
    files = [f for f in os.listdir(tmp_path) if f.startswith("plan_")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert tconn._plan_from_json(json.load(f)) == direct
    # The same file name as the JAX package's cache would publish.
    jkey = jconn.plan_cache_key(jax_spec(n_areas=4, n_per_area=64, k_intra=8, k_inter=12),
                                12, 2, subgroup=2)
    assert files == [f"plan_{jkey}.json"]


def memo_skips_recompute(tmp_path, monkeypatch):
    spec = plan_spec()
    calls = []
    real = tconn.sharded_build_plan
    monkeypatch.setattr(tconn, "sharded_build_plan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(cache_dir=str(tmp_path), device="cpu")
    p1 = tconn.cached_sharded_build_plan(spec, 12, 2, **kw)
    p2 = tconn.cached_sharded_build_plan(spec, 12, 2, **kw)
    assert p1 == p2 and len(calls) == 1


def disk_cache_shared_across_processes(tmp_path, monkeypatch):
    spec = plan_spec()
    p1 = tconn.cached_sharded_build_plan(spec, 12, 2, cache_dir=str(tmp_path), device="cpu")
    tconn._PLAN_MEMO.clear()  # another process's interpreter
    monkeypatch.setattr(tconn, "sharded_build_plan",
                        lambda *a, **kw: pytest.fail("pass repeated despite the cache file"))
    assert tconn.cached_sharded_build_plan(spec, 12, 2, cache_dir=str(tmp_path)) == p1


def key_separates_layouts(tmp_path, monkeypatch):
    spec = plan_spec()
    k = tconn.plan_cache_key
    base = k(spec, 12, 2)
    assert base == k(spec, 12, 2)
    assert base != k(spec, 13, 2)
    assert base != k(spec, 12, 4)
    assert base != k(spec, 12, 2, subgroup=2)
    assert base != k(spec, 12, 2, size_multiple=8)
    assert base != k(plan_spec(n_per_area=96), 12, 2)
    # The JAX package's key, argument for argument (ring graph included).
    jring = jax_spec(n_areas=4, n_per_area=64, k_intra=8, k_inter=12,
                     area_adjacency=jax_ring(4, width=1))
    ring = plan_spec(area_adjacency=ring_area_adjacency(4, width=1))
    assert k(ring, 12, 4, mode="window", subgroup=2, size_multiple=8) == jconn.plan_cache_key(
        jring, 12, 4, mode="window", subgroup=2, size_multiple=8)


def nonzero_process_times_out_without_publisher(tmp_path, monkeypatch):
    spec = plan_spec()
    monkeypatch.setattr(tconn, "_world", lambda: (1, 2))
    with pytest.raises(TimeoutError, match="REPRO_PLAN_CACHE"):
        tconn.cached_sharded_build_plan(spec, 12, 2, cache_dir=str(tmp_path), wait_s=0.5)


def env_var_names_the_cache_dir(tmp_path, monkeypatch):
    spec = plan_spec()
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    tconn.cached_sharded_build_plan(spec, 12, 2, device="cpu")
    assert any(f.startswith("plan_") for f in os.listdir(tmp_path))


PLAN_CACHE_CASES = {f.__name__: f for f in (
    cache_equals_direct, memo_skips_recompute, disk_cache_shared_across_processes,
    key_separates_layouts, nonzero_process_times_out_without_publisher,
    env_var_names_the_cache_dir)}


@pytest.mark.parametrize("case", list(PLAN_CACHE_CASES))
def test_plan_cache(case, tmp_path, monkeypatch, fresh_memo):
    """The six cases of ``tests/test_plan_cache.py`` on the port's cache:
    the cached plan is the direct one and its JSON round-trips it under the
    JAX package's key, the memo and the file each skip the counting pass,
    the key separates layouts, a non-zero rank times out naming
    ``REPRO_PLAN_CACHE`` without a publisher (it waits only in a world of
    several ranks), and the environment variable names the directory."""
    PLAN_CACHE_CASES[case](tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# The routed config rules (tests/test_exchange.py:374-428)
# ---------------------------------------------------------------------------


def test_routed_config_refusals():
    """``'routed'`` is a listed exchange the config accepts; it needs the
    structure-aware schedule, and an unknown exchange is refused, with the
    JAX package's violations."""
    from repro.core.engine import ConfigError as JaxConfigError
    from repro.core.engine import EngineConfig as JaxConfig

    from repro_torch.core import EXCHANGES, ConfigError, EngineConfig

    assert "routed" in EXCHANGES
    assert EngineConfig(exchange="routed", delivery_backend="event").exchange == "routed"
    for kw in (dict(schedule="conventional", exchange="routed"), dict(exchange="mesh")):
        with pytest.raises(ConfigError) as got:
            EngineConfig(**kw)
        with pytest.raises(JaxConfigError) as want:
            JaxConfig(**kw)
        assert ([dataclasses.astuple(v) for v in got.value.violations]
                == [dataclasses.astuple(v) for v in want.value.violations])


def test_routed_on_a_one_rank_mesh(one_rank_world):
    """A (1, 1) mesh degenerates routing to the group-local round (no
    ppermute): bitwise the single-host engine, overflow 0. Without
    outgoing tables the routed engine still builds (its inbound slices are
    cut from the incoming tables) unless the replicated layout is asked
    for; a dense exchange needs a mesh."""
    from repro_torch.core import EngineConfig, ProcessMesh, make_simulation

    spec = mam_benchmark_spec(n_areas=4, n_per_area=32, k_intra=4, k_inter=4, rate_hz=30.0)
    net = tconn.build_network(spec, seed=12, size_multiple=8, outgoing=True, device="cpu")
    mesh = ProcessMesh((1, 1), ("data", "model"), device="cpu")
    ref = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire",
                                             schedule="conventional"), net=net, device="cpu")
    eng = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire", exchange="routed",
                                             s_max_floor=32), net=net, mesh=mesh)
    assert eng.wire_bytes["exchange"] == "routed"
    s0, st = ref.init(), eng.init()
    spikes = 0
    for w in range(6):
        s0, blk_ref = ref.window(s0)
        st, blk = eng.window(st)
        assert torch.equal(blk.bool(), blk_ref.bool()), w
        spikes += int(blk.sum())
    assert spikes > 0 and torch.equal(st.ring, s0.ring) and int(st.overflow) == 0
    lean = tconn.build_network(spec, seed=12, size_multiple=8, device="cpu")
    with pytest.raises(ValueError, match="outgoing"):
        make_simulation(spec, EngineConfig(exchange="routed", shard_inter_tables=False),
                        net=lean, mesh=mesh)
    eng = make_simulation(spec, EngineConfig(exchange="routed"), net=lean, mesh=mesh)
    assert eng.wire_bytes["exchange"] == "routed"
    with pytest.raises(ValueError, match="mesh"):
        make_simulation(spec, EngineConfig(exchange="dense"), net=net, device="cpu")


def test_permute_areas_matches_jax():
    """Elastic resume's area re-order (``_permute_areas``) moves every
    area-keyed leaf's rows as the JAX package's does, and no scalar."""
    from repro.core import neuron as jneuron
    from repro.core import schedule as jschedule

    from repro_torch.core import neuron as tneuron

    rng = np.random.default_rng(5)
    leaves = {k: rng.integers(0, 9, (4, 8, *tail)).astype(np.int32)
              for k, tail in (("countdown", ()), ("ring", (3,)), ("spike_count", ()))}
    order = np.array([2, 0, 3, 1])
    got = tschedule._permute_areas(tschedule.SimState(
        neuron=tneuron.IafState(countdown=torch.from_numpy(leaves["countdown"])),
        ring=torch.from_numpy(leaves["ring"]), t=30,
        spike_count=torch.from_numpy(leaves["spike_count"]), overflow=4), order)
    want = jschedule._permute_areas(jschedule.SimState(
        neuron=jneuron.IafState(countdown=leaves["countdown"]), ring=leaves["ring"],
        t=np.int32(30), spike_count=leaves["spike_count"], overflow=np.int32(4)), order)
    assert np.array_equal(got.ring.numpy(), np.asarray(want.ring))
    assert np.array_equal(got.spike_count.numpy(), np.asarray(want.spike_count))
    assert np.array_equal(got.neuron.countdown.numpy(), np.asarray(want.neuron.countdown))
    assert not np.array_equal(np.asarray(want.ring), leaves["ring"])
    assert got.t == 30 and got.overflow == 4
