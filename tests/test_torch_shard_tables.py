"""The port's placement helpers, per-shard table cuts and host-free build
against the JAX package's, array for array, on the CPU.

Fixtures follow ``tests/test_build_sharded.py`` and
``tests/test_tables_subgroup.py`` (4 areas x 64 neurons, K 8/12, and
variants: ghost rows, int32 delays, a sparse area graph, no inter
pathway). Tolerance: bitwise, dtypes included. The refusals of a pre-cut
network that does not match the mesh run in a one-rank gloo world in this
process.
"""

import dataclasses
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import connectivity as jconn  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core.areas import mam_benchmark_spec as jax_spec  # noqa: E402
from repro.core.areas import ring_area_adjacency as jax_ring  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import dist_engine  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.areas import mam_benchmark_spec  # noqa: E402
from repro_torch.core.areas import ring_area_adjacency  # noqa: E402

BASE = dict(n_areas=4, n_per_area=64, k_intra=8, k_inter=12)
FIXTURES = {
    "bench": (BASE, 8),
    "ghost_rows": (dict(BASE, n_per_area=37), 8),
    "int32_delays": (dict(BASE, delay_inter_max_ms=20.0), 8),
    "sparse_graph": (dict(BASE, n_areas=8, n_per_area=32, k_intra=4, k_inter=6), 8),
    "no_inter": (dict(BASE, n_areas=2, k_inter=0), 8),
}
INBOUND = ("tgt_inter_in", "wout_inter_in", "dout_inter_in")
OUT_INTRA = ("tgt_intra", "wout_intra", "dout_intra")


def specs(name):
    kw, mult = FIXTURES[name]
    kw = dict(kw)
    delay = kw.pop("delay_inter_max_ms", None)
    if name == "sparse_graph":
        pair = (jax_spec(**kw, area_adjacency=jax_ring(8, width=2)),
                mam_benchmark_spec(**kw, area_adjacency=ring_area_adjacency(8, width=2)))
    else:
        pair = jax_spec(**kw), mam_benchmark_spec(**kw)
    if delay is not None:
        pair = tuple(dataclasses.replace(s, delay_inter_max_ms=delay) for s in pair)
    return (*pair, mult)


def same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert np.array_equal(got, want), what


def networks(name):
    js, ts, mult = specs(name)
    jnet = jconn.build_network(js, seed=12, size_multiple=mult, outgoing=True)
    tnet = tconn.build_network(ts, seed=12, size_multiple=mult, outgoing=True, device="cpu")
    return js, ts, mult, jnet, tnet


# ---------------------------------------------------------------------------
# Placement (core/partition.py)
# ---------------------------------------------------------------------------


def test_partition_matches_jax():
    """Row ownership, both placements and the elastic plan helpers."""
    for mode, S, sub in (("group", 2, 1), ("group", 2, 2), ("group", 4, 4), ("window", 4, 1)):
        for s in range(S):
            for lane in range(sub):
                same(tpart.shard_pathway_rows(mode, s, S, 4, 32, subgroup=sub, lane=lane),
                     jpart.shard_pathway_rows(mode, s, S, 4, 32, subgroup=sub, lane=lane),
                     (mode, s, lane))
    with pytest.raises(ValueError, match="inter_shard_mode"):
        tpart.shard_pathway_rows("bogus", 0, 1, 4, 32)
    js, ts, _ = specs("ghost_rows")
    rr = tpart.round_robin_placement(ts, 3), jpart.round_robin_placement(js, 3)
    assert dataclasses.asdict(rr[0]) == dataclasses.asdict(rr[1])
    assert rr[0].max_neurons_per_proc == rr[1].max_neurons_per_proc
    assert [rr[0].neurons_on(p) for p in range(3)] == [rr[1].neurons_on(p) for p in range(3)]
    for groups, gsz in ((2, 1), (4, 2), (1, 4)):
        t = tpart.structure_aware_placement(ts, groups, gsz, size_multiple=8)
        j = jpart.structure_aware_placement(js, groups, gsz, size_multiple=8)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.load_imbalance(), t.ghost_fraction) == (j.load_imbalance(), j.ghost_fraction)
        for new in (1, 2, 4):
            tp, jp = tpart.elastic_reshard_plan(t, new), jpart.elastic_reshard_plan(j, new)
            assert tp == jp
            same(tpart.reshard_area_order(tp), jpart.reshard_area_order(jp), (groups, new))
            assert tpart.reshard_moves(tp) == jpart.reshard_moves(jp)
    with pytest.raises(ValueError, match="divisible"):
        tpart.structure_aware_placement(ts, 3)
    with pytest.raises(ValueError, match="rebalance"):
        tpart.elastic_reshard_plan(t, 3)
    t = tpart.placement_from_sizes([10, 20, 30, 40], 2, n_pad=48, group_size=2)
    assert dataclasses.asdict(t) == dataclasses.asdict(
        jpart.placement_from_sizes([10, 20, 30, 40], 2, n_pad=48, group_size=2))


# ---------------------------------------------------------------------------
# Per-shard cuts of a host-built network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shard_and_slice_tables_match_jax(name):
    """``shard_inter_tables`` (group with and without a subgroup, window)
    and ``slice_intra_tables``, leaf for leaf."""
    js, ts, mult, jnet, tnet = networks(name)
    A = js.n_areas
    for mode, S, sub in (("group", A // 2, 1), ("group", A // 2, 2), ("group", A, 4),
                         ("window", 4, 1), ("window", 8, 1)):
        j = jconn.shard_inter_tables(jnet, S, mode=mode, subgroup=sub)
        t = tconn.shard_inter_tables(tnet, S, mode=mode, subgroup=sub)
        assert t.inter_shard_mode == j.inter_shard_mode == mode
        for f in INBOUND:
            if getattr(j, f) is None:
                assert getattr(t, f) is None
            else:
                same(getattr(t, f), getattr(j, f), (mode, S, sub, f))
        assert (t.tgt_inter is None) == (j.tgt_inter is None)
    for sub in (2, 4):
        j, t = jconn.slice_intra_tables(jnet, sub), tconn.slice_intra_tables(tnet, sub)
        for f in OUT_INTRA:
            same(getattr(t, f), getattr(j, f), (sub, f))
    # Built from the incoming tensors alone: no outgoing tables needed.
    lean = tconn.build_network(ts, seed=12, size_multiple=mult, device="cpu")
    if lean.k_inter:
        same(tconn.shard_inter_tables(lean, 2).tgt_inter_in,
             jconn.shard_inter_tables(jnet, 2).tgt_inter_in, "lean")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_sharded_build_matches_jax(name):
    """The plan (every field) and pass 2 -- ``build_shard_tables`` per
    (shard, lane), ``build_group_intra_tables`` and
    ``build_lane_intra_tables`` -- equal to the JAX package's, which equal
    the host-built network's cuts."""
    js, ts, mult, _, _ = networks(name)
    A = js.n_areas
    for mode, S, sub in (("group", A // 2, 1), ("group", A // 2, 2), ("window", 4, 1)):
        jp = jconn.sharded_build_plan(js, 12, S, mode=mode, subgroup=sub, size_multiple=mult)
        tp = tconn.sharded_build_plan(ts, 12, S, mode=mode, subgroup=sub, size_multiple=mult,
                                      device="cpu", chunk_rows=48)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp), (mode, S, sub)
        for s in range(S):
            for lane in range(sub):
                for a, b in zip(tconn.build_shard_tables(ts, 12, s, plan=tp, lane=lane,
                                                         device="cpu", chunk_rows=40),
                                jconn.build_shard_tables(js, 12, s, plan=jp, lane=lane)):
                    same(a, b, ("shard", mode, s, lane))
        areas = np.arange(A // S if mode == "group" else A)
        if sub > 1:
            for lane in range(sub):
                for a, b in zip(tconn.build_lane_intra_tables(ts, 12, areas, lane, plan=tp,
                                                              device="cpu", chunk_rows=7),
                                jconn.build_lane_intra_tables(js, 12, areas, lane, plan=jp)):
                    same(a, b, ("lane", lane))
        for a, b in zip(tconn.build_group_intra_tables(ts, 12, areas, plan=tp, device="cpu"),
                        jconn.build_group_intra_tables(js, 12, areas, plan=jp)):
            same(a, b, "group intra")


def test_cut_refusals():
    """The JAX package's refusals: a shard count that does not divide, a
    subgroup off the group mode or not dividing ``n_pad``, an unknown mode,
    slicing twice."""
    js, ts, _, jnet, tnet = networks("bench")
    for fn, net in ((jconn.shard_inter_tables, jnet), (tconn.shard_inter_tables, tnet)):
        with pytest.raises(ValueError, match="divisible"):
            fn(net, 3, mode="group")
        with pytest.raises(ValueError):
            fn(net, 4, mode="window", subgroup=2)
        with pytest.raises(ValueError):
            fn(net, 2, mode="group", subgroup=7)
    for spec, plan in ((js, jconn.sharded_build_plan),
                       (ts, lambda *a, **k: tconn.sharded_build_plan(*a, device="cpu", **k))):
        with pytest.raises(ValueError):
            plan(spec, 12, 3, mode="group")
        with pytest.raises(ValueError):
            plan(spec, 12, 2, mode="bogus")
        with pytest.raises(ValueError):
            plan(spec, 12, 2, mode="window", subgroup=2)
    cut = tconn.slice_intra_tables(tnet, 2)
    with pytest.raises(ValueError, match="already"):
        tconn.slice_intra_tables(cut, 2)
    with pytest.raises(ValueError):
        tconn.slice_intra_tables(tnet, 7)
    with pytest.raises(ValueError, match="unsharded"):
        tconn.tile_network(tconn.shard_inter_tables(tnet, 2), 2)


@pytest.fixture
def one_rank_world(tmp_path):
    """A one-rank gloo world in this process, torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_process_mesh_rules(one_rank_world, monkeypatch):
    """A mesh needs an initialised world of its size and distinct axis
    names; its default device is the GPU, which it refuses to fall back
    from; a one-rank mesh sits at the origin with every group of size 1,
    one over each subset of its axes in the mesh's order."""
    from repro_torch.core import ProcessMesh

    mesh = ProcessMesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert mesh.shape == {"pod": 1, "data": 1, "model": 1} and mesh.size == 1
    assert [mesh.axis_index(a) for a in mesh.axis_names] == [0, 0, 0]
    assert mesh.extent(("pod", "data")) == 1 and mesh.group("model") is not None
    assert mesh.group(("pod", "data")) is not None and mesh.group(("pod", "model")) is not None
    with pytest.raises(ValueError, match="no process group"):
        mesh.group(("data", "pod"))  # a subset out of the mesh's order
    with pytest.raises(ValueError, match="positions"):
        ProcessMesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="repeated"):
        ProcessMesh((1, 1), ("data", "data"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProcessMesh((1, 1), ("data", "model"))


def test_mismatched_cuts_are_refused_at_engine_build(one_rank_world):
    """``tests/test_exchange.py:277`` and ``tests/test_tables_subgroup.py``:
    pre-cut inbound tables whose shard count, mode or lane count does not
    match the mesh are refused when the engine is built, not misdelivered."""
    from repro_torch.core import EngineConfig, ProcessMesh, make_simulation

    spec = mam_benchmark_spec(n_areas=4, n_per_area=32, k_intra=4, k_inter=4)
    net = tconn.build_network(spec, seed=12, size_multiple=8, outgoing=True, device="cpu")
    mesh = ProcessMesh((1, 1), ("data", "model"), device="cpu")
    cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event")
    for bad in (tconn.shard_inter_tables(net, 2),
                tconn.shard_inter_tables(net, 1, mode="window"),
                tconn.shard_inter_tables(net, 1, mode="group", subgroup=2)):
        with pytest.raises(ValueError, match="do not match the"):
            make_simulation(spec, cfg, net=bad, mesh=mesh)
    with pytest.raises(ValueError, match="do not match the mesh subgroup"):
        make_simulation(spec, cfg, net=tconn.slice_intra_tables(net, 2), mesh=mesh)
    with pytest.raises(ValueError, match="outgoing=True"):
        make_simulation(spec, cfg, net=tconn.build_network(spec, seed=12, device="cpu"),
                        mesh=mesh)
    # The matching cut is accepted, and runs as the uncut network does.
    ok = make_simulation(spec, cfg, net=tconn.shard_inter_tables(net, 1), mesh=mesh)
    ref = make_simulation(spec, cfg, net=net, device="cpu")
    a, b = ok.init(), ref.init()
    for _ in range(3):
        a, x = ok.window(a)
        b, y = ref.window(b)
        assert torch.equal(ok.gather_block(x), y)
    assert torch.equal(ok.gather_state(a).ring, b.ring)


@pytest.mark.parametrize("layout", ["replicated_intra", "group_inter", "replicated_inter"])
def test_receive_tables_of_replicated_layouts_keep_rows_ascending(layout):
    """The event kernel needs each table row ascending with its ``-1``
    padding last. A rank of a replicated layout (outgoing intra tables
    holding the whole group's targets, or inter tables holding other
    lanes' or groups' targets) keeps that order: its receive table drops
    the foreign synapses and compacts each row. It equals the lane cut of
    the table, targets mapped to the rank's ring rows."""
    _, ts, _, _, net = networks("bench")
    A, n_pad, gsz = net.n_areas, net.n_pad, 2
    n_loc = n_pad // gsz
    c = dist_engine._Cut(aoff=2, a_loc=2, noff=n_loc, n_loc=n_loc, shard=1, lane=1)
    if layout == "replicated_intra":
        x = [getattr(net, f)[2:4].reshape(2 * n_pad, -1) for f in OUT_INTRA]
        cut = [getattr(tconn.slice_intra_tables(net, gsz), f)[1, 2:4].reshape(2 * n_pad, -1)
               for f in OUT_INTRA]
        want_tgt = torch.where(cut[0] >= 0, cut[0] - n_loc
                               + (torch.arange(2 * n_pad) // n_pad * n_loc)[:, None], -1)
    else:
        full = (tconn.shard_inter_tables(net, 2) if layout == "group_inter"
                else dataclasses.replace(net, tgt_inter_in=torch.stack(
                    [net.tgt_inter.reshape(A * n_pad, -1)] * 2), wout_inter_in=torch.stack(
                    [net.wout_inter.reshape(A * n_pad, -1)] * 2), dout_inter_in=torch.stack(
                    [net.dout_inter.reshape(A * n_pad, -1)] * 2)))
        x = [getattr(full, f)[1] for f in INBOUND]
        cut = [getattr(tconn.shard_inter_tables(net, 2, subgroup=gsz), f)[1, 1] for f in INBOUND]
        t = cut[0].long()
        want_tgt = torch.where(t >= 0, (t // n_pad - 2) * n_loc + t % n_pad - n_loc, -1)
    assert bool(((x[0] >= 0) & ((x[0] < 0).cumsum(1) > 0)).any()) is False
    got = dist_engine._receive_tables(*x, c, n_pad, intra=layout == "replicated_intra")
    k = got.tgt.shape[1]
    assert k == int((cut[0] >= 0).sum(1).max())
    same(got.tgt, want_tgt[:, :k].to(torch.int32), "tgt")
    same(got.w, cut[1][:, :k].contiguous(), "w")
    same(got.d, cut[2][:, :k].contiguous(), "d")
    key = got.tgt.long() & 0xFFFFFFFF
    assert not bool((key[:, 1:] < key[:, :-1]).any()), "a row breaks the kernel's order"
    assert bool((x[0] >= 0).sum() > (got.tgt >= 0).sum()), "the layout held foreign targets"
