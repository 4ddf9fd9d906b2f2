"""The port's distributed engine on gloo worlds of CPU processes, against the
JAX package's engines.

The cases of ``tests/test_distributed.py:30-129`` and of the dense rows of
``tests/test_exchange.py`` / ``tests/test_tables_subgroup.py``: a
``(4, 2)`` (data, model) world and a ``(2, 2, 2)`` (pod, data, model) world
run ``mam_benchmark_spec(4, 32, 4, 4)`` on every delivery backend under both
schedules, on superstep and legacy windows, with static, adaptive and
overlapped exchanges, per-trial drive leaves, replicated table layouts and
the host-free sharded build. Every rank gathers the whole network's blocks
and state (``Engine.gather_block`` / ``gather_state``); the reference is the
JAX single-host engine, run in the test process. Tolerance: bitwise for
blocks, rings, neuron state and spike counts after every window, overflow
0; ``shipped_bytes`` equals the JAX package's ``dense_wire_bytes`` times
the windows, and so do the bytes that ``comm`` counts the exchange's
collectives taking in. A forced-overflow run is held to the JAX distributed engine on
8 forced host devices (a subprocess, as the reference tests run it).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.areas import ring_area_adjacency  # noqa: E402
from test_torch_comm import ROOT, run_world  # noqa: E402

SIZE = dict(n_areas=4, n_per_area=32, k_intra=4, k_inter=4, rate_hz=30.0)
# A directed ring of areas: on four area groups the routed exchange has one
# wire round where the dense exchange gathers over all groups.
RING_SIZE = dict(SIZE, area_adjacency=ring_area_adjacency(4, width=1))
# The ring plus one edge 0 -> 2: at offset 2 three groups receive nothing,
# so their ppermute slot must hold the fill id (id 0 is a real neuron).
SKEW_SIZE = dict(SIZE, area_adjacency=((0, 1, 1, 0), (0, 0, 1, 0), (0, 0, 0, 1), (1, 0, 0, 0)))
GRAPHS = {"all": SIZE, "ring": RING_SIZE, "skew": SKEW_SIZE}
MODELS = ("ignore_and_fire", "lif")
SCHEDULES = ("structure_aware", "conventional")
BACKENDS = ("onehot", "scatter", "pallas", "event")
WINDOWS = 6
FLOOR = 32


def grid_cases():
    """``(name, model, EngineConfig kwargs)`` of the backend x schedule grid
    and its window and exchange variants."""
    cases = []
    for model in MODELS:
        for backend in BACKENDS:
            for sched in SCHEDULES:
                cases.append((model, dict(delivery_backend=backend, schedule=sched)))
            cases.append((model, dict(delivery_backend=backend, superstep=False)))
        for kw in (dict(adaptive_exchange=True), dict(adaptive_exchange=True, superstep=False),
                   dict(adaptive_exchange=True, schedule="conventional"),
                   dict(overlap_exchange=True), dict(overlap_exchange=True, superstep=False),
                   dict(overlap_exchange=True, adaptive_exchange=True)):
            cases.append((model, dict(delivery_backend="event", **kw)))
        cases.append((model, dict(delivery_backend="pallas", overlap_exchange=True)))
    cases.append(("lif", dict(delivery_backend="scatter", fused_update=True)))
    return [(f"{m} " + " ".join(f"{k}={v}" for k, v in kw.items()), m, kw) for m, kw in cases]


# The routed exchange on the ring network: every backend on superstep and
# legacy windows, static, adaptive and overlapped packets, and LIF.
ROUTED_CASES = [("ignore_and_fire", dict(delivery_backend=b, **kw)) for b in BACKENDS
                for kw in (dict(), dict(superstep=False), dict(adaptive_exchange=True),
                           dict(overlap_exchange=True))] + [
    ("ignore_and_fire", dict(delivery_backend="event", adaptive_exchange=True,
                             overlap_exchange=True)),
    ("lif", dict(delivery_backend="event")),
    ("lif", dict(delivery_backend="pallas", adaptive_exchange=True, overlap_exchange=True)),
]
# The run loop's engine: routed event packets, whose static spills count.
LOOP_CFG = dict(neuron_model="ignore_and_fire", delivery_backend="event", exchange="routed",
                s_max_floor=FLOOR)


def routed_name(model, kw):
    return f"{model} " + " ".join(f"{k}={v}" for k, v in kw.items())


def snapshot(state) -> dict:
    """A whole-network state's leaves as numpy (either package)."""
    def np_(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    neuron = state.neuron
    names = (neuron._fields if hasattr(neuron, "_fields")
             else [f.name for f in dataclasses.fields(neuron)])
    out = {"ring": np_(state.ring), "spike_count": np_(state.spike_count), "t": int(state.t)}
    out.update({n: np_(getattr(neuron, n)) for n in names})
    return out


def drive(eng, windows, *, init_kw=None):
    """Run ``windows`` windows of a port engine (through the overlapped
    pipeline where it has one, drained at the end); every window's whole
    block and state, gathered on every rank. A pipelined state still lacks
    its window's long-range deposits, so the pipeline records only the
    final, drained state (None before it). ``received`` is the mesh-total
    bytes that the exchange's collectives took in, as ``comm`` counts them."""
    from repro_torch.core import comm

    st = eng.init(**(init_kw or {}))
    comm.reset_stats()
    blocks, states = [], []
    inflight = eng.init_inflight() if eng.window_overlap is not None else None
    for w in range(windows):
        if inflight is not None:
            st, inflight, blk = eng.window_overlap(st, inflight)
            if w == windows - 1:
                st = eng.drain(st, inflight)
        else:
            st, blk = eng.window(st)
        blocks.append(eng.gather_block(blk).cpu().numpy())
        pending = inflight is not None and w < windows - 1
        states.append(None if pending else snapshot(eng.gather_state(st)))
    mine = torch.tensor([float(comm.wire_received())], dtype=torch.float64)
    received = float(comm.all_reduce(mine, eng.mesh, eng.mesh.axis_names)[0])
    return dict(blocks=blocks, states=states, overflow=int(st.overflow),
                shipped=float(st.shipped_bytes), received=received, wire_bytes=eng.wire_bytes)


def host_network(payload):
    from repro_torch.core.connectivity import network_from_numpy

    return network_from_numpy(payload["arrays"], device="cpu", **payload["static"])


def world_grid(mesh, payload):
    """The backend x schedule grid on this rank; rank 0 returns the results."""
    from repro_torch.core import EngineConfig, make_simulation, mam_benchmark_spec

    spec = mam_benchmark_spec(**payload["size"])
    net = host_network(payload)
    out = {}
    for name, model, kw in grid_cases():
        cfg = EngineConfig(neuron_model=model, s_max_floor=FLOOR, **kw)
        out[name] = drive(make_simulation(spec, cfg, net=net, mesh=mesh), WINDOWS)
    # Per-trial drive leaves: a seed and a per-neuron stimulus.
    eng = make_simulation(spec, EngineConfig(delivery_backend="scatter", s_max_floor=FLOOR),
                          net=net, mesh=mesh, trial_leaves=True)
    out["trial_leaves"] = drive(eng, WINDOWS, init_kw=dict(seed=7, stim=payload["stim"]))
    # Engine.run: the whole network's spikes per window, on every rank.
    for sched in SCHEDULES:
        eng = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire", schedule=sched,
                                                 delivery_backend="event", s_max_floor=FLOOR),
                              net=net, mesh=mesh)
        st, totals = eng.run(eng.init(), WINDOWS)
        out[f"run {sched}"] = (totals.tolist(), int(st.t))
    out.update(world_routed(mesh, payload["ring"], ROUTED_CASES))
    out.update(world_loop(mesh, payload))
    return out if mesh.rank == 0 else {"stopped at": out["stopped at"]}


def world_routed(mesh, payload, cases):
    """The routed exchange on ``payload``'s network, every case in ``cases``."""
    from repro_torch.core import EngineConfig, make_simulation, mam_benchmark_spec

    spec = mam_benchmark_spec(**payload["size"])
    net = host_network(payload)
    return {f"routed {routed_name(model, kw)}": drive(make_simulation(
        spec, EngineConfig(neuron_model=model, exchange="routed", s_max_floor=FLOOR, **kw),
        net=net, mesh=mesh), WINDOWS) for model, kw in cases}


def world_loop(mesh, payload):
    """``run_windows`` / ``SimCheckpointer`` / ``restore_sim`` on the mesh,
    on the ring network's routed event engine: the uninterrupted loop, a
    run preempted after window 3 and resumed on this mesh and on a (2, 4)
    one (an elastic reshard from 4 groups to 2), the JAX single host's
    checkpoint resumed here (1 group to 4), and a stop asked on rank 0
    only. Returns whole-network results (every rank's stop window)."""
    from repro_torch.core import EngineConfig, ProcessMesh, make_simulation, mam_benchmark_spec
    from repro_torch.core import faults as faults_lib
    from repro_torch.core import schedule as schedule_lib

    ring = payload["ring"]
    spec = mam_benchmark_spec(**ring["size"])
    net = host_network(ring)
    cfg = EngineConfig(**LOOP_CFG)
    eng = make_simulation(spec, cfg, net=net, mesh=mesh)
    blocks = []
    res = schedule_lib.run_windows(eng, eng.init(), WINDOWS,
                                   on_block=lambda w, b: blocks.append(b.numpy()))
    out = {"loop spikes": res.spikes_per_window.tolist(), "loop blocks": blocks,
           "loop final": snapshot(eng.gather_state(res.state))}
    ckdir = payload["ckpt_dir"]
    ckpt = schedule_lib.SimCheckpointer(ckdir, eng, net, every=2)
    preempt = faults_lib.FaultConfig(preempt_after_window=3)
    try:
        schedule_lib.run_windows(eng, eng.init(), WINDOWS, checkpointer=ckpt, faults=preempt)
        raise AssertionError("the injected preemption did not stop the loop")
    except faults_lib.Preempted as exc:
        out["preempted at"] = exc.window
    resumes = (("same mesh", mesh, ckdir),
               ("elastic", ProcessMesh((2, 4), ("data", "model"), device="cpu"), ckdir),
               ("from jax", mesh, payload["jax_ckpt_dir"]))
    for name, m, directory in resumes:
        e = make_simulation(spec, cfg, net=net, mesh=m)
        st, info = schedule_lib.restore_sim(directory, e, net)
        res = schedule_lib.run_windows(e, st, WINDOWS - info["step"])
        out[f"resumed {name}"] = (snapshot(e.gather_state(res.state)), info["reshard"],
                                  int(res.state.overflow))
    asked = []

    def stop():
        asked.append(1)
        return mesh.rank == 0 and len(asked) >= 2  # rank 0 alone, after window 2

    try:
        schedule_lib.run_windows(eng, eng.init(), WINDOWS, stop_requested=stop)
        out["stopped at"] = None
    except faults_lib.Preempted as exc:
        out["stopped at"] = exc.window
    out["rank"] = mesh.rank
    return out


@functools.lru_cache(maxsize=None)
def jax_setup(graph: str = "all"):
    from repro.core.areas import mam_benchmark_spec as jax_spec
    from repro.core.connectivity import build_network as jax_build

    spec = jax_spec(**GRAPHS[graph])
    return spec, jax_build(spec, seed=12, size_multiple=8, outgoing=True)


def payload_of(jnet, size=SIZE, **extra):
    from test_torch_event import OUT, STATIC, TABLES

    return dict(size=size, arrays={f: (None if getattr(jnet, f) is None else
                                       np.asarray(getattr(jnet, f))) for f in TABLES + OUT},
                static={f: getattr(jnet, f) for f in STATIC}, **extra)


def graph_payload(graph: str):
    return payload_of(jax_setup(graph)[1], GRAPHS[graph])


@functools.lru_cache(maxsize=None)
def jax_reference(model, schedule, seed=None, stim_seed=None, graph="all"):
    """Every window's block and state of the JAX single-host engine."""
    from repro.core.engine import EngineConfig as JaxConfig
    from repro.core.factory import make_simulation as jax_make

    spec, net = jax_setup(graph)
    eng = jax_make(spec, JaxConfig(neuron_model=model, schedule=schedule,
                                   delivery_backend="scatter"), net=net)
    st = (eng.init() if seed is None
          else eng.init(seed=seed, stim=stim_array(stim_seed)))
    blocks, states = [], []
    for _ in range(WINDOWS):
        st, blk = eng.window(st)
        blocks.append(np.asarray(blk))
        states.append(snapshot(st))
    return blocks, states


def stim_array(seed):
    rng = np.random.default_rng(seed)
    return (0.5 + rng.random((SIZE["n_areas"], 32))).astype(np.float32)


def assert_trajectory(got, ref, what):
    blocks, states = ref
    assert sum(int(b.sum()) for b in blocks) > 0, what
    for w in range(WINDOWS):
        assert np.array_equal(got["blocks"][w].astype(bool), blocks[w].astype(bool)), (what, w)
        if got["states"][w] is None:
            continue
        for k, want in states[w].items():
            have = got["states"][w][k]
            assert np.array_equal(np.asarray(have), want), (what, w, k)
    assert got["overflow"] == 0, what


def jax_wire_bytes(kw, *, graph=None, n_groups=4, gsz=2):
    """The JAX package's ``Engine.wire_bytes`` for ``kw`` on an ``n_groups x
    gsz`` mesh: its dense or routed accounting with the adaptive model (the
    round order a multi-pod mesh gives changes no byte)."""
    from repro.core import delivery as jdelivery
    from repro.core import exchange as jexchange
    from repro.core.connectivity import area_adjacency

    jspec, jnet = jax_setup(graph or "all")
    backend = kw.get("delivery_backend", "onehot")
    sched = kw.get("schedule", "structure_aware")
    common = dict(headroom=8.0, floor=FLOOR, gsz=gsz)
    adaptive = dict(backend=backend, schedule=sched, n_groups=n_groups, **common)
    if graph is None:
        rep = jexchange.dense_wire_bytes(jnet, **adaptive)
        rep["adaptive"] = jexchange.adaptive_wire_bytes(jnet, **adaptive)
    else:
        routing = jexchange.build_routing(
            area_adjacency(jnet, jspec), n_groups, headroom=8.0, floor=FLOOR,
            exp_area_spikes=jdelivery.expected_area_spikes(jnet))
        rep = jexchange.routed_wire_bytes(jnet, routing, backend=backend, **common)
        rep["adaptive"] = jexchange.adaptive_wire_bytes(jnet, routing=routing, **adaptive)
    rep["adaptive_on"] = bool(kw.get("adaptive_exchange"))
    return rep


def test_dist_engine_grid_on_a_4x2_world(tmp_path):
    """Every backend x both schedules, superstep and legacy windows,
    adaptive and overlapped exchanges, ``fused_update`` and per-trial
    leaves on a (4, 2) world: bitwise the JAX single-host engine after
    every window; static runs ship exactly ``dense_wire_bytes`` a window,
    and the engine reports that accounting (the adaptive model included);
    ``Engine.run`` returns the whole network's spikes per window. The
    routed exchange on the ring network does the same on every backend and
    window form, and the run loop runs on the mesh (``check_loop``)."""
    spec, jnet = jax_setup()
    jax_ckpt = jax_checkpoint(tmp_path / "jax_ckpt")
    results = run_world(tmp_path, (4, 2), ("data", "model"), "test_torch_dist_engine:world_grid",
                        payload_of(jnet, stim=stim_array(3), ring=graph_payload("ring"),
                                   ckpt_dir=str(tmp_path / "ckpt"), jax_ckpt_dir=jax_ckpt))
    got = results[0]
    for name, model, kw in grid_cases():
        sched = kw.get("schedule", "structure_aware")
        assert_trajectory(got[name], jax_reference(model, sched), name)
        wb = jax_wire_bytes(kw)
        assert got[name]["wire_bytes"] == wb, name
        if not kw.get("adaptive_exchange"):
            assert got[name]["shipped"] == WINDOWS * wb["total_bytes"] > 0, name
            assert got[name]["received"] == got[name]["shipped"], name
    assert_trajectory(got["trial_leaves"], jax_reference("lif", "structure_aware", 7, 3),
                      "trial_leaves")
    want = [int(b.sum()) for b in jax_reference("ignore_and_fire", "structure_aware")[0]]
    for sched in SCHEDULES:
        assert got[f"run {sched}"] == (want, WINDOWS * jnet.delay_ratio), sched
    check_routed(got, ROUTED_CASES, "ring")
    check_loop(got, [r["stopped at"] for r in results], tmp_path / "ckpt")


def check_routed(got, cases, graph):
    """Every routed case bitwise the JAX single-host engine on ``graph``'s
    network, overflow 0, its accounting the JAX package's; static runs ship
    ``routed_wire_bytes`` a window, in one wire round (ring) or two (skew)
    against the dense exchange's three."""
    for model, kw in cases:
        name = f"routed {routed_name(model, kw)}"
        assert_trajectory(got[name], jax_reference(model, "structure_aware", graph=graph), name)
        wb = jax_wire_bytes(kw, graph=graph)
        assert got[name]["wire_bytes"] == wb, name
        assert (wb["rounds"], wb["dense_rounds"]) == ({"ring": 1, "skew": 2}[graph], 3), name
        if not kw.get("adaptive_exchange"):
            assert got[name]["shipped"] == WINDOWS * wb["total_bytes"] > 0, name
            assert got[name]["received"] == got[name]["shipped"], name


@functools.lru_cache(maxsize=None)
def jax_loop_engine():
    """The JAX single-host counterpart of the loop's engine (no exchange)."""
    from repro.core.engine import EngineConfig as JaxConfig
    from repro.core.factory import make_simulation as jax_make

    jspec, jnet = jax_setup("ring")
    jcfg = {k: v for k, v in LOOP_CFG.items() if k != "exchange"}
    return jax_make(jspec, JaxConfig(**jcfg), net=jnet), jnet


def jax_checkpoint(directory) -> str:
    """The JAX single host's loop preempted after window 3 into
    ``directory`` (hashed as the routed run it resumes into)."""
    from repro.core import faults as jfaults
    from repro.core import schedule as jsched

    jeng, jnet = jax_loop_engine()
    ckpt = jsched.SimCheckpointer(str(directory), jeng, jnet, every=0, exchange="routed")
    with pytest.raises(jfaults.Preempted):
        jsched.run_windows(jeng, jeng.init(), WINDOWS, checkpointer=ckpt,
                           faults=jfaults.FaultConfig(preempt_after_window=3))
    return str(directory)


def check_loop(got, stopped, ckdir):
    """The run loop on the (4, 2) world against the JAX single-host loop: its
    spikes a window and streamed blocks, its preempted and resumed runs (on
    the same mesh and elastically on a (2, 4) one) bitwise the uninterrupted
    run, its checkpoint resumed by the JAX ``restore_sim``, and a stop asked
    on rank 0 alone taken by every rank after window 2. The JAX single
    host's checkpoint resumed on the mesh (``jax_checkpoint``) is bitwise
    too."""
    from repro.core import schedule as jsched

    jeng, jnet = jax_loop_engine()
    blocks = []
    res = jsched.run_windows(jeng, jeng.init(), WINDOWS,
                             on_block=lambda w, b: blocks.append(np.asarray(b)))
    assert res.spikes_per_window.sum() > 0
    assert got["loop spikes"] == res.spikes_per_window.tolist()
    assert all(np.array_equal(a.astype(bool), b.astype(bool))
               for a, b in zip(got["loop blocks"], blocks, strict=True))
    final = snapshot(res.state)
    for k, want in final.items():
        assert np.array_equal(np.asarray(got["loop final"][k]), want), k
    assert got["preempted at"] == 3
    for name, groups in (("same mesh", None), ("elastic", (4, 2)), ("from jax", (1, 4))):
        state, reshard, overflow = got[f"resumed {name}"]
        assert overflow == 0, name
        assert reshard == (None if groups is None else dict(
            old_n_groups=groups[0], new_n_groups=groups[1], moved_areas=reshard["moved_areas"]))
        for k, want in final.items():
            assert np.array_equal(np.asarray(state[k]), want), (name, k)
    st, info = jsched.restore_sim(str(ckdir), jeng, jnet, exchange="routed")
    assert info["step"] == 3 and info["reshard"]["old_n_groups"] == 4
    res = jsched.run_windows(jeng, st, WINDOWS - 3)
    for k, want in final.items():
        assert np.array_equal(np.asarray(snapshot(res.state)[k]), want), ("jax resume", k)
    assert stopped == [2] * 8


# ---------------------------------------------------------------------------
# (2, 2, 2): a three-axis mesh, replicated layouts, the host-free build
# ---------------------------------------------------------------------------

LAYOUT_CASES = [
    ("ignore_and_fire", dict(delivery_backend=b, schedule=s))
    for b in ("scatter", "pallas", "event") for s in SCHEDULES
] + [
    ("lif", dict(delivery_backend="event")),
    ("lif", dict(delivery_backend="pallas", schedule="conventional")),
    # The replicated layouts: each rank's receive tables are compacted
    # from tables that hold other ranks' targets too.
    ("ignore_and_fire", dict(delivery_backend="event", subgroup_inter_tables=False)),
    ("ignore_and_fire", dict(delivery_backend="event", shard_inter_tables=False,
                             subgroup_inter_tables=False)),
    ("ignore_and_fire", dict(delivery_backend="event", shard_inter_tables=False,
                             schedule="conventional")),
    ("lif", dict(delivery_backend="event", shard_inter_tables=False, adaptive_exchange=True,
                 overlap_exchange=True)),
]
SHARDED_CASES = [dict(), dict(adaptive_exchange=True, overlap_exchange=True),
                 dict(subgroup_inter_tables=False, superstep=False), dict(exchange="routed"),
                 dict(exchange="routed", adaptive_exchange=True, overlap_exchange=True)]
# The routed exchange's rounds over the (pod, data) group index, on the
# skewed graph.
ROUTED_LAYOUT_CASES = [
    ("ignore_and_fire", dict(delivery_backend="event")),
    ("lif", dict(delivery_backend="scatter")),
    ("ignore_and_fire", dict(delivery_backend="event", adaptive_exchange=True,
                             overlap_exchange=True)),
    ("ignore_and_fire", dict(delivery_backend="pallas", shard_inter_tables=False,
                             subgroup_inter_tables=False)),
]
VIEW_FIELDS = ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra", "tgt_intra",
               "wout_intra", "dout_intra", "tgt_inter_in", "wout_inter_in", "dout_inter_in")
VIEW_STATIC = ("n_pad", "n_areas", "ring_len", "delay_ratio", "steps_lo_intra", "r_span_intra",
               "steps_lo_inter", "r_span_inter", "inter_shard_mode")


def layout_name(model, kw):
    return f"{model} " + " ".join(f"{k}={v}" for k, v in kw.items())


def world_layouts(mesh, payload):
    """The three-axis mesh, the replicated layouts and the host-free build."""
    from repro_torch.core import EngineConfig, make_simulation, mam_benchmark_spec
    from repro_torch.core import connectivity as tconn
    from repro_torch.core import dist_engine

    spec = mam_benchmark_spec(**payload["size"])
    net = host_network(payload)
    out = {}
    for model, kw in LAYOUT_CASES:
        cfg = EngineConfig(neuron_model=model, s_max_floor=FLOOR, **kw)
        out[layout_name(model, kw)] = drive(make_simulation(spec, cfg, net=net, mesh=mesh),
                                            WINDOWS)
    # The host-free build's rank view equals the host-built network's cut,
    # with and without the subgroup slicing.
    diffs = []
    for sub in (True, False):
        cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event",
                           sharded_build=True, subgroup_inter_tables=sub)
        built = dist_engine.build_network_sharded(spec, mesh, cfg, seed=12)
        cut = tconn.shard_inter_tables(net, 4, subgroup=2 if sub else 1)
        cut = dist_engine.shard_network(tconn.slice_intra_tables(cut, 2) if sub else cut,
                                        mesh, "structure_aware")
        for f in VIEW_FIELDS:
            a, b = getattr(built, f), getattr(cut, f)
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                diffs.append((sub, f, tuple(a.shape), tuple(b.shape)))
        diffs += [(sub, f) for f in VIEW_STATIC if getattr(built, f) != getattr(cut, f)]
        diffs += [(sub, "src_inter")] if built.src_inter.shape != (0, 0, spec.k_inter) else []
    out["view_diffs"] = diffs
    # The sharded runs go through the plan cache: rank 0 publishes each
    # plan under $REPRO_PLAN_CACHE and broadcasts it to the other ranks.
    tconn._PLAN_MEMO.clear()
    os.environ["REPRO_PLAN_CACHE"] = payload["plan_cache"]
    for kw in SHARDED_CASES:
        cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event",
                           sharded_build=True, s_max_floor=FLOOR, **kw)
        out[f"sharded {kw}"] = drive(make_simulation(spec, cfg, mesh=mesh, build_seed=12),
                                     WINDOWS)
    del os.environ["REPRO_PLAN_CACHE"]
    out.update(world_routed(mesh, payload["skew"], ROUTED_LAYOUT_CASES))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = dist_engine.make_dist_engine(net, spec, mesh, EngineConfig(
            neuron_model="ignore_and_fire", delivery_backend="event", s_max_floor=FLOOR))
    out["alias"] = (drive(eng, WINDOWS), [str(w.category.__name__) for w in caught])
    # shard_state cuts a whole state back to this rank's block.
    st = eng.window(eng.init())[0]
    back = eng.shard_state(eng.gather_state(st))
    out["shard_state"] = all(torch.equal(getattr(back.neuron, f), getattr(st.neuron, f))
                             for f in ("countdown",)) and torch.equal(back.ring, st.ring) \
        and torch.equal(back.spike_count, st.spike_count) and back.t == st.t
    return out if mesh.rank == 0 else None


def test_dist_engine_layouts_and_sharded_build_on_a_2x2x2_world(tmp_path):
    """On a (pod, data, model) world: the backends under both schedules,
    LIF, the replicated layouts (``subgroup_inter_tables=False``,
    ``shard_inter_tables=False``, whose receive tables each rank compacts
    so rows still ascend for the event kernel) and the host-free sharded
    build, whose rank views equal the host-built network's cuts table for
    table, the routed exchange (its rounds over the flattened (pod, data)
    group index, in the hierarchical order) on a skewed graph where some
    groups receive nothing at an offset, and on the host-free build (its
    plans published to ``$REPRO_PLAN_CACHE`` by rank 0): all bitwise the
    JAX single-host engine.
    ``make_dist_engine`` warns and builds the same engine."""
    _, jnet = jax_setup()
    (got,) = [r for r in run_world(tmp_path, (2, 2, 2), ("pod", "data", "model"),
                                   "test_torch_dist_engine:world_layouts",
                                   payload_of(jnet, skew=graph_payload("skew"),
                                              plan_cache=str(tmp_path / "plans")))
              if r is not None]
    for model, kw in LAYOUT_CASES:
        name = layout_name(model, kw)
        assert_trajectory(got[name], jax_reference(model, kw.get("schedule", "structure_aware")),
                          name)
    assert got["view_diffs"] == []
    for kw in SHARDED_CASES:
        assert_trajectory(got[f"sharded {kw}"],
                          jax_reference("ignore_and_fire", "structure_aware"), kw)
    check_routed(got, ROUTED_LAYOUT_CASES, "skew")
    plans = sorted(os.listdir(tmp_path / "plans"))
    assert plans and all(p.startswith("plan_") and p.endswith(".json") for p in plans), plans
    result, caught = got["alias"]
    assert_trajectory(result, jax_reference("ignore_and_fire", "structure_aware"), "alias")
    assert "DeprecationWarning" in caught
    assert got["shard_state"]


# ---------------------------------------------------------------------------
# Forced overflow against the JAX distributed engine
# ---------------------------------------------------------------------------

OVERFLOW_SIZE = dict(SIZE, rate_hz=2000.0)
OVERFLOW_KW = dict(neuron_model="ignore_and_fire", delivery_backend="event",
                   s_max_headroom=0.0, s_max_floor=1)
OVERFLOW_WINDOWS = 4
# (schedule, exchange, mesh). On (1, 8) the group packet outgrows the
# group-local round's edge bound, so the routed edge spill (counted by lane
# 0 alone) shows beside the assembly's.
OVERFLOW_RUNS = (("structure_aware", "dense", (4, 2)), ("conventional", "dense", (4, 2)),
                 ("structure_aware", "routed", (4, 2)), ("structure_aware", "routed", (1, 8)))


def overflow_run(sched, exchange, shape) -> str:
    return f"{sched}_{exchange}_{shape[0]}x{shape[1]}"


def world_overflow(mesh, payload):
    from repro_torch.core import EngineConfig, ProcessMesh, make_simulation, mam_benchmark_spec

    spec = mam_benchmark_spec(**payload["size"])
    net = host_network(payload)
    meshes = {(4, 2): mesh, (1, 8): ProcessMesh((1, 8), ("data", "model"), device="cpu")}
    out = {}
    for sched, exchange, shape in OVERFLOW_RUNS:
        eng = make_simulation(spec, EngineConfig(schedule=sched, exchange=exchange,
                                                 **OVERFLOW_KW), net=net, mesh=meshes[shape])
        st, trace = eng.init(), []
        for _ in range(OVERFLOW_WINDOWS):
            st, blk = eng.window(st)
            trace.append((int(st.overflow), eng.gather_block(blk).numpy()))
        out[overflow_run(sched, exchange, shape)] = (trace, eng.gather_state(st).ring.numpy(),
                                                     float(st.shipped_bytes))
    return out


JAX_OVERFLOW = """
import json, sys
import numpy as np, jax
from repro.core.areas import mam_benchmark_spec
from repro.core.connectivity import build_network
from repro.core.engine import EngineConfig
from repro.core.factory import make_simulation

spec = mam_benchmark_spec(**SIZE)
net = build_network(spec, seed=12, size_multiple=8, outgoing=True)
out = {}
for sched, exchange, shape in RUNS:
    run = f"{sched}_{exchange}_{shape[0]}x{shape[1]}"
    mesh = jax.make_mesh(shape, ("data", "model"))
    eng = make_simulation(spec, EngineConfig(schedule=sched, exchange=exchange, **KW),
                          net=net, mesh=mesh)
    st = eng.init()
    for w in range(WINDOWS):
        st, blk = eng.window(st)
        np.save(f"{DIR}/{run}_block{w}.npy", np.asarray(blk))
        out[f"{run} {w}"] = int(st.overflow)
    np.save(f"{DIR}/{run}_ring.npy", np.asarray(st.ring))
    out[f"{run} shipped"] = float(st.shipped_bytes)
print(json.dumps(out))
"""


def test_forced_overflow_matches_the_jax_distributed_engine(tmp_path):
    """``s_max_headroom=0, s_max_floor=1`` at 2000 Hz starves the static
    packets: on a (4, 2) world the port drops what the JAX distributed
    engine drops on its (4, 2) mesh of 8 forced host devices -- the same
    overflow count after every window, the same (lossy) blocks and ring,
    the same shipped bytes -- under both schedules, and for the routed
    exchange's group assembly and edge packets (on a (4, 2) mesh and on a
    (1, 8) one, where the edge packets spill too)."""
    code = (f"SIZE = {OVERFLOW_SIZE!r}\nKW = {OVERFLOW_KW!r}\nWINDOWS = {OVERFLOW_WINDOWS}\n"
            f"RUNS = {OVERFLOW_RUNS!r}\nDIR = {str(tmp_path)!r}\n" + JAX_OVERFLOW)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    jax_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    from repro.core.areas import mam_benchmark_spec as jax_spec
    from repro.core.connectivity import build_network as jax_build

    jnet = jax_build(jax_spec(**OVERFLOW_SIZE), seed=12, size_multiple=8, outgoing=True)
    results = run_world(tmp_path / "world", (4, 2), ("data", "model"),
                        "test_torch_dist_engine:world_overflow",
                        dict(payload_of(jnet), size=OVERFLOW_SIZE))
    stdout, stderr = jax_proc.communicate(timeout=540)
    assert jax_proc.returncode == 0, stderr[-4000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for sched, exchange, shape in OVERFLOW_RUNS:
        run = overflow_run(sched, exchange, shape)
        overflows = [want[f"{run} {w}"] for w in range(OVERFLOW_WINDOWS)]
        assert overflows[-1] > 0, "the bound was meant to starve"
        for rank, got in enumerate(results):
            trace, ring, shipped = got[run]
            assert [o for o, _ in trace] == overflows, (run, rank)
            for w, (_, blk) in enumerate(trace):
                assert np.array_equal(blk.astype(bool), np.load(
                    tmp_path / f"{run}_block{w}.npy").astype(bool)), (run, rank, w)
            assert np.array_equal(ring, np.load(tmp_path / f"{run}_ring.npy")), (run, rank)
            assert shipped == want[f"{run} shipped"], (run, rank)


# ---------------------------------------------------------------------------
# The distributed config rules
# ---------------------------------------------------------------------------

RULE_GRID = [
    dict(),
    dict(exchange="dense"),
    dict(exchange="local"),
    dict(superstep_kernel=True),
    dict(superstep_kernel=True, schedule="conventional"),
    dict(delivery_backend="event", sharded_build=True),
    dict(delivery_backend="scatter", sharded_build=True),
    dict(delivery_backend="event", sharded_build=True, shard_inter_tables=False),
    dict(delivery_backend="event", sharded_build=True, schedule="conventional"),
    dict(exchange="dense", sharded_build=True, overlap_exchange=True,
         schedule="conventional", superstep=True),
]


@pytest.mark.parametrize("distributed", [None, False, True])
def test_config_violations_match_jax(distributed):
    """Field, problem and remedy of every violated rule, in the JAX
    package's order, for the construction-time, single-host and
    distributed rule sets."""
    from repro.core.engine import ConfigError as JaxConfigError
    from repro.core.engine import EngineConfig as JaxConfig

    from repro_torch.core import ConfigError, EngineConfig

    def violations(cls, err, kw):
        try:
            cfg = cls(**kw)
        except err as e:
            return [("init",) + dataclasses.astuple(v) for v in e.violations]
        return [dataclasses.astuple(v) for v in cfg.validate(distributed=distributed)]

    for kw in RULE_GRID:
        assert (violations(EngineConfig, ConfigError, kw)
                == violations(JaxConfig, JaxConfigError, kw)), kw


# ---------------------------------------------------------------------------
# On the card: four ranks sharing the GPU, held to the host
# ---------------------------------------------------------------------------

CARD_CASES = [dict(delivery_backend=b, schedule=s) for b in ("pallas", "event")
              for s in SCHEDULES] + [
    dict(delivery_backend="event", schedule="structure_aware", adaptive_exchange=True,
         overlap_exchange=True)] + [
    dict(delivery_backend=b, schedule="structure_aware", exchange="routed", **kw)
    for b, kw in (("pallas", {}), ("event", dict(adaptive_exchange=True)))]


def world_card(mesh, payload):
    """The card cases on this rank's GPU; each whole block and state moved
    to the host."""
    from repro_torch.core import EngineConfig, make_simulation, mam_benchmark_spec
    from repro_torch.core.connectivity import network_from_numpy

    spec = mam_benchmark_spec(**payload["size"])
    net = network_from_numpy(payload["arrays"], device=mesh.device, **payload["static"])
    out = {}
    for kw in CARD_CASES:
        eng = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire",
                                                 s_max_floor=FLOOR, **kw), net=net, mesh=mesh)
        out[str(kw)] = drive(eng, WINDOWS)
    return out if mesh.rank == 0 else None


@pytest.mark.cuda
def test_dist_engine_on_the_card_equals_the_host(tmp_path):
    """Four gloo ranks on the GPU (device tensors staged through pinned
    host buffers, kernels 2 and 6 on shard shapes, the routed exchange's
    ppermute rounds) give the single-host engine's blocks and states on
    the CPU, bitwise, overflow 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks' kernels run only on the GPU")
    from repro_torch.core import EngineConfig, build_network, make_simulation
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.core.connectivity import OUTGOING_TABLES, _TABLES

    spec = mam_benchmark_spec(**SIZE)
    net = build_network(spec, seed=12, size_multiple=8, outgoing=True, device="cpu")
    static = ("n_pad", "n_areas", "ring_len", "delay_ratio", "dt_ms", "steps_lo_intra",
              "r_span_intra", "steps_lo_inter", "r_span_inter")
    payload = dict(size=SIZE, static={f: getattr(net, f) for f in static},
                   arrays={f: getattr(net, f).numpy() for f in _TABLES + OUTGOING_TABLES})
    (got,) = [r for r in run_world(tmp_path, (2, 2), ("data", "model"),
                                   "test_torch_dist_engine:world_card", payload, device=None)
              if r is not None]
    for kw in CARD_CASES:
        ref = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire",
                                                 schedule=kw["schedule"]), net=net, device="cpu")
        st, blocks, states = ref.init(), [], []
        for _ in range(WINDOWS):
            st, blk = ref.window(st)
            blocks.append(blk.numpy())
            states.append(snapshot(st))
        assert_trajectory(got[str(kw)], (blocks, states), kw)
