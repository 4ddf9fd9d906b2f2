"""The port's event backend against the JAX package's, on the CPU.

Outgoing tables (``build_network(outgoing=True | "intra")``), the packet
primitives (``sized_nonzero``, ``compact_ids_block``), the event scatters
(``event_deliver``, ``_ids``, ``_block``), the packet sizing
(``event_bounds``, the bucket ladders) and the event engine's trajectories,
overflow included. Sizes: 2-4 areas x 32-64 neurons, K 4-8. Tolerance:
bitwise everywhere -- weights lie on the 1/256 grid, so every scatter is
exact in any order.

One leaf is held elsewhere, as in ``tests/test_torch_cycle.py``: the
membrane potential ``v`` of the JAX fused (``superstep_kernel=True``) LIF
window, which drifts from its own unfused engine by a few ulps; the port's
fused ``v`` is held against the JAX unfused event engine.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import areas as jareas  # noqa: E402
from repro.core import delivery as jdlv  # noqa: E402
from repro.core.connectivity import build_network as jbuild  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.factory import make_simulation as jax_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import EngineConfig, make_simulation  # noqa: E402
from repro_torch.core import areas as tareas  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import delivery as tdlv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_engine import STATIC, TABLES, assert_same, snapshot  # noqa: E402

OUT = tconn.OUTGOING_TABLES


def specs(delay_inter_max_ms=None, **kw):
    """The same MAM-benchmark spec in both packages."""
    pair = jareas.mam_benchmark_spec(**kw), tareas.mam_benchmark_spec(**kw)
    if delay_inter_max_ms is not None:
        pair = tuple(dataclasses.replace(s, delay_inter_max_ms=delay_inter_max_ms)
                     for s in pair)
    return pair


def carry(jnet):
    """A JAX network, outgoing tables included, as a port network on the CPU."""
    return tconn.network_from_numpy(
        {f: (None if getattr(jnet, f) is None else np.asarray(getattr(jnet, f)))
         for f in TABLES + OUT},
        device="cpu", **{f: getattr(jnet, f) for f in STATIC})


# ---------------------------------------------------------------------------
# Outgoing tables
# ---------------------------------------------------------------------------

OUTGOING_CASES = {
    # name: (spec kwargs, size_multiple, outgoing)
    "int8": (dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8), 1, True),
    "int32": (dict(n_areas=3, n_per_area=40, k_intra=6, k_inter=5,
                   delay_inter_max_ms=20.0), 1, True),
    "ghost_rows": (dict(n_areas=2, n_per_area=37, k_intra=4, k_inter=7), 8, True),
    "intra_only": (dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8), 1, "intra"),
    "one_area": (dict(n_areas=1, n_per_area=64, k_intra=4, k_inter=4), 1, True),
}


@pytest.mark.parametrize("case", list(OUTGOING_CASES))
def test_outgoing_tables_match_jax(case):
    kw, multiple, outgoing = OUTGOING_CASES[case]
    jspec, tspec = specs(**kw)
    jnet = jbuild(jspec, seed=12, size_multiple=multiple, outgoing=outgoing)
    # Small chunks, so chunk edges fall inside areas and between them.
    tnet = tconn.build_network(tspec, seed=12, size_multiple=multiple,
                               outgoing=outgoing, device="cpu", chunk_rows=7)
    for f in OUT:
        want, got = getattr(jnet, f), getattr(tnet, f)
        if want is None:
            assert got is None, f
            continue
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, f
        assert got.shape == want.shape and np.array_equal(got.numpy(), want), f
    # Only the int32 case's inter delays outgrow int8.
    assert tnet.dout_intra.dtype == torch.int8
    if jnet.tgt_inter is not None:
        assert (tnet.dout_inter.dtype == torch.int32) == (case == "int32")
    for f in TABLES:
        assert np.array_equal(getattr(tnet, f).numpy(), np.asarray(getattr(jnet, f))), f
    # K_out: the widest source, within the dry-run bound.
    assert tnet.tgt_intra.shape[-1] <= tconn._outgoing_k_bound(tnet.k_intra)


def test_network_from_numpy_carries_outgoing_tables():
    jspec, tspec = specs(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)
    jnet = jbuild(jspec, seed=654, outgoing=True)
    carried = carry(jnet)
    built = tconn.build_network(tspec, seed=654, outgoing=True, device="cpu")
    for f in TABLES + OUT:
        assert torch.equal(getattr(carried, f), getattr(built, f)), f
    plain = tconn.network_from_numpy(
        {f: np.asarray(getattr(jnet, f)) for f in TABLES}, device="cpu",
        **{f: getattr(jnet, f) for f in STATIC})
    assert all(getattr(plain, f) is None for f in OUT)
    with pytest.raises(ValueError, match="outgoing"):
        tconn.build_network(tspec, seed=654, outgoing="inter", device="cpu")


def ascends_with_padding_last(tgt) -> bool:
    """Every row ascends as unsigned 32-bit values: real targets in order,
    the -1 padding only at the end (numpy, independent of the port)."""
    rows = np.asarray(tgt).reshape(-1, np.shape(tgt)[-1]).astype(np.int64) & 0xFFFFFFFF
    return bool((np.diff(rows, axis=1) >= 0).all())


@pytest.mark.parametrize("case", list(OUTGOING_CASES))
def test_outgoing_rows_ascend_with_padding_last(case):
    """The event kernel's precondition (``kernels/event_deliver``): the
    port's outgoing tables, built whole (``build_network(outgoing=...)``) or
    added to a built network (``add_outgoing_tables``), and the JAX
    package's, carried in through ``network_from_numpy``."""
    kw, multiple, outgoing = OUTGOING_CASES[case]
    jspec, tspec = specs(**kw)
    built = tconn.build_network(tspec, seed=12, size_multiple=multiple, outgoing=outgoing,
                                device="cpu", chunk_rows=7)
    added = tconn.add_outgoing_tables(
        tconn.build_network(tspec, seed=12, size_multiple=multiple, device="cpu"), outgoing)
    jnet = jbuild(jspec, seed=12, size_multiple=multiple, outgoing=outgoing)
    for name in ("tgt_intra", "tgt_inter"):
        tables = [getattr(built, name), getattr(added, name), getattr(jnet, name)]
        if tables[2] is None:
            assert tables[0] is None and tables[1] is None, name
            continue
        assert all(ascends_with_padding_last(t) for t in tables), name
        padding = np.asarray(tables[2]) < 0
        assert padding.any(), name  # the rows do carry padding
    tconn.check_outgoing_order(built)
    tconn.check_outgoing_order(added)
    carry(jnet)  # checks the carried tables' order


@pytest.mark.parametrize("table", ["tgt_intra", "tgt_inter"])
@pytest.mark.parametrize("fault", ["swapped", "padding_inside"])
def test_network_from_numpy_refuses_unsorted_outgoing_rows(table, fault):
    jspec, _ = specs(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)
    jnet = jbuild(jspec, seed=654, outgoing=True)
    arrays = {f: (None if getattr(jnet, f) is None else np.array(getattr(jnet, f)))
              for f in TABLES + OUT}
    rows = arrays[table].reshape(-1, arrays[table].shape[-1])
    r = int(np.argmax((rows >= 0).sum(axis=1) >= 2))  # a row with two real targets
    if fault == "swapped":
        rows[r, [0, 1]] = rows[r, [1, 0]] if rows[r, 0] != rows[r, 1] else (rows[r, 0] + 1,
                                                                            rows[r, 0])
    else:
        rows[r, 0] = -1
    with pytest.raises(ValueError, match=f"{table}: outgoing row {r} "):
        tconn.network_from_numpy(arrays, device="cpu", **{f: getattr(jnet, f) for f in STATIC})


# ---------------------------------------------------------------------------
# Packet primitives and scatters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 7, 40, 90])
def test_sized_nonzero_and_compact_ids_block_match_jax(size):
    """Under overflow (size below the count) the same entries survive."""
    rng = np.random.default_rng(size)
    mask = rng.random((5, 64)) < 0.3
    mask[2] = False
    mask[3] = True
    ids = rng.integers(0, 10_000, 64).astype(np.int32)
    rows = tops.sized_nonzero(torch.from_numpy(mask), size=size, fill=64)  # one per row
    for d in range(5):
        want = jops.sized_nonzero(jnp.asarray(mask[d]), size=size, fill=64)
        got = tops.sized_nonzero(torch.from_numpy(mask[d]), size=size, fill=64)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(rows[d], got)
    for payload in (ids, np.tile(ids, (5, 1)) + np.arange(5, dtype=np.int32)[:, None]):
        jp, jc = jops.compact_ids_block(jnp.asarray(mask), jnp.asarray(payload),
                                        size=size, fill_id=-1)
        tp, tc = tops.compact_ids_block(torch.from_numpy(mask), torch.from_numpy(payload),
                                        size=size, fill_id=-1)
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(tc.numpy(), np.asarray(jc)) and tc.dtype == torch.int32
    jp, jc = jdlv.compact_fired_block(jnp.asarray(mask), jnp.asarray(ids), s_max=size,
                                      invalid=99)
    tp, tc = tdlv.compact_fired_block(torch.from_numpy(mask), torch.from_numpy(ids),
                                      s_max=size, invalid=99)
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(tc.numpy(), np.asarray(jc))
    jp, jc = jdlv.compact_fired(jnp.asarray(mask[0]), jnp.asarray(ids), s_max=size, invalid=99)
    tp, tc = tdlv.compact_fired(torch.from_numpy(mask[0]), torch.from_numpy(ids),
                                s_max=size, invalid=99)
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and int(tc) == int(jc)


def scatter_inputs(delay_dtype, seed=0):
    """Outgoing tables with -1 padding (weight 0, delay 1, as built), a ring
    on the 1/256 grid and packets with padding ids and repeats."""
    rng = np.random.default_rng(seed)
    n, k, r = 60, 9, 110
    tgt = rng.integers(0, n, (n, k)).astype(np.int32)
    w = (np.round(rng.normal(0, 60, (n, k)) * 256) / 256).astype(np.float32)
    d = rng.integers(1, 101, (n, k)).astype(delay_dtype)
    pad = rng.random((n, k)) < 0.2
    tgt[pad], w[pad], d[pad] = -1, 0.0, 1
    ring = (np.round(rng.normal(0, 8, (n, r))) / 256.0).astype(np.float32)
    ids = rng.integers(0, n + 4, (10, 12)).astype(np.int32)
    return ring, ids, tgt, w, d


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
def test_event_scatters_match_jax(delay_dtype):
    ring, ids, tgt, w, d = scatter_inputs(delay_dtype)
    jt = [jnp.asarray(x) for x in (tgt, w, d)]
    tt = [torch.from_numpy(x) for x in (tgt, w, d)]
    t0 = 1234
    want = jops.event_deliver_block(jnp.asarray(ring), jnp.asarray(ids), *jt, jnp.int32(t0))
    got = tops.event_deliver_block(torch.from_numpy(ring.copy()), torch.from_numpy(ids), *tt, t0)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = jops.event_deliver_ids(jnp.asarray(ring), jnp.asarray(ids[3]), *jt, jnp.int32(t0))
    got = tops.event_deliver_ids(torch.from_numpy(ring.copy()), torch.from_numpy(ids[3]), *tt, t0)
    assert np.array_equal(got.numpy(), np.asarray(want))
    spikes = np.random.default_rng(1).random(60) < 0.2
    for s_max in (3, 60):  # under overflow, and not
        want = jops.event_deliver(jnp.asarray(ring), jnp.asarray(spikes), *jt,
                                  jnp.int32(t0), s_max=s_max)
        got = tops.event_deliver(torch.from_numpy(ring.copy()), torch.from_numpy(spikes),
                                 *tt, t0, s_max=s_max)
        assert np.array_equal(got.numpy(), np.asarray(want)), s_max
    # Padding only: the ring is unchanged.
    pad_ids = torch.full((2, 5), 60, dtype=torch.int32)
    got = tops.event_deliver_block(torch.from_numpy(ring.copy()), pad_ids, *tt, t0)
    assert torch.equal(got, torch.from_numpy(ring))


def test_per_area_scatter_equals_one_scatter_per_area():
    """``rows_per_area``: row a of the packets is area a's, over the area's
    rows of the tables and the ring -- the JAX package vmaps one
    ``event_deliver`` per area."""
    ring, ids, tgt, w, d = scatter_inputs(np.int8, seed=3)
    a, n = 3, 20
    tgt = np.where(tgt >= 0, tgt % n, -1).astype(np.int32)
    ids = np.minimum(ids[:a], n + 1)
    want = np.stack([np.asarray(jops.event_deliver_ids(
        jnp.asarray(ring[i * n:(i + 1) * n]), jnp.asarray(ids[i]),
        jnp.asarray(tgt[i * n:(i + 1) * n]), jnp.asarray(w[i * n:(i + 1) * n]),
        jnp.asarray(d[i * n:(i + 1) * n]), jnp.int32(77))) for i in range(a)])
    got = tops.event_deliver_block(
        torch.from_numpy(ring.copy()), torch.from_numpy(ids), torch.from_numpy(tgt),
        torch.from_numpy(w), torch.from_numpy(d), 77, rows_per_area=n)
    assert np.array_equal(got.numpy(), want.reshape(a * n, -1))
    with pytest.raises(ValueError, match="rows_per_area"):
        tops.event_deliver_block(torch.from_numpy(ring), torch.from_numpy(ids),
                                 torch.from_numpy(tgt), torch.from_numpy(w),
                                 torch.from_numpy(d), 77, rows_per_area=n + 1)


# ---------------------------------------------------------------------------
# Packet sizing
# ---------------------------------------------------------------------------

BOUND_SPECS = {
    "quickstart": dict(n_areas=4, n_per_area=256, k_intra=32, k_inter=32),
    "iaf_30hz": dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8, rate_hz=30.0),
    "forced_overflow": dict(n_areas=2, n_per_area=64, k_intra=4, k_inter=4, rate_hz=2000.0),
    "rate_cv": dict(n_areas=5, n_per_area=33, k_intra=4, k_inter=4, rate_cv=0.3),
}


@pytest.mark.parametrize("name", list(BOUND_SPECS))
def test_event_bounds_match_jax(name):
    jspec, tspec = specs(**BOUND_SPECS[name])
    jnet = jbuild(jspec, seed=12, size_multiple=8)
    tnet = tconn.build_network(tspec, seed=12, size_multiple=8, device="cpu")
    got, want = tdlv.expected_area_spikes(tnet), jdlv.expected_area_spikes(jnet)
    if name == "rate_cv":
        # Rates off the f32 grid's exact sums: the f32 mean depends on the
        # reduction order (XLA's and torch's differ in the last bit).
        assert got == pytest.approx(want, rel=1e-6)
    else:
        assert got == want
    for headroom, floor, burst in [(8.0, 16, 1), (0.0, 1, 1), (3.5, 4, 3), (8.0, 0, 2)]:
        kw = dict(headroom=headroom, floor=floor, burst_factor=burst)
        assert tdlv.event_bounds(tnet, **kw) == jdlv.event_bounds(jnet, **kw), kw


def test_bucket_ladders_match_jax_at_the_rung_edges():
    """The edges of ``tests/test_adaptive.py``: a count on a rung selects it,
    one past it the next, and the top rung clamps."""
    for floor, cap in [(4, 100), (4, 64), (7, 7), (0, 5), (16, 520_000)]:
        ladder = tdlv.bucket_ladder(floor, cap)
        assert ladder == jdlv.bucket_ladder(floor, cap)
        needs = sorted({0, 1, 10_000_000} | {b + e for b in ladder for e in (-1, 0, 1)})
        for need in needs:
            want = int(jops.bucket_index(ladder, jnp.int32(need)))
            assert tops.bucket_index(ladder, need) == want, (ladder, need)
            assert tops.bucket_index(ladder, torch.tensor(need, dtype=torch.int32)) == want
            assert tops.ladder_rung(ladder, need) == int(jops.ladder_rung(ladder, jnp.int32(need)))
        for expected in (0.0, 3.2, 4.0, 4.1, 63.9, 1e9):
            assert tdlv.expected_bucket(ladder, expected) == jdlv.expected_bucket(ladder, expected)
    assert tops.ladder_switch((4, 8, 16), 5, lambda b, x: b + x, 100) == 108


# ---------------------------------------------------------------------------
# Engine trajectories
# ---------------------------------------------------------------------------

SIZE = dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
# neuron model -> (rate Hz, build seed, windows), as tests/test_torch_engine.py
ENGINE_CASES = {"ignore_and_fire": (30.0, 91856, 12), "lif": (2.5, 12, 30)}
VARIANTS = {
    "conventional": dict(schedule="conventional"),
    "superstep": dict(schedule="structure_aware"),
    "legacy": dict(schedule="structure_aware", superstep=False),
    "fused": dict(schedule="structure_aware", superstep_kernel=True),
}


@functools.lru_cache(maxsize=None)
def event_network(model):
    rate, seed, _ = ENGINE_CASES[model]
    jspec, tspec = specs(**SIZE, rate_hz=rate)
    return jspec, tspec, jbuild(jspec, seed=seed, outgoing=True)


@functools.lru_cache(maxsize=None)
def jax_event_trajectory(model, variant):
    jspec, _, jnet = event_network(model)
    eng = jax_make(jspec, JaxConfig(neuron_model=model, delivery_backend="event",
                                    **VARIANTS[variant]), net=jnet)
    st, snaps = eng.init(), []
    for _ in range(ENGINE_CASES[model][2]):
        st, blk = eng.window(st)
        snaps.append(dict(snapshot(st, blk), overflow=int(st.overflow)))
    return snaps


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("model", list(ENGINE_CASES))
def test_event_engine_matches_jax(model, variant):
    want = jax_event_trajectory(model, variant)
    if model == "lif" and variant == "fused":  # see the module docstring
        unfused_v = [s["v"] for s in jax_event_trajectory(model, "superstep")]
        want = [dict(s, v=v) for s, v in zip(want, unfused_v)]
    _, tspec, jnet = event_network(model)
    eng = make_simulation(tspec, EngineConfig(neuron_model=model, delivery_backend="event",
                                              **VARIANTS[variant]),
                          net=carry(jnet), device="cpu")
    st = eng.init()
    for w, snap in enumerate(want):
        st, blk = eng.window(st)
        assert_same(dict(snapshot(st, blk), overflow=int(st.overflow)), snap,
                    (model, variant, w))
    assert int(st.spike_count.sum()) > 0


def test_event_engine_equals_the_pallas_engine_and_builds_its_own_tables():
    """``make_simulation`` builds the outgoing tables exactly for the event
    backend, and the event engine's trajectory is the pallas engine's."""
    _, tspec, _ = event_network("ignore_and_fire")
    seed = ENGINE_CASES["ignore_and_fire"][1]
    cfg = dict(neuron_model="ignore_and_fire")
    event = make_simulation(tspec, EngineConfig(delivery_backend="event", **cfg),
                            build_seed=seed, device="cpu")
    pallas = make_simulation(tspec, EngineConfig(delivery_backend="pallas", **cfg),
                             build_seed=seed, device="cpu")
    se, sp = event.init(), pallas.init()
    for w in range(12):
        se, be = event.window(se)
        sp, bp = pallas.window(sp)
        assert_same(snapshot(se, be), snapshot(sp, bp), w)
    assert int(se.overflow) == 0 and sp.overflow == 0
    net = tconn.build_network(tspec, seed=seed, device="cpu")
    with pytest.raises(ValueError, match="outgoing=True"):
        make_simulation(tspec, EngineConfig(delivery_backend="event", **cfg), net=net,
                        device="cpu")


OVERFLOW_VARIANTS = {
    "conventional": dict(schedule="conventional"),
    "legacy": dict(schedule="structure_aware", superstep=False),
    "superstep": dict(schedule="structure_aware"),
    "superstep_unroll": dict(schedule="structure_aware", superstep_unroll=True),
}


@functools.lru_cache(maxsize=None)
def overflow_network():
    jspec, tspec = specs(n_areas=2, n_per_area=64, k_intra=4, k_inter=4, rate_hz=2000.0)
    return jspec, tspec, jbuild(jspec, seed=12, outgoing=True)


@pytest.mark.parametrize("variant", list(OVERFLOW_VARIANTS))
def test_forced_overflow_matches_jax(variant):
    """``s_max_headroom=0, s_max_floor=1`` with massed firing drops spikes:
    the port's overflow count and trajectory equal JAX's, and the count is
    the same under every schedule (``tests/test_system.py``)."""
    jspec, tspec, jnet = overflow_network()
    base = dict(neuron_model="ignore_and_fire", delivery_backend="event",
                s_max_headroom=0.0, s_max_floor=1)
    kw = dict(base, **OVERFLOW_VARIANTS[variant])
    jeng = jax_make(jspec, JaxConfig(**kw), net=jnet)
    teng = make_simulation(tspec, EngineConfig(**kw), net=carry(jnet), device="cpu")
    js, ts = jeng.init(), teng.init()
    for w in range(5):
        js, jb = jeng.window(js)
        ts, tb = teng.window(ts)
        assert_same(dict(snapshot(ts, tb), overflow=int(ts.overflow)),
                    dict(snapshot(js, jb), overflow=int(js.overflow)), (variant, w))
    assert isinstance(ts.overflow, torch.Tensor) and ts.overflow.dtype == torch.int32
    # The count every schedule reports (conventional's, from the JAX engine).
    conventional = jax_make(jspec, JaxConfig(**base, schedule="conventional"), net=jnet)
    cs = conventional.init()
    for _ in range(5):
        cs, _ = conventional.window(cs)
    assert int(ts.overflow) == int(cs.overflow) > 0
