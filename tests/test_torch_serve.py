"""The port's serving layer against the JAX package's, on the CPU.

``tile_spec``, ``tile_gids`` and ``tile_network`` array for array against
the JAX package's (the event network, outgoing tables and their ``-1``
sentinels included); the port's ``SimServer(device="cpu")`` serving the
same mixed-duration requests as the JAX ``SimServer``, every trial's spikes
and overflow bitwise equal, on the ``event`` route and on the port's
``pallas`` route; the port's mirrors of ``tests/test_serve.py``; journals
crossing between the packages; the refusals. Sizes are those of
``tests/test_serve.py``: 4 areas x 48 neurons, K 8/8, ``v_th`` 2.0 mV so
trials spike within a window or two. Tolerance: bitwise everywhere. The
entry points, the CLI and ``repro_torch.serve_snn``:
``test_torch_serve_cli.py``.
"""

import dataclasses
import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import areas as jareas  # noqa: E402
from repro.core import connectivity as jconn  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.neuron import LIFParams as JaxLIF  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import EngineConfig, make_simulation  # noqa: E402
from repro_torch.core import areas as tareas  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core.neuron import LIFParams  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    ServerClosed,
    SimServer,
    TrialRequest,
    sequential_reference,
    serve_simulation,
)
from test_torch_engine import STATIC, TABLES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_KW = dict(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
# Two dispatches at max_batch 4 (the last request waits for the second),
# durations 1-4 windows in three buckets.
MIXED = [dict(seed=101, stim=1.0, windows=3), dict(seed=202, stim=0.9, windows=3),
         dict(seed=303, stim=1.1, windows=2), dict(seed=404, stim=1.0, windows=4),
         dict(seed=505, stim=1.2, windows=1)]


def _spec():
    return tareas.mam_benchmark_spec(**SPEC_KW)


def _cfg(backend="event"):
    return EngineConfig(delivery_backend=backend, lif=LIFParams(v_th_mv=2.0))


def _jax_cfg():
    return JaxConfig(delivery_backend="event", lif=JaxLIF(v_th_mv=2.0))


def _serve(server, requests):
    handles = [server.submit(r) for r in requests]
    return [h.result(timeout=300) for h in handles]


@pytest.fixture(scope="module")
def server():
    with SimServer(_spec(), _cfg(), max_batch=4, max_windows=8, device="cpu") as srv:
        yield srv


@pytest.fixture(scope="module")
def reference():
    """The single-trial engine the sequential references run on."""
    spec, cfg = _spec(), _cfg()
    eng = make_simulation(spec, cfg, device="cpu")
    return lambda request: sequential_reference(spec, cfg, request, engine=eng)


@pytest.fixture(scope="module")
def served(server):
    """MIXED served by the JAX server, the port's event server (the module's)
    and the port's pallas server."""
    out = {}
    with jserve.SimServer(jareas.mam_benchmark_spec(**SPEC_KW), _jax_cfg(),
                          max_batch=4, max_windows=8) as jsrv:
        out["jax"] = _serve(jsrv, [jserve.TrialRequest(**r) for r in MIXED])
    out["event"] = _serve(server, [TrialRequest(**r) for r in MIXED])
    with SimServer(_spec(), _cfg("pallas"), max_batch=4, max_windows=8,
                   device="cpu") as psrv:
        out["pallas"] = _serve(psrv, [TrialRequest(**r) for r in MIXED])
    return out


# ---------------------------------------------------------------------------
# The fold: tile_spec, tile_gids, tile_network


def _spec_pair(k_inter):
    kw = dict(SPEC_KW, k_inter=k_inter)
    return jareas.mam_benchmark_spec(**kw), tareas.mam_benchmark_spec(**kw)


@pytest.mark.parametrize("k_inter", [8, 0])
@pytest.mark.parametrize("copies", [1, 3])
def test_tile_spec_matches_jax(copies, k_inter):
    jspec, tspec = _spec_pair(k_inter)
    got, want = tareas.tile_spec(tspec, copies), jareas.tile_spec(jspec, copies)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_areas == copies * tspec.n_areas
    assert (got.area_adjacency is None) == (k_inter == 0 or copies == 1)
    if copies == 1:
        assert got is tspec


@pytest.mark.parametrize("copies", [1, 3])
def test_tile_gids_matches_jax(copies):
    got = tconn.tile_gids(4, 48, copies, device="cpu")
    want = np.asarray(jconn.tile_gids(4, 48, copies))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("copies", [1, 3])
def test_tile_network_matches_jax(copies):
    """The event network (outgoing tables, -1 sentinels unshifted), array
    for array; the tiled outgoing rows still ascend with -1 last."""
    jspec, tspec = _spec_pair(8)
    jnet = jconn.tile_network(jconn.build_network(jspec, seed=12, outgoing=True), copies)
    tnet = tconn.tile_network(
        tconn.build_network(tspec, seed=12, outgoing=True, device="cpu"), copies)
    for name in TABLES + tconn.OUTGOING_TABLES:
        got, want = getattr(tnet, name), np.asarray(getattr(jnet, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name in STATIC:
        assert getattr(tnet, name) == getattr(jnet, name), name
    assert tnet.n_areas == copies * 4
    # The sentinels: as many -1 targets as copies x the single copy's.
    assert int((tnet.tgt_inter < 0).sum()) == copies * int(
        (np.asarray(jconn.build_network(jspec, seed=12, outgoing=True).tgt_inter) < 0).sum())
    tconn.check_outgoing_order(tnet)


@pytest.mark.parametrize("copies", [0, 3])
def test_tile_network_refusals_match_jax(copies):
    """copies < 1, and a fold past the int32 global-id space: the same
    ValueError and message in both packages (a 4 x 2**28 area grid as a
    view, so nothing is allocated)."""
    huge = np.broadcast_to(np.zeros((), dtype=bool), (4, 1 << 28))
    jstub = jconn.Network.__new__(jconn.Network)
    object.__setattr__(jstub, "alive", huge)
    object.__setattr__(jstub, "tgt_inter_in", None)
    tnet = tconn.build_network(_spec(), seed=12, device="cpu")
    tstub = dataclasses.replace(
        tnet, alive=torch.zeros((), dtype=torch.bool).expand(4, 1 << 28))
    with pytest.raises(ValueError) as want:
        jconn.tile_network(jstub, copies)
    with pytest.raises(ValueError) as got:
        tconn.tile_network(tstub, copies)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Served trials against the JAX server and the sequential references


@pytest.mark.parametrize("route", ["event", "pallas"])
def test_served_trials_match_jax(served, route, reference):
    """Every trial's spikes and overflow bitwise JAX's served trial (and the
    port's pallas route bitwise its event route); every trial longer than a
    window spikes (a one-window trial may not have fired yet)."""
    for got, want, event in zip(served[route], served["jax"], served["event"]):
        assert dataclasses.asdict(got.request) == dataclasses.asdict(want.request)
        assert got.spikes.dtype == want.spikes.dtype == np.bool_
        np.testing.assert_array_equal(got.spikes, want.spikes)
        np.testing.assert_array_equal(got.spikes, event.spikes)
        assert got.overflow == want.overflow == 0
        assert got.spikes.any() or got.request.windows == 1
    np.testing.assert_array_equal(served[route][0].spikes, reference(served[route][0].request))


def test_batch_bitwise_identical_to_sequential(server, reference):
    """A mixed batch (seeds, stim, durations) == its N sequential runs."""
    results = _serve(server, [TrialRequest(**r) for r in MIXED])
    D, A = server.delay_ratio, server.spec.n_areas
    for r in results:
        assert r.overflow == 0, "overflow would break the exactness claim"
        ref = reference(r.request)
        assert r.spikes.shape == (r.request.windows * D, A, ref.shape[2])
        assert np.array_equal(r.spikes, ref), (
            f"seed={r.request.seed}: folded batch diverged from its sequential reference")
    assert results[0].spikes.any() and results[1].spikes.any()
    assert not np.array_equal(results[0].spikes, results[1].spikes[: 3 * D])


def test_streaming_blocks_match_final_result(server):
    """on_block rows concatenate to exactly the final spike train."""
    streamed = []
    req = TrialRequest(seed=777, windows=3)
    h = server.submit(req, on_block=lambda w, rows: streamed.append(rows))
    res = h.result(timeout=300)
    assert len(streamed) == req.windows
    assert np.array_equal(np.concatenate(streamed, axis=0), res.spikes)


def test_concurrent_submitters_preserve_pairing(server, reference):
    """16 racing submitter threads each get their own seed's trajectory."""
    n = 16
    seeds = [1000 + 7 * i for i in range(n)]
    out: dict[int, np.ndarray] = {}
    errs: list[BaseException] = []
    barrier = threading.Barrier(n)

    def tenant(seed):
        try:
            barrier.wait()
            h = server.submit(TrialRequest(seed=seed, windows=2))
            out[seed] = h.result(timeout=300).spikes
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=tenant, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    assert len(out) == n
    for s in seeds:
        assert np.array_equal(out[s], reference(TrialRequest(seed=s, windows=2))), (
            f"tenant seed={s} received another trial's spike train")
    assert not np.array_equal(out[seeds[0]], out[seeds[1]])


def test_sigterm_drains_inflight_and_rejects_new(tmp_path):
    """SIGTERM mid-queue: accepted trials finish, new submits are refused."""
    try:
        with SimServer(_spec(), _cfg(), max_batch=2, max_windows=4, device="cpu",
                       checkpoint_dir=str(tmp_path / "journal")) as srv:
            srv.install_sigterm()
            handles = [srv.submit(TrialRequest(seed=10 + i, windows=2)) for i in range(5)]
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 10
            while not srv._closed and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(ServerClosed):
                srv.submit(TrialRequest(seed=999))
            for h in handles:
                res = h.result(timeout=300)
                assert res.spikes.shape[0] == h.request.windows * srv.delay_ratio
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_nondraining_shutdown_journals_unserved(tmp_path):
    """shutdown(drain=False) journals queued trials for resubmission."""
    journal = str(tmp_path / "journal")
    srv = SimServer(_spec(), _cfg(), max_batch=2, max_windows=4, device="cpu",
                    checkpoint_dir=journal)
    h1 = srv.submit(TrialRequest(seed=5, stim=1.1, windows=3))
    h2 = srv.submit(TrialRequest(seed=6, windows=1))
    srv.shutdown(drain=False)
    for h in (h1, h2):
        with pytest.raises(ServerClosed):
            h.result(timeout=10)
    assert SimServer.restore_unserved(journal) == [h1.request, h2.request]


def test_submit_after_close_raises():
    srv = SimServer(_spec(), _cfg(), max_batch=1, max_windows=2, device="cpu")
    srv.close()
    with pytest.raises(ServerClosed):
        srv.submit(TrialRequest(seed=1))


def test_oversized_duration_rejected(server):
    with pytest.raises(ValueError, match="max_windows"):
        server.submit(TrialRequest(seed=1, windows=512))


def test_serve_simulation_entry_point():
    srv = serve_simulation(_spec(), _cfg(), max_batch=1, max_windows=2, device="cpu")
    try:
        res = srv.submit(TrialRequest(seed=3, windows=1)).result(timeout=300)
        assert res.spikes.shape[0] == srv.delay_ratio
        stats = srv.stats()
        assert stats["trials"] == 1 and stats["trials_per_s"] > 0
        assert stats["p50_ms"] is not None and stats["p99_ms"] is not None
        assert stats["windows"] == 1 and 0 <= stats["block_host_s"] <= stats["busy_s"]
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# Journals across the packages, refusals, entry points


@pytest.mark.parametrize("writer", ["repro_torch", "repro"])
def test_journal_crosses_packages(writer, tmp_path):
    """A non-draining shutdown's journal, written by one package, read back
    by the other's restore_unserved."""
    journal = str(tmp_path / "journal")
    reqs = [dict(seed=5, stim=1.1, windows=3), dict(seed=6, stim=1.0, windows=1)]
    if writer == "repro_torch":
        srv = SimServer(_spec(), _cfg(), max_batch=2, max_windows=4, device="cpu",
                        checkpoint_dir=journal)
        make, read = TrialRequest, jserve.SimServer.restore_unserved
    else:
        srv = jserve.SimServer(jareas.mam_benchmark_spec(**SPEC_KW), _jax_cfg(),
                               max_batch=2, max_windows=4, checkpoint_dir=journal)
        make, read = jserve.TrialRequest, SimServer.restore_unserved
    for r in reqs:
        srv.submit(make(**r))
    srv.shutdown(drain=False)
    assert [dataclasses.asdict(r) for r in read(journal)] == reqs


REFUSALS = {
    "iaf": lambda m: m["server"](m["spec"](), m["config"](
        delivery_backend="event", neuron_model="ignore_and_fire")),
    "superstep_kernel": lambda m: m["server"](m["spec"](), m["config"](
        delivery_backend="event", superstep_kernel=True)),
    "max_batch=0": lambda m: m["server"](m["spec"](), m["config"](
        delivery_backend="event"), max_batch=0),
    "windows=0": lambda m: m["request"](seed=1, windows=0),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    port = dict(server=lambda *a, **k: SimServer(*a, device="cpu", **k), spec=_spec,
                config=EngineConfig, request=TrialRequest)
    ref = dict(server=jserve.SimServer, spec=lambda: jareas.mam_benchmark_spec(**SPEC_KW),
               config=JaxConfig, request=jserve.TrialRequest)
    with pytest.raises(Exception) as want:
        REFUSALS[case](ref)
    with pytest.raises(Exception) as got:
        REFUSALS[case](port)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)
