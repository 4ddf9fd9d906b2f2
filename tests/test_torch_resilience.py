"""The port's resilient run loop against the JAX package's, on the CPU.

Windowed checkpoint / resume, fault injection and preemption
(``schedule.SimCheckpointer``, ``restore_sim``, ``run_windows``,
``core.faults``): the single-host cases of ``tests/test_resilience.py`` and
``tests/test_overlap.py`` on the port, and parity with the reference for the
same inputs -- config-hash digests, checkpoints resumed across the two
packages in both directions, the fault injector's draws and predictions,
the spec grammar's errors, ``Engine.init(seed=, stim=)``. Sizes: 2-4 areas x
32-48 neurons, K 4-8. Tolerance: bitwise for every state leaf and spike
count; the injected walls to 1e-9 relative (host sums of the same draws).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.areas import mam_benchmark_spec as jax_spec  # noqa: E402
from repro.core.connectivity import build_network as jax_build  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.factory import make_simulation as jax_make  # noqa: E402
from repro_torch.core import (  # noqa: E402
    EngineConfig, build_network, make_simulation, mam_benchmark_spec,
)
from repro_torch.core import faults as faults_lib  # noqa: E402
from repro_torch.core import schedule as schedule_lib  # noqa: E402
from repro_torch.core import sync_model  # noqa: E402
from test_torch_engine import assert_same, snapshot  # noqa: E402
from test_torch_event import carry  # noqa: E402

QUICK = dict(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)


@functools.lru_cache(maxsize=None)
def quick_network():
    return build_network(mam_benchmark_spec(**QUICK), seed=12, outgoing=True, device="cpu")


def quick_engine(**cfg_kw):
    """The reference tests' quick engine: LIF, event, s_max_floor 4."""
    cfg_kw = {"neuron_model": "lif", "delivery_backend": "event", "s_max_floor": 4,
              **cfg_kw}
    net = quick_network()
    return make_simulation(mam_benchmark_spec(**QUICK), EngineConfig(**cfg_kw),
                           net=net, device="cpu"), net


def leaves(state) -> dict:
    """Every state leaf as numpy, counters included, from either package."""
    out = {k: v for k, v in snapshot(state, np.zeros(0)).items() if k != "block"}
    out["overflow"] = int(state.overflow)
    out["shipped_bytes"] = float(np.asarray(state.shipped_bytes))
    return out


def assert_states_equal(a, b, tag=""):
    assert_same(leaves(a), leaves(b), tag)


# ---------------------------------------------------------------------------
# Windowed checkpoint / resume (tests/test_resilience.py, single device)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("superstep", [True, False], ids=["superstep", "legacy"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_checkpoint_roundtrip_counters_and_ring_phase(tmp_path, superstep, adaptive):
    """The whole state round-trips: neuron state, ring, t, spike_count,
    overflow, shipped_bytes; the manifest records the phase and the seed;
    the resumed trajectory continues bitwise."""
    eng, net = quick_engine(superstep=superstep, adaptive_exchange=adaptive)
    st = eng.init()
    for _ in range(4):
        st, _ = eng.window(st)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    ckpt.save(st)
    ckpt.close()

    restored, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == 4 and info["reshard"] is None
    assert isinstance(restored.t, int) and restored.t == st.t
    assert_states_equal(restored, st)
    extra = info["manifest"]["extra"]
    assert extra["ring_phase"] == st.t % net.ring_len
    assert extra["window_phase"] == 0
    assert extra["seed"] == eng.config.seed

    ref, resumed = st, restored
    for _ in range(3):
        ref, blk_ref = eng.window(ref)
        resumed, blk_res = eng.window(resumed)
        assert torch.equal(blk_ref, blk_res)
    assert_states_equal(resumed, ref)


def test_checkpoint_on_disk_format_is_the_references(tmp_path):
    """Keys, shapes and dtypes of ``arrays.npz`` and the manifest are the
    JAX package's for the same state."""
    eng, net = quick_engine()
    st, _ = eng.window(eng.init())
    ck = schedule_lib.SimCheckpointer(str(tmp_path / "port"), eng, net, every=0)
    ck.save(st)
    ck.close()
    jspec = jax_spec(**QUICK)
    jnet = jax_build(jspec, seed=12, outgoing=True)
    jeng = jax_make(jspec, JaxConfig(neuron_model="lif", delivery_backend="event",
                                     s_max_floor=4), net=jnet)
    js, _ = jeng.window(jeng.init())
    jck = jsched.SimCheckpointer(str(tmp_path / "jax"), jeng, jnet, every=0)
    jck.save(js)
    jck.close()
    got, want = ({k: v for k, v in json.loads(
        (tmp_path / which / "step_00000001" / "manifest.json").read_text()).items()
        if k != "treedef"} for which in ("port", "jax"))
    assert got == want
    a = np.load(tmp_path / "port" / "step_00000001" / "arrays.npz")
    b = np.load(tmp_path / "jax" / "step_00000001" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_kill_at_window_k_resume_equals_uninterrupted(tmp_path):
    """Preempt at window 5 of 9, resume from the grace checkpoint: spikes
    and the final state equal the uninterrupted run."""
    eng, net = quick_engine()
    ref = schedule_lib.run_windows(eng, eng.init(), 9)

    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(preempt_after_window=5),
                                   n_devices=1, delay_ratio=eng.delay_ratio)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=2, injector=inj)
    with pytest.raises(faults_lib.Preempted) as exc_info:
        schedule_lib.run_windows(eng, eng.init(), 9, checkpointer=ckpt, faults=inj)
    exc = exc_info.value
    assert exc.window == 5 and exc.checkpoint_path == str(tmp_path)
    assert exc.result.windows_done == 5
    assert ckpt.saved_windows == [2, 4, 5]

    st, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == 5
    res = schedule_lib.run_windows(eng, st, 9 - info["step"])
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[5:])
    assert_states_equal(res.state, ref.state)


MATRIX = [(model, backend, superstep, adaptive, overlap)
          for model in ("lif", "ignore_and_fire") for backend in ("event", "pallas")
          for superstep in (True, False) for adaptive in (False, True)
          for overlap in (False, True)]


@functools.lru_cache(maxsize=None)
def matrix_network(model):
    spec = mam_benchmark_spec(**QUICK, rate_hz=200.0 if model == "ignore_and_fire" else 10.0)
    return spec, build_network(spec, seed=12, outgoing=True, device="cpu")


@pytest.mark.parametrize("model,backend,superstep,adaptive,overlap", MATRIX, ids=[
    f"{m}-{b}-{'superstep' if s else 'legacy'}-{'adaptive' if a else 'static'}"
    f"-{'overlap' if o else 'sequential'}" for m, b, s, a, o in MATRIX])
def test_preempt_and_resume_equals_uninterrupted(tmp_path, model, backend, superstep,
                                                 adaptive, overlap):
    """Preempt at window 8 with a checkpoint every 3 and one transient
    write failure, resume for the last 4 windows: every spike block, the
    final state and the spike counts equal the uninterrupted 12 windows."""
    spec, net = matrix_network(model)
    eng = make_simulation(spec, EngineConfig(
        neuron_model=model, delivery_backend=backend, s_max_floor=4, superstep=superstep,
        adaptive_exchange=adaptive, overlap_exchange=overlap), net=net, device="cpu")
    blocks = []
    ref = schedule_lib.run_windows(eng, eng.init(), 12,
                                   on_block=lambda w, b: blocks.append(b.clone()))
    assert ref.spikes_per_window.sum() > 0

    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(
        preempt_after_window=8, ckpt_write_failures=1), n_devices=1,
        delay_ratio=eng.delay_ratio)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=3, injector=inj,
                                        backoff_s=0.001)
    with pytest.raises(faults_lib.Preempted) as exc_info:
        schedule_lib.run_windows(eng, eng.init(), 12, checkpointer=ckpt, faults=inj)
    assert exc_info.value.window == 8 and ckpt.retry_count == 1
    assert exc_info.value.result.drains == (3 if overlap else 0)  # at 3, 6 and 8

    st, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == 8
    got = []
    res = schedule_lib.run_windows(eng, st, 4, on_block=lambda w, b: got.append((w, b)))
    for w, b in got:
        assert torch.equal(b, blocks[w - 1]), w
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[8:])
    assert_states_equal(res.state, ref.state)


def test_forced_overflow_resume_counts_as_the_uninterrupted_run(tmp_path):
    """Static event packets that drop spikes: the resumed run's overflow
    equals the uninterrupted run's (and the JAX engine's), and comes back as
    the int32 device scalar the engine's windows keep."""
    kw = dict(n_areas=4, n_per_area=32, k_intra=4, k_inter=4, rate_hz=1000.0)
    cfg = dict(neuron_model="ignore_and_fire", delivery_backend="event",
               s_max_headroom=0.0, s_max_floor=1)
    jnet = jax_build(jax_spec(**kw), seed=12, size_multiple=8, outgoing=True)
    net = carry(jnet)
    eng = make_simulation(mam_benchmark_spec(**kw), EngineConfig(**cfg), net=net,
                          device="cpu")
    ref = schedule_lib.run_windows(eng, eng.init(), 6)
    assert int(ref.state.overflow) > 0

    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(preempt_after_window=3),
                                   n_devices=1, delay_ratio=eng.delay_ratio)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    with pytest.raises(faults_lib.Preempted):
        schedule_lib.run_windows(eng, eng.init(), 6, checkpointer=ckpt, faults=inj)
    st, _ = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert isinstance(st.overflow, torch.Tensor) and st.overflow.dtype == torch.int32
    assert 0 < int(st.overflow) < int(ref.state.overflow)
    res = schedule_lib.run_windows(eng, st, 3)
    assert_states_equal(res.state, ref.state)

    jeng = jax_make(jax_spec(**kw), JaxConfig(**cfg), net=jnet)
    jres = jsched.run_windows(jeng, jeng.init(), 6)
    assert int(res.state.overflow) == int(jres.state.overflow)
    assert_states_equal(res.state, jres.state)


def test_resume_config_hash_mismatch_fails_fast_with_the_references_message(tmp_path):
    """A checkpoint of another seed refuses to resume, field by field, with
    the reference's message, before any array is read."""
    eng, net = quick_engine()
    st = eng.init()
    for _ in range(2):
        st, _ = eng.window(st)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    ckpt.save(st)
    ckpt.close()
    other, _ = quick_engine(seed=7)
    with pytest.raises(ValueError, match=r"seed: checkpoint=42 != run=7") as err:
        schedule_lib.restore_sim(str(tmp_path), other, net)

    jspec = jax_spec(**QUICK)
    jnet = jax_build(jspec, seed=12, outgoing=True)
    jother = jax_make(jspec, JaxConfig(neuron_model="lif", delivery_backend="event",
                                       s_max_floor=4, seed=7), net=jnet)
    with pytest.raises(ValueError) as jerr:
        jsched.restore_sim(str(tmp_path), jother, jnet)
    assert str(err.value) == str(jerr.value)


def test_checkpoint_rejects_mid_window_state():
    eng, net = quick_engine()
    ckpt = schedule_lib.SimCheckpointer("/nonexistent-never-written", eng, net, every=0)
    bad = dataclasses.replace(eng.init(), t=3)  # not a multiple of D
    with pytest.raises(ValueError, match="mid-window"):
        ckpt.save(bad)
    ckpt.close()


def test_restore_refuses_an_unaligned_phase_and_another_group_count(tmp_path):
    eng, net = quick_engine()
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    saved = eng.window(eng.init())[0]
    ckpt.save(saved)
    ckpt.close()
    path = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(path.read_text())
    assert manifest["extra"]["n_groups"] == 1
    # A two-group distributed run's checkpoint reshards onto the one group
    # of the single host, bitwise; three groups cannot hold the two areas.
    manifest["extra"]["n_groups"] = 2
    path.write_text(json.dumps(manifest))
    restored, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["reshard"] == {"old_n_groups": 2, "new_n_groups": 1, "moved_areas": 2}
    assert {k: np.asarray(v).tolist() for k, v in leaves(restored).items()} == {
        k: np.asarray(v).tolist() for k, v in leaves(saved).items()}
    manifest["extra"]["n_groups"] = 3
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not divisible by n_groups=3"):
        schedule_lib.restore_sim(str(tmp_path), eng, net)
    manifest["extra"]["n_groups"] = 1
    manifest["extra"]["window_phase"] = 3
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not window-phase aligned"):
        schedule_lib.restore_sim(str(tmp_path), eng, net)


@pytest.mark.parametrize("into", ["superstep_kernel", "ignore_and_fire"])
def test_restore_refuses_seed_and_stim_the_engine_would_ignore(tmp_path, into):
    """A checkpoint holding per-neuron ``.seed`` / ``.stim`` leaves is refused,
    with ``Engine.init``'s message and before any array is read, by an engine
    that would ignore them: the fused LIF kernel (the config hash does not
    cover ``superstep_kernel``, so only this check stops it) and
    ignore-and-fire (its manifest planted with the leaves)."""
    if into == "superstep_kernel":
        writer, _ = quick_engine()
        reader, net = quick_engine(superstep_kernel=True)
        state = writer.init(seed=7, stim=1.5)
    else:
        writer, net = quick_engine(neuron_model="ignore_and_fire")
        reader, state = writer, writer.init()
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), writer, net, every=0)
    ckpt.save(writer.window(state)[0])
    ckpt.close()
    step = tmp_path / "step_00000001"
    if into == "ignore_and_fire":
        manifest = json.loads((step / "manifest.json").read_text())
        manifest["keys"] += [".seed", ".stim"]
        (step / "manifest.json").write_text(json.dumps(manifest))
    (step / "arrays.npz").unlink()  # a read would fail with FileNotFoundError
    with pytest.raises(ValueError) as want:
        reader.init(seed=7)
    with pytest.raises(ValueError) as got:
        schedule_lib.restore_sim(str(tmp_path), reader, net)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

CROSS = {
    "lif-event-adaptive": dict(neuron_model="lif", delivery_backend="event",
                               adaptive_exchange=True, s_max_floor=4),
    "iaf-pallas-legacy": dict(neuron_model="ignore_and_fire", delivery_backend="pallas",
                              superstep=False),
    "lif-event-seed-stim": dict(neuron_model="lif", delivery_backend="event",
                                s_max_floor=4),
}
CROSS_SIZE = dict(n_areas=2, n_per_area=32, k_intra=4, k_inter=4, rate_hz=30.0)


@functools.lru_cache(maxsize=None)
def cross_networks():
    jnet = jax_build(jax_spec(**CROSS_SIZE), seed=12, outgoing=True)
    return jnet, carry(jnet)


def cross_engines(case):
    jnet, net = cross_networks()
    jeng = jax_make(jax_spec(**CROSS_SIZE), JaxConfig(**CROSS[case]), net=jnet)
    eng = make_simulation(mam_benchmark_spec(**CROSS_SIZE), EngineConfig(**CROSS[case]),
                          net=net, device="cpu")
    return jeng, jnet, eng, net


def drive_leaves(case, n):
    """Per-neuron seed / stim for the case that carries them."""
    if case != "lif-event-seed-stim":
        return {}
    rng = np.random.default_rng(3)
    return dict(seed=rng.integers(0, 2**32, (2, n), dtype=np.uint32),
                stim=rng.uniform(0.5, 4.0, (2, n)).astype(np.float32))


@pytest.mark.parametrize("case", list(CROSS))
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, case):
    """The JAX loop preempted at window 3 writes the checkpoint; the port
    restores it and runs windows 4-6 bitwise the JAX uninterrupted run's."""
    jeng, jnet, eng, net = cross_engines(case)
    drive = drive_leaves(case, net.n_pad)
    ref = jsched.run_windows(jeng, jeng.init(**drive), 6)
    inj = jfaults.FaultInjector(jfaults.FaultConfig(preempt_after_window=3),
                                n_devices=1, delay_ratio=jeng.delay_ratio)
    jck = jsched.SimCheckpointer(str(tmp_path), jeng, jnet, every=0)
    with pytest.raises(jfaults.Preempted):
        jsched.run_windows(jeng, jeng.init(**drive), 6, checkpointer=jck, faults=inj)
    st, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == 3 and (st.seed is not None) == bool(drive)
    res = schedule_lib.run_windows(eng, st, 3)
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[3:])
    assert_states_equal(res.state, ref.state)
    assert ref.spikes_per_window.sum() > 0


@pytest.mark.parametrize("case", list(CROSS)[:2])
def test_a_port_checkpoint_resumes_in_jax(tmp_path, case):
    """The reverse: the port's preempted run writes, the JAX package
    restores and continues bitwise its own uninterrupted run."""
    jeng, jnet, eng, net = cross_engines(case)
    ref = jsched.run_windows(jeng, jeng.init(), 6)
    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(preempt_after_window=3),
                                   n_devices=1, delay_ratio=eng.delay_ratio)
    ck = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    with pytest.raises(faults_lib.Preempted):
        schedule_lib.run_windows(eng, eng.init(), 6, checkpointer=ck, faults=inj)
    jst, info = jsched.restore_sim(str(tmp_path), jeng, jnet)
    assert info["step"] == 3
    res = jsched.run_windows(jeng, jst, 3)
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[3:])
    assert_states_equal(res.state, ref.state)


HASH_GRID = [
    dict(),
    dict(neuron_model="ignore_and_fire", schedule="conventional"),
    dict(delivery_backend="event", adaptive_exchange=True, s_max_floor=3),
    dict(delivery_backend="pallas", seed=7, s_max_headroom=2.5),
    dict(overlap_exchange=True, shard_inter_tables=False, subgroup_inter_tables=False),
    dict(delivery_backend="scatter", superstep=False, superstep_kernel=False),
]


@pytest.mark.parametrize("exchange", [None, "dense", "routed"])
def test_resume_config_hash_matches_jax(exchange):
    """The same payload and 16-hex digest as the reference, over a grid of
    configs and both networks of the cross tests."""
    jnet, net = cross_networks()
    digests = set()
    for kw in HASH_GRID:
        got = schedule_lib.resume_config_hash(EngineConfig(**kw), net, exchange=exchange)
        want = jsched.resume_config_hash(JaxConfig(**kw), jnet, exchange=exchange)
        assert got == want, kw
        digests.add(got[0])
    assert len(digests) == len(HASH_GRID) - 1  # the layout-only row hashes as the default


# ---------------------------------------------------------------------------
# Engine.init(seed=, stim=) against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scatter", "event"])
def test_init_seed_and_stim_match_jax(backend):
    """Per-neuron seeds and stimulus scales drive the port window by window
    as they drive the JAX engine; a broadcast cfg.seed and all-ones stim
    are bitwise the plain path."""
    cfg = dict(neuron_model="lif", delivery_backend=backend, s_max_floor=4)
    size = dict(QUICK, rate_hz=10.0)
    jnet = jax_build(jax_spec(**size), seed=12, outgoing=True)
    jeng = jax_make(jax_spec(**size), JaxConfig(**cfg), net=jnet)
    eng = make_simulation(mam_benchmark_spec(**size), EngineConfig(**cfg), net=carry(jnet),
                          device="cpu")
    drive = drive_leaves("lif-event-seed-stim", jnet.n_pad)
    runs = []
    for kw in (drive, dict(seed=42, stim=1.0), {}):
        js, ts = jeng.init(**kw), eng.init(**kw)
        blocks = []
        for w in range(6):
            js, jb = jeng.window(js)
            ts, tb = eng.window(ts)
            assert_same(snapshot(ts, tb), snapshot(js, jb), (sorted(kw), w))
            blocks.append(tb)
        runs.append(torch.stack(blocks))
    assert np.array_equal(eng.init(**drive).seed.numpy(), drive["seed"].astype(np.int64))
    assert torch.equal(runs[1], runs[2]) and runs[2].any()
    assert not torch.equal(runs[0], runs[2])  # the per-neuron drive took effect


def test_init_seed_and_stim_refusals_match_jax():
    jnet, net = cross_networks()
    for cfg in (dict(neuron_model="ignore_and_fire"),
                dict(neuron_model="lif", schedule="structure_aware", superstep_kernel=True)):
        jeng = jax_make(jax_spec(**CROSS_SIZE), JaxConfig(**cfg), net=jnet)
        eng = make_simulation(mam_benchmark_spec(**CROSS_SIZE), EngineConfig(**cfg),
                              net=net, device="cpu")
        with pytest.raises(ValueError) as jerr:
            jeng.init(seed=1)
        with pytest.raises(ValueError) as err:
            eng.init(seed=1)
        assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Fault harness
# ---------------------------------------------------------------------------


def test_jitter_is_deterministic_and_matches_sync_model():
    cfg = faults_lib.FaultConfig(jitter_mu_ms=1.0, jitter_sigma_ms=0.2,
                                 jitter_devices=8, seed=3)
    inj = faults_lib.FaultInjector(cfg, n_devices=1, delay_ratio=10)
    twin = faults_lib.FaultInjector(cfg, n_devices=1, delay_ratio=10)
    draws = [inj.window_jitter_s(w) for w in range(300)]
    assert draws[7] == twin.window_jitter_s(7)
    predicted = inj.predicted_jitter_s()
    assert abs(np.mean(draws) / predicted - 1) < 0.10
    assert predicted > 10 * cfg.jitter_mu_ms * 1e-3


def test_injector_draws_and_predictions_equal_the_references():
    """Compute and comm draws keyed by (seed, window) and every prediction
    are the reference's, over fault plans with AR(1) and device counts."""
    for kw in (dict(jitter_mu_ms=1.6, jitter_sigma_ms=0.3, seed=9),
               dict(jitter_mu_ms=1.0, jitter_sigma_ms=0.1, jitter_rho=0.5,
                    jitter_devices=8, comm_mu_ms=12.0, comm_sigma_ms=1.0, seed=4),
               dict(comm_mu_ms=3.0, comm_sigma_ms=0.5, jitter_devices=16)):
        for n_devices in (1, 4):
            got = faults_lib.FaultInjector(faults_lib.FaultConfig(**kw),
                                           n_devices=n_devices, delay_ratio=10)
            want = jfaults.FaultInjector(jfaults.FaultConfig(**kw),
                                         n_devices=n_devices, delay_ratio=10)
            for w in range(0, 40, 3):
                assert got.window_jitter_s(w) == want.window_jitter_s(w), (kw, w)
                assert got.window_comm_jitter_s(w) == want.window_comm_jitter_s(w)
            for name in ("predicted_jitter_s", "predicted_comm_s",
                         "predicted_sequential_s", "predicted_overlap_s"):
                assert getattr(got, name)() == getattr(want, name)(), (kw, name)


def test_jitter_inflates_measured_window_times():
    """Each window's measured time holds its injected sleep (the draw of
    its window), and the plan on EngineConfig injects the same sleeps. Held
    per window against the draws rather than against an unjittered run,
    whose host times vary with the machine's load."""
    eng, _ = quick_engine()
    fcfg = faults_lib.FaultConfig(jitter_mu_ms=5.0, jitter_devices=4, seed=1)
    inj = faults_lib.FaultInjector(fcfg, n_devices=1, delay_ratio=eng.delay_ratio)
    jit = schedule_lib.run_windows(eng, eng.init(), 4, faults=inj)
    draws = [inj.window_jitter_s(w) for w in range(1, 5)]
    assert jit.injected_sleep_s > 0.15  # 4 windows x D=10 x 5 ms
    assert jit.injected_sleep_s == pytest.approx(sum(draws), rel=1e-12)
    assert all(t >= d for t, d in zip(jit.window_times_s, draws))
    eng2, _ = quick_engine(faults=fcfg)  # the plan rides on EngineConfig too
    jit2 = schedule_lib.run_windows(eng2, eng2.init(), 4)
    assert jit2.injected_sleep_s == pytest.approx(jit.injected_sleep_s)


def test_transient_ckpt_failures_are_survived(tmp_path):
    from repro_torch.checkpoint import manager as ckpt_manager

    eng, net = quick_engine()
    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(ckpt_write_failures=2),
                                   n_devices=1, delay_ratio=eng.delay_ratio)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=2,
                                        injector=inj, backoff_s=0.01)
    schedule_lib.run_windows(eng, eng.init(), 4, checkpointer=ckpt, faults=inj)
    ckpt.close()
    assert ckpt.retry_count == 2
    assert inj.ckpt_failures_injected == 2
    assert ckpt_manager.latest_step(str(tmp_path)) == 4


def test_fault_spec_grammar_round_trip():
    cfg = faults_lib.parse_fault_specs(
        ["jitter:mu_ms=1.6,sigma_ms=0.3,comm_mu_ms=12.5,comm_sigma_ms=2.0,"
         "rho=0.5,devices=16", "ckpt-io:fails=2", "preempt:window=12"], seed=9)
    specs = faults_lib.format_fault_specs(cfg)
    assert specs == [
        "jitter:mu_ms=1.6,sigma_ms=0.3,comm_mu_ms=12.5,comm_sigma_ms=2.0,"
        "rho=0.5,devices=16", "ckpt-io:fails=2", "preempt:window=12"]
    assert faults_lib.parse_fault_specs(specs, seed=9) == cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfaults.parse_fault_specs(
        specs, seed=9))
    assert faults_lib.format_fault_specs(faults_lib.FaultConfig()) == []
    partial = faults_lib.FaultConfig(comm_mu_ms=3.0, preempt_after_window=4)
    assert faults_lib.format_fault_specs(partial) == [
        "jitter:comm_mu_ms=3.0", "preempt:window=4"]
    assert faults_lib.parse_fault_specs(faults_lib.format_fault_specs(partial)) == partial
    merged = faults_lib.parse_fault_specs(["jitter:mu_ms=1.0", "jitter:sigma_ms=0.5"])
    assert merged.jitter_mu_ms == 1.0 and merged.jitter_sigma_ms == 0.5


MALFORMED = [
    ["meteor:size=large"], ["jitter:"], ["jitter"], ["jitter:mu_ms=1.6,turbo"],
    ["jitter:mu_ms=fast"], ["jitter:mu=1.6"], ["ckpt-io:"], ["ckpt-io:fails=two"],
    ["preempt:"], ["preempt:window=1,when=now"], ["preempt:window=1.5"],
]


@pytest.mark.parametrize("specs", MALFORMED, ids=[s[0] for s in MALFORMED])
def test_fault_spec_errors_equal_the_references(specs):
    with pytest.raises(ValueError) as jerr:
        jfaults.parse_fault_specs(specs)
    with pytest.raises(ValueError) as err:
        faults_lib.parse_fault_specs(specs)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Overlap (tests/test_overlap.py, single host)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_overlap_checkpoint_midrun_resume(tmp_path, adaptive):
    """An overlapped run preempted mid-pipeline drains before each save, so
    the checkpoint resumes bitwise in a sequential and an overlapped
    engine alike."""
    seq, net = quick_engine(adaptive_exchange=adaptive)
    ovl, _ = quick_engine(adaptive_exchange=adaptive, overlap_exchange=True)
    ref = schedule_lib.run_windows(seq, seq.init(), 8)
    inj = faults_lib.FaultInjector(faults_lib.FaultConfig(preempt_after_window=5),
                                   n_devices=1, delay_ratio=ovl.delay_ratio)
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), ovl, net, every=3, injector=inj)
    with pytest.raises(faults_lib.Preempted) as exc_info:
        schedule_lib.run_windows(ovl, ovl.init(), 8, checkpointer=ckpt, faults=inj)
    assert exc_info.value.window == 5 and exc_info.value.result.drains == 2
    for resumer, tag in ((seq, "sequential"), (ovl, "overlapped")):
        st, info = schedule_lib.restore_sim(str(tmp_path), resumer, net)
        assert info["step"] == 5, tag
        res = schedule_lib.run_windows(resumer, st, 3)
        assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[5:]), tag
        assert_states_equal(res.state, ref.state, tag)


def test_overlap_jitter_wall_max_vs_sum():
    """Sequential sleeps sum(comp + comm); the pipeline comp_1 +
    sum(max(comp_w, comm_{w-1})) + comm_n; both within 15% of the sync
    model. Shorter than the reference's 40 windows: the sums are exact."""
    seq, _ = quick_engine()
    ovl, _ = quick_engine(overlap_exchange=True)
    n = 16
    fcfg = faults_lib.FaultConfig(jitter_mu_ms=0.5, jitter_sigma_ms=0.05,
                                  jitter_devices=8, comm_mu_ms=6.0, comm_sigma_ms=0.5,
                                  seed=4)

    def injector():
        return faults_lib.FaultInjector(fcfg, n_devices=4, delay_ratio=seq.delay_ratio)

    res_seq = schedule_lib.run_windows(seq, seq.init(), n, faults=injector())
    res_ovl = schedule_lib.run_windows(ovl, ovl.init(), n, faults=injector())
    assert np.array_equal(res_ovl.spikes_per_window, res_seq.spikes_per_window)
    twin = injector()
    comp = [twin.window_jitter_s(w) for w in range(1, n + 1)]
    comm = [twin.window_comm_jitter_s(w) for w in range(1, n + 1)]
    want_seq = sum(c + x for c, x in zip(comp, comm))
    want_ovl = comp[0] + sum(max(comp[w], comm[w - 1]) for w in range(1, n)) + comm[-1]
    assert res_seq.injected_sleep_s == pytest.approx(want_seq, rel=1e-9)
    assert res_ovl.injected_sleep_s == pytest.approx(want_ovl, rel=1e-9)
    assert res_ovl.injected_sleep_s < res_seq.injected_sleep_s
    inj = injector()
    pred_seq = n * (inj.predicted_jitter_s() + inj.predicted_comm_s())
    pred_ovl = sync_model.expected_wall_overlapped(
        n, inj.predicted_jitter_s(), np.sqrt(seq.delay_ratio) * inj.model.sigma,
        inj.predicted_comm_s(), fcfg.comm_sigma_ms * 1e-3)
    assert abs(res_seq.injected_sleep_s / pred_seq - 1) < 0.15
    assert abs(res_ovl.injected_sleep_s / pred_ovl - 1) < 0.15
