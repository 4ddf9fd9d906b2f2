"""The port's launcher against the JAX package's CLI, on the CPU.

``python -m repro_torch.launch.simulate --device cpu`` and ``python -m
repro.launch.simulate`` run as subprocesses with the same small flags (4
areas x 64 neurons, K 16; the MAM at scale 0.002): equal exit codes, equal
header lines and comparison verdicts, and bitwise-equal ``--spikes-out``.
Checkpoints cross between the two CLIs (preempt in one, resume in the
other; LIF on the MAM, spiking on both sides of the preemption). Both
refuse the same flag conflicts with the same exit. A real
SIGTERM stops the port's run loop at a window boundary. The JAX CLI runs on
one CPU device (``XLA_FLAGS`` cleared, ``JAX_PLATFORMS=cpu``), except in
the process-group case: there the port's CLI runs on four ranks under
``torch.distributed.run`` and the JAX CLI on four forced host devices.
"""

import os
import re
import signal
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import simulate as jsim  # noqa: E402
from repro_torch.launch import simulate as tsim  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--areas", "4", "--n-per-area", "64", "--k", "16"]
MAM = ["--model", "mam", "--scale", "0.002"]  # LIF by default; spikes from window 9
# name -> flags, run by both CLIs
FLAG_SETS = {
    "onehot-compare": SMALL + ["--backend", "onehot", "--compare", "--t-ms", "20"],
    "pallas-lif": SMALL + ["--backend", "pallas", "--neuron", "lif", "--t-ms", "40"],
    "event-compare-all": SMALL + ["--backend", "event", "--compare", "--compare-adaptive",
                                  "--compare-overlap", "--t-ms", "20"],
    "mam-lif": ["--model", "mam", "--scale", "0.002", "--t-ms", "30"],  # scatter
}
# The resilient leg: LIF on event, adaptive, overlapped, checkpointing
# every 4 windows, preempted after window 12, so the ring carries spikes
# across the preemption. Its uninterrupted twin, the flag set
# "event-lif-checkpointed", goes through the same run loop into a directory
# of its own (CKPT_DIR); the two runs' last checkpoints hold every state
# leaf at window 20.
RESILIENT = MAM + ["--backend", "event", "--adaptive", "--overlap", "--t-ms", "20",
                   "--checkpoint-every", "4"]
CKPT_DIR = "<a checkpoint directory per run>"
FLAG_SETS["event-lif-checkpointed"] = RESILIENT + ["--checkpoint-dir", CKPT_DIR]
PREEMPT_AT, LAST = 12, 20


def run_cli(package, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", f"{package}.launch.simulate", *args]
    if package == "repro_torch":
        cmd += ["--device", "cpu"]
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)


def preempt_then_resume(writer, reader, directory, spikes):
    """``writer``'s CLI preempted at window 12, ``reader``'s CLI resuming."""
    ck = ["--checkpoint-dir", directory]
    first = run_cli(writer, RESILIENT + ck + ["--inject-fault", f"preempt:window={PREEMPT_AT}"])
    second = run_cli(reader, RESILIENT + ck + ["--resume", "--spikes-out", spikes])
    return first, second


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run of this module, six at a time."""
    out = tmp_path_factory.mktemp("cli")
    jobs = {}
    with ThreadPoolExecutor(6) as pool:
        for writer, reader in (("repro_torch", "repro"), ("repro", "repro_torch")):
            jobs["resume", writer] = pool.submit(
                preempt_then_resume, writer, reader, str(out / f"ck-{writer}"),
                str(out / f"resumed-{writer}.npz"))
        for name, flags in FLAG_SETS.items():
            for package in ("repro", "repro_torch"):
                tag = f"{name}-{package}"
                args = [str(out / tag) if f == CKPT_DIR else f for f in flags]
                jobs[name, package] = pool.submit(
                    run_cli, package, args + ["--spikes-out", str(out / f"{tag}.npz")])
        return out, {k: v.result() for k, v in jobs.items()}


def verdicts(stdout: str) -> list[str]:
    """The header and every comparison verdict line."""
    lines = stdout.splitlines()
    return lines[:1] + [ln.strip() for ln in lines if "spike counts (" in ln]


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_cli_matches_the_jax_cli(runs, name):
    out, results = runs
    want, got = results[name, "repro"], results[name, "repro_torch"]
    assert want.returncode == 0, want.stderr
    assert got.returncode == want.returncode, got.stderr
    assert verdicts(got.stdout) == verdicts(want.stdout)
    a, b = np.load(out / f"{name}-repro_torch.npz"), np.load(out / f"{name}-repro.npz")
    assert int(a["t"]) == int(b["t"]) > 0
    assert np.array_equal(a["spike_count"], b["spike_count"])
    assert a["spike_count"].sum() > 0


@pytest.mark.parametrize("writer", ["repro_torch", "repro"])
def test_a_cli_checkpoint_resumes_in_the_other_cli(runs, writer):
    """Preempted at window 12 by one CLI (exit 0, the PREEMPTED line),
    resumed by the other: the spike counts equal the uninterrupted run's,
    and so does every state leaf of the last checkpoint, the ring included
    (at this size a changed ring need not change a spike count). LIF spikes
    on both sides of the preemption."""
    out, results = runs
    first, second = results["resume", writer]
    assert first.returncode == 0, first.stderr
    assert f"PREEMPTED (simulated preemption) after window {PREEMPT_AT}" in first.stdout
    assert second.returncode == 0, second.stderr
    assert f"resumed window {PREEMPT_AT}" in second.stdout
    got = np.load(out / f"resumed-{writer}.npz")
    want = np.load(out / "event-lif-checkpointed-repro.npz")
    assert int(got["t"]) == int(want["t"])
    assert np.array_equal(got["spike_count"], want["spike_count"])
    ck = out / f"ck-{writer}"
    saved = np.load(ck / f"step_{PREEMPT_AT:08d}" / "arrays.npz")
    assert 0 < int(saved[".spike_count"].sum()) < int(want["spike_count"].sum())
    last = np.load(ck / f"step_{LAST:08d}" / "arrays.npz")
    twin = np.load(out / "event-lif-checkpointed-repro" / f"step_{LAST:08d}" / "arrays.npz")
    assert sorted(last.files) == sorted(twin.files)
    assert {".ring", ".neuron/.v", ".neuron/.i_syn"} <= set(last.files)
    for key in twin.files:
        assert last[key].dtype == twin[key].dtype, key
        assert np.array_equal(last[key], twin[key]), key


# The process-group leg: four ranks (torch.distributed.run, gloo on the
# CPU) against the JAX CLI on four forced host devices; both pick the (4, 1)
# mesh. Preempted after window 3 with the wire-volume table, then resumed.
GROUP = ["--areas", "4", "--n-per-area", "32", "--k", "8", "--exchange", "routed",
         "--backend", "event", "--t-ms", "6"]


def run_on_four(package, args):
    """``package``'s CLI on four ranks (the port) or four devices (JAX)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    if package == "repro_torch":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", "-m", "repro_torch.launch.simulate", *args,
               "--device", "cpu"]
        env.pop("XLA_FLAGS", None)
    else:
        cmd = [sys.executable, "-m", "repro.launch.simulate", *args]
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)


def preempt_resume_on_four(package, out):
    ck = ["--checkpoint-dir", str(out / f"ck-{package}")]
    first = run_on_four(package, GROUP + ck + ["--inject-fault", "preempt:window=3",
                                               "--profile"])
    second = run_on_four(package, GROUP + ck + ["--resume", "--spikes-out",
                                                str(out / f"{package}.npz")])
    return first, second


def wire_volume_lines(stdout: str) -> list[str]:
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("-- wire volume"))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("-- inter receive tables"))
    return lines[start:end + 1]


def test_cli_on_a_process_group_matches_the_jax_cli_on_four_devices(tmp_path):
    """The port's CLI on four gloo ranks, routed exchange on ``event``,
    checkpointing and preempted after window 3 with ``--profile``, then
    resumed: the same exit codes as the JAX CLI on four forced host
    devices, its wire-volume table line for line, one checkpoint written
    (rank 0 alone prints), and a ``--spikes-out`` file bitwise the JAX
    CLI's."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {p: pool.submit(preempt_resume_on_four, p, tmp_path)
                for p in ("repro", "repro_torch")}
        (j1, j2), (t1, t2) = jobs["repro"].result(), jobs["repro_torch"].result()
    for want, got in ((j1, t1), (j2, t2)):
        assert want.returncode == 0, want.stderr[-3000:]
        assert got.returncode == want.returncode, got.stderr[-3000:]
    assert "mesh: 4 area groups x 1 subgroup devices" in t1.stdout
    assert t1.stdout.count("PREEMPTED (simulated preemption) after window 3") == 1
    assert wire_volume_lines(t1.stdout) == wire_volume_lines(j1.stdout)
    assert t2.stdout.count("resumed window 3") == 1
    # The resumed leg's wire as comm counts it is the static accounting,
    # which the JAX CLI reports from its engine's counter.
    static = re.findall(r"([\d,]+) wire B/window", t2.stdout)
    measured = re.findall(r"([\d,]+) measured B/window", t2.stdout)
    assert len(static) == 1, t2.stdout
    assert static == measured == re.findall(r"([\d,]+) measured B/window", j2.stdout)
    a, b = np.load(tmp_path / "repro_torch.npz"), np.load(tmp_path / "repro.npz")
    assert int(a["t"]) == int(b["t"]) > 0
    assert np.array_equal(a["spike_count"], b["spike_count"]) and a["spike_count"].sum() > 0
    saved = np.load(tmp_path / "ck-repro_torch" / "step_00000003" / "arrays.npz")
    assert saved[".ring"].shape == np.load(
        tmp_path / "ck-repro" / "step_00000003" / "arrays.npz")[".ring"].shape


REFUSALS = {
    "compare+checkpoint": ["--compare", "--checkpoint-dir", "/nonexistent"],
    "resume-without-dir": ["--resume"],
    "inject+compare-overlap+compare": ["--compare-overlap", "--compare",
                                       "--inject-fault", "jitter:mu_ms=1"],
    "compare-overlap+preempt": ["--compare-overlap", "--inject-fault", "preempt:window=2"],
    "overlap+conventional": ["--overlap", "--schedule", "conventional"],
    "sharded-build-scatter": ["--sharded-build"],
    "sharded-build-replicated": ["--sharded-build", "--backend", "event",
                                 "--replicated-inter-tables"],
    "sharded-build-one-device": ["--sharded-build", "--backend", "event"],
    "bad-choice": ["--schedule", "bogus"],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_both_clis_refuse_the_same_conflicts(monkeypatch, capsys, name):
    argv = SMALL + REFUSALS[name]
    monkeypatch.setattr(sys, "argv", ["simulate", *argv])
    with pytest.raises(SystemExit) as jerr:
        jsim.main()
    with pytest.raises(SystemExit) as err:
        tsim.main(argv + ["--device", "cpu"])
    assert err.value.code == jerr.value.code
    assert err.value.code not in (0, None)
    capsys.readouterr()


def test_cli_raises_without_a_gpu(monkeypatch):
    """The default device is the GPU: with none, the launcher raises
    instead of carrying on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsim.main(SMALL + ["--t-ms", "2"])


def test_sigterm_checkpoints_at_window_boundary(tmp_path):
    """A real SIGTERM mid-run lands the grace checkpoint at the next window
    boundary (exit 0), and the resumed trajectory equals an uninterrupted
    run. The port alone: the script imports nothing of the JAX package."""
    from repro_torch.core import (
        EngineConfig, build_network, make_simulation, mam_benchmark_spec,
    )
    from repro_torch.core import schedule as schedule_lib

    script = textwrap.dedent(f"""
        import sys
        from repro_torch.core import faults as faults_lib
        from repro_torch.core import schedule as schedule_lib
        from repro_torch.core import (EngineConfig, build_network, make_simulation,
                                      mam_benchmark_spec)
        from repro_torch.launch.simulate import StopFlag

        spec = mam_benchmark_spec(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)
        net = build_network(spec, seed=12, outgoing=True, device="cpu")
        eng = make_simulation(spec, EngineConfig(
            neuron_model="lif", delivery_backend="event", s_max_floor=4,
            overlap_exchange=True), net=net, device="cpu")
        stop = StopFlag().install()
        inj = faults_lib.FaultInjector(
            faults_lib.FaultConfig(jitter_mu_ms=25.0, seed=1),
            n_devices=1, delay_ratio=eng.delay_ratio)
        ck = schedule_lib.SimCheckpointer(r"{tmp_path}", eng, net, every=0)
        try:
            schedule_lib.run_windows(
                eng, eng.init(), 200, checkpointer=ck, faults=inj,
                stop_requested=stop,
                on_window=lambda w, s: print(f"W{{w}}", flush=True))
        except faults_lib.Preempted as e:
            print(f"PREEMPTED {{e.window}} {{stop.name}}", flush=True)
            assert "jax" not in sys.modules
            sys.exit(0)
        raise SystemExit("the run drained 200 windows without the signal")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-u", "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.monotonic() + 240
        for line in proc.stdout:
            if line.startswith("W") and int(line[1:]) >= 3:
                proc.send_signal(signal.SIGTERM)
                break
            assert time.monotonic() < deadline, "no window marker seen"
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    preempted = [ln for ln in out.splitlines() if ln.startswith("PREEMPTED")]
    assert preempted, f"no graceful preemption line in:\n{out}\n{err}"
    _, window, signame = preempted[0].split()
    assert signame == "SIGTERM"
    stopped_at = int(window)
    assert stopped_at >= 3

    spec = mam_benchmark_spec(n_areas=2, n_per_area=32, k_intra=4, k_inter=4)
    net = build_network(spec, seed=12, outgoing=True, device="cpu")
    eng = make_simulation(spec, EngineConfig(  # sequential: overlap is a layout key
        neuron_model="lif", delivery_backend="event", s_max_floor=4), net=net, device="cpu")
    ref = schedule_lib.run_windows(eng, eng.init(), stopped_at + 3)
    st, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == stopped_at
    res = schedule_lib.run_windows(eng, st, 3)
    assert np.array_equal(res.spikes_per_window, ref.spikes_per_window[stopped_at:])
    for a, b in ((res.state.ring, ref.state.ring),
                 (res.state.spike_count, ref.state.spike_count),
                 (res.state.neuron.v, ref.state.neuron.v)):
        assert torch.equal(a, b)
