"""The port's training CLI against the JAX CLI on the CPU.

Both CLIs draw their initial weights from their own generators, so each
comparison starts both from one JAX checkpoint of step 0 (the JAX CLI run
with ``--steps 0``) through ``--resume``. The hierarchical trainer's int8
slow tier also reads the fresh init (its anchor, which neither CLI
checkpoints), so ``jax_init`` gives the port's CLI the JAX CLI's initial
weights as well. Printed losses agree within 1e-4 (they print 4 decimals),
and the ``improved`` verdict is the same. Checkpoints cross: a JAX
checkpoint of step 3 resumed by the port's CLI to step 6, and a port
checkpoint resumed by the JAX CLI, give the uninterrupted runs' losses, for
the sync trainer and for int8 pods whose first sync comes after the resume.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro_torch.launch.train as ttrain
from repro.configs.registry import get_arch as jget_arch
from repro_torch.models.transformer import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "6", "--global-batch", "4",
        "--seq-len", "16", "--log-every", "1", "--lr", "1e-3", "--ckpt-every", "3",
        "--resume"]
HIER = ["--pods", "2", "--compression", "int8", "--sync-every", "3"]
STEP = re.compile(r"^step\s+(\d+) loss\s+([-\d.]+) gnorm\s+([-\d.]+)", re.M)
FINAL = re.compile(r"^loss ([-\d.nan]+) -> ([-\d.nan]+) \((improved|NOT improved)\)", re.M)


def run_jax(argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    jtrain.main()
    return capsys.readouterr().out


def run_port(argv, capsys) -> str:
    ttrain.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def losses(out: str) -> dict[int, float]:
    return {int(s): float(v) for s, v, _ in STEP.findall(out)}


def verdict(out: str) -> str:
    return FINAL.search(out).group(3)


def same_losses(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for step, v in want.items():
        assert abs(got[step] - v) <= 1e-4 + 1e-9, (step, got[step], v)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's CLI draws the JAX CLI's initial weights (``PRNGKey(0)``),
    so both build the same slow-tier anchor."""
    real = ttrain.get_arch

    def get_arch(name, reduced=False):
        bundle = real(name, reduced=reduced)
        tree = jax.tree.map(np.asarray,
                            jget_arch(name, reduced=reduced).model.init_params(
                                jax.random.PRNGKey(0)))
        made = bundle.model.init_params

        def init_params(gen, **kw):
            if gen is None:  # the shapes alone
                return made(gen, **kw)
            return params_from_numpy(bundle.cfg, tree, device=gen.device)

        monkeypatch.setattr(bundle.model, "init_params", init_params)
        return bundle

    monkeypatch.setattr(ttrain, "get_arch", get_arch)


def step0(d, extra, monkeypatch, capsys):
    """``d`` holding the JAX CLI's checkpoint of step 0 (its init), of the
    trainer ``extra`` asks for."""
    with pytest.warns(RuntimeWarning):  # the mean of no losses
        run_jax(["--arch", "qwen2-0.5b", "--reduced", "--steps", "0", "--ckpt-dir", str(d),
                 *extra], monkeypatch, capsys)
    assert (d / "step_00000000").is_dir()
    return d


@pytest.mark.parametrize("mode", ["sync", "hier_int8"])
def test_cli_matches_the_jax_cli(mode, tmp_path, monkeypatch, capsys, jax_init):
    """6 steps from the same step-0 checkpoint: the same printed losses at
    every step and the same verdict; with ``--pods 2 --compression int8
    --sync-every 3``, two int8 syncs on the way."""
    extra = HIER if mode == "hier_int8" else []
    grid = 2 * 1e-3 * 6 / 127 if "int8" in extra else 0.0
    dj, dp = tmp_path / "jax", tmp_path / "port"
    step0(dj, extra, monkeypatch, capsys)
    shutil.copytree(dj, dp)
    out_j = run_jax([*BASE, *extra, "--ckpt-dir", str(dj)], monkeypatch, capsys)
    out_p = run_port([*BASE, *extra, "--ckpt-dir", str(dp)], capsys)
    assert "resumed from step 0" in out_j and "resumed from step 0" in out_p
    same_losses(losses(out_p), losses(out_j))
    assert sorted(losses(out_p)) == [1, 2, 3, 4, 5, 6]
    assert verdict(out_p) == verdict(out_j)
    assert sorted(p.name for p in dp.iterdir()) == sorted(p.name for p in dj.iterdir())


def cross(tmp_path, extra, monkeypatch, capsys) -> None:
    """Each CLI resumes the other's step-3 checkpoint and runs steps 4-6 as
    the uninterrupted run of the other did: the same printed losses, and
    step-6 parameters within 1e-5 of the largest. An int8 sync can put an
    element that lies near a rounding boundary one grid step away
    (``2 * lr * steps / 127``; the two CLIs' uninterrupted runs differ so
    in ~7% of the elements), so after one the bar is that step more."""
    grid = 2 * 1e-3 * 6 / 127 if "int8" in extra else 0.0
    dj, dp = tmp_path / "jax", tmp_path / "port"
    step0(dj, extra, monkeypatch, capsys)
    shutil.copytree(dj, dp)
    full_j = losses(run_jax([*BASE, *extra, "--ckpt-dir", str(dj)], monkeypatch, capsys))
    full_p = losses(run_port([*BASE, *extra, "--ckpt-dir", str(dp)], capsys))
    same_losses(full_p, full_j)
    for src, name in ((dj, "from_jax"), (dp, "from_port")):
        d = tmp_path / name
        d.mkdir()
        shutil.copytree(src / "step_00000003", d / "step_00000003")
        argv = [*BASE, *extra, "--ckpt-dir", str(d)]
        out = run_port(argv, capsys) if name == "from_jax" else \
            run_jax(argv, monkeypatch, capsys)
        assert "resumed from step 3" in out
        want, full = (full_j, dj) if name == "from_jax" else (full_p, dp)
        same_losses(losses(out), {s: v for s, v in want.items() if s > 3})
        with np.load(d / "step_00000006" / "arrays.npz") as got, \
                np.load(full / "step_00000006" / "arrays.npz") as ref:
            keys = [k for k in ref.files if "params" in k]
            top = max(np.abs(ref[k]).max() for k in keys)
            assert sorted(got.files) == sorted(ref.files)
            for k in keys:
                assert np.abs(got[k] - ref[k]).max() <= 1e-5 * top + grid, (name, k)


def test_checkpoints_cross_between_the_clis(tmp_path, monkeypatch, capsys):
    """The sync trainer's checkpoints cross both ways."""
    cross(tmp_path, [], monkeypatch, capsys)


def test_int8_pod_checkpoints_cross_between_the_clis(tmp_path, monkeypatch, capsys, jax_init):
    """``--pods 2 --compression int8 --sync-every 4``: the step-4 sync after
    the resume reads the anchor, which both CLIs take from their fresh init
    (the same weights here), not from the restored pods. The port's CLI
    resuming its own step-3 checkpoint writes the uninterrupted run's step-6
    checkpoint bitwise."""
    extra = ["--pods", "2", "--compression", "int8", "--sync-every", "4"]
    cross(tmp_path, extra, monkeypatch, capsys)
    d = tmp_path / "own"
    d.mkdir()
    shutil.copytree(tmp_path / "port" / "step_00000003", d / "step_00000003")
    assert "resumed from step 3" in run_port([*BASE, *extra, "--ckpt-dir", str(d)], capsys)
    with np.load(d / "step_00000006" / "arrays.npz") as got, \
            np.load(tmp_path / "port" / "step_00000006" / "arrays.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert np.array_equal(got[k], ref[k]), k


def test_train_lm_runs_on_the_cpu():
    """The two-phase crash-and-resume example of the hierarchical trainer."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_lm", "--device", "cpu", "--steps", "10"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "resumed from step 5" in out.stdout
    assert "done: hierarchical (D=5, int8+EF) training with crash-resume." in out.stdout


def test_cli_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
