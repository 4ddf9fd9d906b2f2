"""The port's training CLI on the six non-dense families against the JAX
CLI on the CPU.

As in ``test_torch_train_cli``, both CLIs start from one JAX checkpoint of
step 0 (the JAX CLI run with ``--steps 0``) through ``--resume``, and their
printed losses agree within 1e-4 (they print 4 decimals). whisper and
internvl train on the stub frontends' zeros in both CLIs; mamba2's
checkpoints cross both ways. Every one of the ten architectures trains
through the port's CLI, writes the JAX CLI's checkpoint keys (each model's
own stacks), and resumes its own checkpoint bitwise; a checkpoint written
in the background holds its own step's state.
"""

import shutil
import time

import jax
import numpy as np
import pytest

from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import list_archs
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from test_torch_train_cli import losses, run_jax, run_port, same_losses, verdict

SMALL = ["--reduced", "--global-batch", "2", "--seq-len", "16", "--log-every", "1",
         "--lr", "1e-3", "--resume"]


def step0(d, arch, monkeypatch, capsys):
    """``d`` holding the JAX CLI's checkpoint of step 0 (its init) of ``arch``."""
    with pytest.warns(RuntimeWarning):  # the mean of no losses
        run_jax(["--arch", arch, "--reduced", "--steps", "0", "--ckpt-dir", str(d)],
                monkeypatch, capsys)
    assert (d / "step_00000000").is_dir()
    return d


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_cli_matches_the_jax_cli(arch, tmp_path, monkeypatch, capsys):
    """4 steps from the same step-0 checkpoint, the stub inputs zeros on
    both sides: the same printed losses at every step, the same verdict
    and the same checkpoint files."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    step0(dj, arch, monkeypatch, capsys)
    shutil.copytree(dj, dp)
    argv = ["--arch", arch, "--steps", "4", "--ckpt-every", "2", *SMALL]
    out_j = run_jax([*argv, "--ckpt-dir", str(dj)], monkeypatch, capsys)
    out_p = run_port([*argv, "--ckpt-dir", str(dp)], capsys)
    assert "resumed from step 0" in out_j and "resumed from step 0" in out_p
    same_losses(losses(out_p), losses(out_j))
    assert sorted(losses(out_p)) == [1, 2, 3, 4]
    assert verdict(out_p) == verdict(out_j)
    assert sorted(p.name for p in dp.iterdir()) == sorted(p.name for p in dj.iterdir())


def test_mamba2_checkpoints_cross_between_the_clis(tmp_path, monkeypatch, capsys):
    """Each CLI resumes the other's mamba2 checkpoint of step 2 (its layer
    leaves stacked ``[n_layers, ...]`` under ``layers``, no ``sub_0``) and
    runs steps 3-4 as the other's uninterrupted run did: the same printed
    losses, the same array keys, and step-4 parameters within 1e-5 of the
    largest."""
    arch = "mamba2-2.7b"
    argv = ["--arch", arch, "--steps", "4", "--ckpt-every", "2", *SMALL]
    dj, dp = tmp_path / "jax", tmp_path / "port"
    step0(dj, arch, monkeypatch, capsys)
    shutil.copytree(dj, dp)
    full_j = losses(run_jax([*argv, "--ckpt-dir", str(dj)], monkeypatch, capsys))
    full_p = losses(run_port([*argv, "--ckpt-dir", str(dp)], capsys))
    same_losses(full_p, full_j)
    with np.load(dp / "step_00000002" / "arrays.npz") as got, \
            np.load(dj / "step_00000002" / "arrays.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        assert "['opt']/['m']/['layers']/['A_log']" in got.files
    for src, name in ((dj, "from_jax"), (dp, "from_port")):
        d = tmp_path / name
        d.mkdir()
        shutil.copytree(src / "step_00000002", d / "step_00000002")
        run = [*argv, "--ckpt-dir", str(d)]
        out = run_port(run, capsys) if name == "from_jax" else run_jax(run, monkeypatch, capsys)
        assert "resumed from step 2" in out
        want, full = (full_j, dj) if name == "from_jax" else (full_p, dp)
        same_losses(losses(out), {s: v for s, v in want.items() if s > 2})
        with np.load(d / "step_00000004" / "arrays.npz") as got, \
                np.load(full / "step_00000004" / "arrays.npz") as ref:
            keys = [k for k in ref.files if "params" in k]
            top = max(np.abs(ref[k]).max() for k in keys)
            assert sorted(got.files) == sorted(ref.files)
            for k in keys:
                assert np.abs(got[k] - ref[k]).max() <= 1e-5 * top, (name, k)


def _jax_checkpoint_keys(arch) -> list[str]:
    """The keys the JAX CLI's checkpoint of ``arch`` holds (its manager
    joins each leaf's path, ``['params']/['layers']/...``)."""
    jb = jget_arch(arch, reduced=True)
    spec = jax.eval_shape(jb.model.init_params, jax.random.PRNGKey(0))
    state = {"params": spec, "opt": jax.eval_shape(
        lambda p: jadamw_init(p, JAdamWConfig(moment_dtype=jb.moment_dtype)), spec)}
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return sorted("/".join(str(p) for p in path) for path, _ in leaves)


@pytest.mark.parametrize("arch", list_archs())
def test_cli_trains_every_architecture_and_resumes_bitwise(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <id> --reduced --device
    cpu`` for every architecture: finite losses at each step, a checkpoint
    with the JAX CLI's keys, and a resume of its step-1 checkpoint that
    prints the uninterrupted run's step-2 loss and writes its step-2
    checkpoint bitwise."""
    argv = ["--arch", arch, "--steps", "2", "--ckpt-every", "1", *SMALL]
    full = losses(run_port([*argv, "--ckpt-dir", str(tmp_path / "full")], capsys))
    assert sorted(full) == [1, 2] and all(np.isfinite(v) for v in full.values())
    d = tmp_path / "cut"
    d.mkdir()
    shutil.copytree(tmp_path / "full" / "step_00000001", d / "step_00000001")
    out = run_port([*argv, "--ckpt-dir", str(d)], capsys)
    assert "resumed from step 1" in out
    assert losses(out) == {2: full[2]}
    with np.load(d / "step_00000002" / "arrays.npz") as got, \
            np.load(tmp_path / "full" / "step_00000002" / "arrays.npz") as ref:
        assert sorted(ref.files) == _jax_checkpoint_keys(arch)
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert np.array_equal(got[k], ref[k]), k


def test_a_checkpoint_holds_its_own_steps_state_while_training_goes_on(
        tmp_path, monkeypatch, capsys):
    """The step updates the parameters and the optimizer state in place, and
    the writer saves in the background: with a writer that lags a step
    behind (each save held back 0.5 s), every checkpoint still holds the
    state of its own step (its count, and the parameters a resume from it
    steps on to the uninterrupted run's)."""
    from repro_torch.checkpoint import manager

    save = manager.save

    def slow_save(*args, **kwargs):
        time.sleep(0.5)
        return save(*args, **kwargs)

    monkeypatch.setattr(manager, "save", slow_save)
    argv = ["--arch", "mamba2-2.7b", "--steps", "3", "--ckpt-every", "1", *SMALL]
    full = losses(run_port([*argv, "--ckpt-dir", str(tmp_path / "full")], capsys))
    for step in (1, 2, 3):
        with np.load(tmp_path / "full" / f"step_{step:08d}" / "arrays.npz") as z:
            assert int(z["['opt']/['count']"]) == step
    d = tmp_path / "cut"
    d.mkdir()
    shutil.copytree(tmp_path / "full" / "step_00000001", d / "step_00000001")
    monkeypatch.setattr(manager, "save", save)
    assert losses(run_port([*argv, "--ckpt-dir", str(d)], capsys)) == \
        {s: v for s, v in full.items() if s > 1}
