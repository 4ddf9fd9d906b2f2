"""The port's checkpoint manager against the JAX package's, on the CPU.

The cases of ``tests/test_checkpoint.py`` on ``repro_torch.checkpoint.
manager`` (atomic save / restore, the async writer's retries and garbage
collection), and the on-disk format across the packages: a tree saved by
either restores in the other, bf16 included. Tolerance: bitwise, dtypes
equal.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jckpt  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402


@pytest.fixture()
def tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
        "opt": {"m": {"w": torch.zeros((3, 4))}, "count": np.int32(7)},
    }


def flat(tree) -> list:
    return [leaf for _, leaf in ckpt._leaves(tree)]


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


def test_save_restore_roundtrip(tmp_path, tree):
    path = ckpt.save(str(tmp_path), 42, tree, extra={"note": "test"})
    assert os.path.isdir(path)
    restored, step = ckpt.restore(str(tmp_path), like=tree)
    assert step == 42
    assert all(same(a, b) for a, b in zip(flat(tree), flat(restored)))


def test_restore_onto_meta_templates_and_a_device(tmp_path, tree):
    """A template of meta tensors holds no memory; the arrays load onto the
    device asked for."""
    ckpt.save(str(tmp_path), 1, tree)
    like = ckpt._rebuild(tree, lambda k, x: x.to("meta") if isinstance(x, torch.Tensor)
                         else x)
    restored, _ = ckpt.restore(str(tmp_path), like=like, device="cpu")
    assert all(same(a, b) for a, b in zip(flat(tree), flat(restored)))


def test_latest_step_and_explicit_step(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    _, step = ckpt.restore(str(tmp_path), like=tree, step=1)
    assert step == 1


def test_restore_shape_mismatch_raises(tmp_path, tree):
    ckpt.save(str(tmp_path), 0, tree)
    bad = ckpt._rebuild(tree, lambda k, x: torch.zeros((9,) + tuple(np.shape(x))))
    with pytest.raises(ValueError, match="elastic_pod_resize"):
        ckpt.restore(str(tmp_path), like=bad)


def test_no_checkpoint_raises(tmp_path, tree):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), like=tree)


def test_async_writer_and_gc(tmp_path, tree):
    w = ckpt.AsyncWriter(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        w.submit(step, tree)
    w.close()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4], "GC must keep only the last 2"
    _, step = ckpt.restore(str(tmp_path), like=tree)
    assert step == 4


def test_async_writer_refuses_device_tensors(tmp_path, tree):
    """The worker thread serialises host trees only: a tensor off the host
    (a meta tensor stands for a card's here) is refused at submit, before
    anything is queued."""
    w = ckpt.AsyncWriter(str(tmp_path), keep=2)
    bad = dict(tree, params=dict(tree["params"], w=tree["params"]["w"].to("meta")))
    with pytest.raises(ValueError, match=r"leaf \['params'\]/\['w'\] is on meta"):
        w.submit(1, bad)
    w.close()
    assert ckpt.latest_step(str(tmp_path)) is None


def test_atomicity_no_tmp_left_behind(tmp_path, tree):
    ckpt.save(str(tmp_path), 9, tree)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_save_removes_stale_tmp(tmp_path, tree):
    stale = tmp_path / "step_00000007.tmp"
    stale.mkdir()
    (stale / "stale_garbage.bin").write_bytes(b"junk")
    path = ckpt.save(str(tmp_path), 7, tree)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    restored, _ = ckpt.restore(str(tmp_path), like=tree, step=7)
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_async_writer_sweeps_orphaned_tmp(tmp_path, tree):
    orphan = tmp_path / "step_00000001.tmp"
    orphan.mkdir()
    (orphan / "partial.npz").write_bytes(b"dead")
    w = ckpt.AsyncWriter(str(tmp_path), keep=2)
    w.submit(2, tree)
    w.close()
    assert not orphan.exists()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_writer_retries_transient_oserror(tmp_path, tree):
    fails = {"left": 2}

    def flaky(directory, step, t, *, extra=None):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise OSError("transient blob-store hiccup")
        return ckpt.save(directory, step, t, extra=extra)

    w = ckpt.AsyncWriter(str(tmp_path), retries=3, backoff_s=0.01, save_fn=flaky)
    w.submit(1, tree)
    w.close()
    assert w.retry_count == 2
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_async_writer_surfaces_exhausted_retries(tmp_path, tree):
    def always_fail(directory, step, t, *, extra=None):
        raise OSError("disk is gone")

    w = ckpt.AsyncWriter(str(tmp_path), retries=1, backoff_s=0.01, save_fn=always_fail)
    w.submit(1, tree)
    with pytest.raises(OSError, match="disk is gone"):
        w.close()
    assert w.retry_count == 1


def test_read_manifest_without_loading_arrays(tmp_path, tree):
    ckpt.save(str(tmp_path), 3, tree, extra={"config_hash": "abc123"})
    manifest, step = ckpt.read_manifest(str(tmp_path))
    assert step == 3
    assert manifest["extra"]["config_hash"] == "abc123"
    with pytest.raises(FileNotFoundError):
        ckpt.read_manifest(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def jax_tree(tree):
    """The same tree as the JAX tests build it."""
    return {
        "params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                   "b": jnp.ones(4, jnp.bfloat16) * 1.5},
        "opt": {"m": {"w": jnp.zeros((3, 4))}, "count": jnp.int32(7)},
    }


def test_trees_cross_between_the_packages(tmp_path, tree):
    """The JAX package writes, the port restores (and the reverse): the
    same keys, shapes and dtypes in the manifest, the same values."""
    jt = jax_tree(tree)
    jckpt.save(str(tmp_path / "jax"), 1, jt, extra={"from": "jax"})
    ckpt.save(str(tmp_path / "port"), 1, tree, extra={"from": "jax"})
    jm, _ = jckpt.read_manifest(str(tmp_path / "jax"))
    tm, _ = ckpt.read_manifest(str(tmp_path / "port"))
    for key in ("step", "keys", "shapes", "dtypes", "extra"):
        assert tm[key] == jm[key], key

    restored, _ = ckpt.restore(str(tmp_path / "jax"), like=tree)
    assert all(same(a, b) for a, b in zip(flat(tree), flat(restored)))
    jrestored, _ = jckpt.restore(str(tmp_path / "port"), like=jt)
    for key, leaf in ckpt._leaves(tree):
        got = jrestored
        for part in key.split("/"):
            got = got[part[2:-2]]
        want = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else leaf
        assert np.array_equal(np.asarray(got, dtype=np.float32),
                              np.asarray(want, dtype=np.float32)), key


def test_dataclass_leaves_are_keyed_as_the_reference_keys_them(tmp_path):
    """A dataclass field is the path part ``.name`` and None holds no leaf,
    as ``jax.tree_util`` keys a registered dataclass."""
    @dataclasses.dataclass
    class Inner:
        v: torch.Tensor
        c: torch.Tensor

    @dataclasses.dataclass
    class Outer:
        neuron: Inner
        ring: torch.Tensor
        t: np.int32
        seed: object = None

    st = Outer(neuron=Inner(v=torch.ones(2), c=torch.zeros(2, dtype=torch.int32)),
               ring=torch.full((2, 3), 0.25), t=np.int32(30))
    ckpt.save(str(tmp_path), 3, st)
    manifest, _ = ckpt.read_manifest(str(tmp_path))
    assert manifest["keys"] == [".neuron/.v", ".neuron/.c", ".ring", ".t"]
    assert manifest["dtypes"][".t"] == "int32"
    back, _ = ckpt.restore(str(tmp_path), like=st)
    assert torch.equal(back.ring, st.ring) and back.t == 30 and back.seed is None
