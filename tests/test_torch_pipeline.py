"""The port's GPipe wrapper (``repro_torch.train.pipeline``) against the JAX
one on the CPU.

The JAX test's workload (tests/test_distributed.py): 4 stages of
``tanh(x @ w_s)`` with ``w`` ``[4, 8, 8]`` x 0.3, 6 microbatches of 2 x 8,
here drawn from a numpy seed. The JAX ``pipeline_apply`` runs on 4 forced
host devices in a subprocess; the port's on a gloo world of 4 CPU
processes, one stage a rank. Both against the sequential reference within
the JAX test's ``atol=1e-5``; the port's output, broadcast from the last
stage, is bitwise the stages applied in sequence by torch on every rank.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.train.pipeline import pipeline_apply
from test_torch_comm import ROOT, run_world

S, M, MB, D = 4, 6, 2, 8


def _stage(p, x):
    return torch.tanh(x @ p["w"])


def pipe_rank(mesh, payload):
    """One rank: its stage's weight only, the JAX test's microbatches and
    fewer microbatches than stages (M 2: bubbles only)."""
    w = torch.from_numpy(payload["w"][mesh.axis_index("pipe")])
    x = torch.from_numpy(payload["x"])
    return {"full": pipeline_apply(_stage, {"w": w}, x, mesh).numpy(),
            "short": pipeline_apply(_stage, {"w": w}, x[:2], mesh, axis="pipe").numpy()}


def _jax_pipeline(w, x, tmp_path) -> np.ndarray:
    np.savez(tmp_path / "in.npz", w=w, x=x)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro import compat
        from repro.train.pipeline import pipeline_apply
        a = np.load({str(tmp_path / 'in.npz')!r})
        mesh = jax.make_mesh((4,), ("pipe",))
        with compat.set_mesh(mesh):
            got = pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]), {{"w": jnp.asarray(a["w"])}},
                                 jnp.asarray(a["x"]), mesh)
        np.save({str(tmp_path / 'jax.npy')!r}, np.asarray(got))
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(tmp_path / "jax.npy")


def test_pipeline_apply_matches_the_jax_pipeline_and_the_sequential_stages(tmp_path):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    ranks = run_world(tmp_path / "world", (S,), ("pipe",), "test_torch_pipeline:pipe_rank",
                      {"w": w, "x": x})
    ref_np = x.astype(np.float64)
    ref = torch.from_numpy(x)
    for s in range(S):
        ref_np = np.tanh(ref_np @ w[s])
        ref = _stage({"w": torch.from_numpy(w[s])}, ref)
    want = _jax_pipeline(w, x, tmp_path)
    assert np.abs(want - ref_np).max() <= 1e-5
    for r, got in enumerate(ranks):
        assert got["full"].shape == (M, MB, D) and got["full"].dtype == np.float32
        assert np.abs(got["full"] - want).max() <= 1e-5, r
        assert np.abs(got["full"] - ref_np).max() <= 1e-5, r
        assert np.array_equal(got["full"], ref.numpy()), r
        assert np.array_equal(got["short"], ref.numpy()[:2]), r
