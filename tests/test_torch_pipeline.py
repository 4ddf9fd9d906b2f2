"""The port's GPipe wrapper (``repro_torch.train.pipeline``) against the JAX
one on the CPU, forward and gradient.

The JAX test's workload (tests/test_distributed.py): 4 stages of
``tanh(x @ w_s)`` with ``w`` ``[4, 8, 8]`` x 0.3, 6 microbatches of 2 x 8,
here drawn from a numpy seed. The JAX ``pipeline_apply`` runs on 4 forced
host devices in a subprocess; the port's on a gloo world of 4 CPU
processes, one stage a rank. Both against the sequential reference within
the JAX test's ``atol=1e-5``; the port's output, broadcast from the last
stage, is bitwise the stages applied in sequence by torch on every rank.

The gradient: a sum-of-squares loss against a seeded target, for M 6 and
M 2 (fewer microbatches than stages), every rank computing it from the
replicated output. Each rank's stage gradient and the microbatches'
gradient against ``jax.value_and_grad`` through the JAX wrapper and a
float64 sequential gradient within 1e-5 (a gradient summed over the S
ranks' cotangents would be S times these); the microbatches' gradient
bitwise alike on every rank; the collectives counted without a gradient
(exactly the forward's) and with one (the reverse permutes by name).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import comm
from repro_torch.train.pipeline import pipeline_apply
from test_torch_comm import ROOT, run_world

S, M, MB, D = 4, 6, 2, 8
GRAD_MS = (6, 2)  # the gradient's microbatch counts: M, and fewer than S


def _stage(p, x):
    return torch.tanh(x @ p["w"])


def pipe_rank(mesh, payload):
    """One rank: its stage's weight only; the JAX test's microbatches and
    fewer microbatches than stages (M 2: bubbles only) forward, then for
    each of ``GRAD_MS`` a forward under ``no_grad`` and a loss's backward,
    with the collectives each made."""
    w = torch.from_numpy(payload["w"][mesh.axis_index("pipe")])
    x = torch.from_numpy(payload["x"])
    got = {"full": pipeline_apply(_stage, {"w": w}, x, mesh).numpy(),
           "short": pipeline_apply(_stage, {"w": w}, x[:2], mesh, axis="pipe").numpy()}
    for m in GRAD_MS:
        wg = torch.nn.Parameter(w.clone())
        xg = x[:m].clone().requires_grad_()
        comm.reset_stats()
        with torch.no_grad():
            pipeline_apply(_stage, {"w": wg}, xg, mesh)
        no_grad = dict(comm.calls)
        comm.reset_stats()
        out = pipeline_apply(_stage, {"w": wg}, xg, mesh)
        loss = (out - torch.from_numpy(payload["target"][:m])).square().sum()
        loss.backward()
        got[m] = {"loss": loss.item(), "gw": wg.grad.numpy(), "gx": xg.grad.numpy(),
                  "no_grad": no_grad, "grad": dict(comm.calls)}
    return got


def _jax_start(w, x, target, tmp_path) -> subprocess.Popen:
    """The JAX wrapper on 4 forced host devices in a subprocess: its output,
    and for each of ``GRAD_MS`` the loss's ``jax.value_and_grad`` with
    respect to ``w`` and ``x``."""
    np.savez(tmp_path / "in.npz", w=w, x=x, target=target)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro import compat
        from repro.train.pipeline import pipeline_apply
        a = np.load({str(tmp_path / 'in.npz')!r})
        mesh = jax.make_mesh((4,), ("pipe",))
        stage = lambda p, x: jnp.tanh(x @ p["w"])
        w, x = jnp.asarray(a["w"]), jnp.asarray(a["x"])
        out = {{}}
        with compat.set_mesh(mesh):
            out["y"] = pipeline_apply(stage, {{"w": w}}, x, mesh)
            for m in {GRAD_MS!r}:
                def loss(w, x, t=jnp.asarray(a["target"][:m])):
                    return jnp.sum(jnp.square(pipeline_apply(stage, {{"w": w}}, x, mesh) - t))
                out[f"loss{{m}}"], (out[f"gw{{m}}"], out[f"gx{{m}}"]) = jax.jit(
                    jax.value_and_grad(loss, argnums=(0, 1)))(w, x[:m])
        np.savez({str(tmp_path / 'jax.npz')!r}, **{{k: np.asarray(v) for k, v in out.items()}})
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _jax_finish(proc: subprocess.Popen, tmp_path) -> dict:
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with np.load(tmp_path / "jax.npz") as z:
        return dict(z)


def _sequential_grad(w, x, target):
    """The loss and its gradient with respect to ``w`` and ``x``, the stages
    applied in sequence in float64."""
    wt = torch.from_numpy(w.astype(np.float64)).requires_grad_()
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    h = xt
    for s in range(S):
        h = torch.tanh(h @ wt[s])
    loss = (h - torch.from_numpy(target.astype(np.float64))).square().sum()
    loss.backward()
    return loss.item(), wt.grad.numpy(), xt.grad.numpy()


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """The inputs, the gloo world's ranks' results and the JAX subprocess's,
    the two run side by side."""
    tmp_path = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    target = rng.normal(size=(M, MB, D)).astype(np.float32)
    proc = _jax_start(w, x, target, tmp_path)
    try:
        ranks = run_world(tmp_path / "world", (S,), ("pipe",), "test_torch_pipeline:pipe_rank",
                          {"w": w, "x": x, "target": target})
    finally:
        jax_out = _jax_finish(proc, tmp_path)
    return {"w": w, "x": x, "target": target}, ranks, jax_out


def test_pipeline_apply_matches_the_jax_pipeline_and_the_sequential_stages(pipeline_runs):
    inputs, ranks, jax_out = pipeline_runs
    w, x = inputs["w"], inputs["x"]
    ref_np = x.astype(np.float64)
    ref = torch.from_numpy(x)
    for s in range(S):
        ref_np = np.tanh(ref_np @ w[s])
        ref = _stage({"w": torch.from_numpy(w[s])}, ref)
    want = jax_out["y"]
    assert np.abs(want - ref_np).max() <= 1e-5
    for r, got in enumerate(ranks):
        assert got["full"].shape == (M, MB, D) and got["full"].dtype == np.float32
        assert np.abs(got["full"] - want).max() <= 1e-5, r
        assert np.abs(got["full"] - ref_np).max() <= 1e-5, r
        assert np.array_equal(got["full"], ref.numpy()), r
        assert np.array_equal(got["short"], ref.numpy()[:2]), r


@pytest.mark.parametrize("m", GRAD_MS)
def test_pipeline_apply_gradient_matches_jax_grad_and_the_sequential_gradient(
        pipeline_runs, m):
    inputs, ranks, jax_out = pipeline_runs
    loss64, gw64, gx64 = _sequential_grad(inputs["w"], inputs["x"][:m], inputs["target"][:m])
    gw_jax, gx_jax = jax_out[f"gw{m}"], jax_out[f"gx{m}"]
    assert np.abs(gw_jax - gw64).max() <= 1e-5 and np.abs(gx_jax - gx64).max() <= 1e-5
    assert abs(float(jax_out[f"loss{m}"]) - loss64) <= 1e-5 * loss64
    for r, got in enumerate(ranks):
        g = got[m]
        assert abs(g["loss"] - loss64) <= 1e-5 * loss64, r
        assert g["gw"].shape == (D, D) and g["gx"].shape == (m, MB, D), r
        assert np.abs(g["gw"] - gw_jax[r]).max() <= 1e-5, r
        assert np.abs(g["gw"] - gw64[r]).max() <= 1e-5, r
        assert np.abs(g["gx"] - gx_jax).max() <= 1e-5, r
        assert np.abs(g["gx"] - gx64).max() <= 1e-5, r
        assert np.array_equal(g["gx"], ranks[0][m]["gx"]), r


@pytest.mark.parametrize("m", GRAD_MS)
def test_pipeline_apply_collectives_with_and_without_a_gradient(pipeline_runs, m):
    """Without a gradient, exactly the forward's collectives (M + S - 1
    permutes and one broadcast); with a backward, as many reverse permutes
    again under their own name and one broadcast of the microbatches'
    gradient."""
    _, ranks, _ = pipeline_runs
    ax = ("pipe",)
    forward = {("ppermute", ax): m + S - 1, ("broadcast", ax): 1}
    for r, got in enumerate(ranks):
        assert got[m]["no_grad"] == forward, r
        assert got[m]["grad"] == {**forward, ("ppermute_grad", ax): m + S - 1,
                                  ("broadcast_grad", ax): 1}, r
