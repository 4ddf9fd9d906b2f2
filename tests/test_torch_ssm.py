"""The port's state-space models (mamba2, zamba2) against the JAX package
on the CPU.

The same weights go to both packages (drawn by the port, handed to the
JAX package through ``params_to_numpy`` in its own init tree); bars:
1e-5 for the SSD core, 1e-4 of the largest logit for forwards, 5e-4 for
prefill + decode and for chunked against sequential (the JAX package's own
bars, tests/test_models.py). Both sides f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as jget_arch
from repro.models.mamba2 import _segsum as jsegsum
from repro.train.steps import make_serve_artifacts as jmake_serve_artifacts
from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.models.mamba2 import segsum
from repro_torch.train.steps import make_serve_artifacts
from test_torch_moe import carried, jax_tree, rel

T = torch.from_numpy
SSM_ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]


def test_segsum_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jsegsum)(jnp.asarray(x)))
    got = segsum(T(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.array_equal(np.isneginf(got[0, 0]), np.triu(np.ones((8, 8), bool), 1))
    finite = np.isfinite(want)
    assert np.abs(got[finite] - want[finite]).max() < 1e-5


@pytest.mark.parametrize("s", [24, 21])
def test_chunked_ssd_matches_jax(s):
    """chunk 8: S 24 is three whole chunks; S 21 steps the chunk down to 7
    (the largest divisor), from a nonzero initial state."""
    jb, pb, jp, params = carried("mamba2-2.7b", 0)
    cfg = jb.cfg
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, cfg.n_heads, cfg.headdim, cfg.n_groups, cfg.d_state
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, g, n)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"])
    want_y, want_h = jax.jit(jb.model._ssd_chunked)(
        layer0, *map(jnp.asarray, (x, bm, cm, dt, h0)))
    got_y, got_h = pb.model.ssd_chunked(params.layers[0], *map(T, (x, bm, cm, dt, h0)))
    assert rel(got_y, np.asarray(want_y)) < 1e-5
    assert rel(got_h, np.asarray(want_h)) < 1e-5


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_reduced_forward_matches_jax(arch):
    jb, pb, jp, params = carried(arch, 1)
    toks = np.random.default_rng(2).integers(0, jb.cfg.vocab, (2, 24)).astype(np.int32)
    want, _ = jax.jit(jb.model.forward)(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks))
    got, aux = pb.model.forward(params, T(toks).long())
    assert got.shape == want.shape and float(aux) == 0.0
    assert rel(got, np.asarray(want)) < 1e-4


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """16 prompt tokens, then 4 decode steps against JAX's
    make_serve_artifacts; then the caches (conv and SSM states, and
    zamba2's shared-block K/V)."""
    jb, pb, jp, params = carried(arch, 3)
    toks = np.random.default_rng(4).integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    jart = jmake_serve_artifacts(jb, JShapeSpec("serve", "prefill", 24, 2), mesh=None,
                                 fsdp_axis=None, cache_dtype=jnp.float32)
    art = make_serve_artifacts(pb, ShapeSpec("serve", "prefill", 24, 2),
                               cache_dtype=torch.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    lj, sj = jart.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :16])})
    lt, st = art.prefill_fn(params, {"tokens": T(toks[:, :16]).long()})
    for i in range(16, 21):
        assert lt.shape == (2, 1, pb.cfg.vocab)
        assert rel(lt, np.asarray(lj)) < 5e-4
        if i == 20:
            break
        lj, sj = jart.decode_fn(jparams, sj, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        lt, st = art.decode_fn(params, st, T(toks[:, i:i + 1]).long(), i)
    assert st["cache"].keys() == sj["cache"].keys()
    for name, x in st["cache"].items():
        want = np.asarray(sj["cache"][name])
        assert x.shape == want.shape and x.dtype == torch.float32
        assert rel(x, want) < 5e-4, name


def test_mamba2_chunked_equals_sequential():
    """The port's own mirror of the JAX test of that name: the chunked
    forward over 24 tokens against 24 single-token decode steps."""
    pb = get_arch("mamba2-2.7b", reduced=True)
    model = pb.model
    params = model.init_params(torch.Generator().manual_seed(5))
    toks = torch.randint(0, 64, (2, 24), generator=torch.Generator().manual_seed(6))
    logits, _ = model.forward(params, toks)
    cache = model.init_cache(2, 0, torch.float32)
    outs = []
    for t in range(24):
        lt, cache = model.forward_with_cache(params, toks[:, t:t + 1], cache, t)
        outs.append(lt[:, 0])
    assert rel(torch.stack(outs, dim=1), logits) < 5e-4


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_weight_trees_round_trip(arch):
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_tree(jb, 7)
    params = pb.model.params_from_numpy(jp)
    back = pb.model.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, jp))
