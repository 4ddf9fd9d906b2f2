"""The port's whisper (encoder-decoder) and internvl (VLM) against the JAX
package on the CPU, with their layers (LayerNorm with bias, the tanh-GELU
MLP, sinusoidal positions).

The same weights (drawn by the port, handed to the JAX package in its own
init tree) and stub inputs (frames, patch embeddings, from numpy) go to both
packages. Bars: 1e-5 for single layers, 1e-4 of the largest logit for
forwards and the encoder, 5e-4 for prefill + decode (the JAX package's own
bars, tests/test_models.py). Both sides f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro.configs.common import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as jget_arch
from repro.train.steps import make_serve_artifacts as jmake_serve_artifacts
from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as tl
from repro_torch.train.steps import make_serve_artifacts
from test_torch_moe import carried, jax_tree, rel

T = torch.from_numpy
ENCDEC_ARCHS = ["whisper-medium", "internvl2-76b"]


def extras(bundle, b, s, seed) -> dict:
    """The stub frontends' outputs, standard normal from numpy."""
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=tuple(make(b, s).shape)).astype(np.float32)
            for name, make in bundle.extra_inputs.items()}


# ---------------------------------------------------------------------------
# layers


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=32).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jl.layer_norm)({"scale": jnp.asarray(scale),
                                              "bias": jnp.asarray(bias)}, jnp.asarray(x)))
    assert rel(tl.layer_norm(tl.LayerNorm(T(scale), T(bias)), T(x)), want) < 1e-5


def test_gelu_mlp_is_the_tanh_gelu_of_jax():
    rng = np.random.default_rng(1)
    p = {"up": {"w": rng.normal(size=(32, 64)).astype(np.float32) / 4,
                "b": rng.normal(size=64).astype(np.float32)},
         "down": {"w": rng.normal(size=(64, 32)).astype(np.float32) / 8,
                  "b": rng.normal(size=32).astype(np.float32)}}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jl.gelu_mlp)(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    mlp = torch.nn.ModuleDict({n: tl.Dense(T(d["w"]), T(d["b"])) for n, d in p.items()})
    assert rel(tl.gelu_mlp(mlp, T(x)), want) < 1e-5
    # the exact (erf) GELU is another function: the bar tells them apart
    exact = tl.dense(mlp["down"], torch.nn.functional.gelu(tl.dense(mlp["up"], T(x))))
    assert rel(exact, want) > 1e-4


@pytest.mark.parametrize("d_model", [64, 1024])
def test_sinusoidal_positions_match_jax(d_model):
    """The angles are position x frequency, and the two packages' f32 ``exp``
    may round a frequency 1 ulp apart (2**-23 relative), which an angle
    carries times its position: the bar is 1e-5 plus that, ~1.8e-4 at
    Whisper's last frame (1499)."""
    pos = (np.arange(40, dtype=np.int32)[None] + np.array([[0], [1460]], np.int32))
    want = np.asarray(jax.jit(jl.sinusoidal_positions, static_argnums=1)(
        jnp.asarray(pos), d_model))
    got = tl.sinusoidal_positions(T(pos), d_model)
    assert rel(got[0], want[0]) < 1e-5
    assert rel(got, want) < 1e-5 + int(pos.max()) * 2.0 ** -23


# ---------------------------------------------------------------------------
# whisper


def test_whisper_encode_and_forward_match_jax():
    jb, pb, jp, params = carried("whisper-medium", 1)
    jpp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(2).integers(0, jb.cfg.vocab, (2, 24)).astype(np.int32)
    frames = extras(jb, 2, 24, 3)["frames"]
    want = np.asarray(jax.jit(jb.model.encode)(jpp, jnp.asarray(frames)))
    assert rel(pb.model.encode(params, T(frames)), want) < 1e-4
    want, _ = jax.jit(jb.model.forward)(jpp, jnp.asarray(toks), frames=jnp.asarray(frames))
    got, aux = pb.model.forward(params, T(toks).long(), frames=T(frames))
    assert got.shape == want.shape and float(aux) == 0.0
    assert rel(got, np.asarray(want)) < 1e-4


def test_whisper_cached_decoding_matches_jax_and_the_forward():
    """Prefill 16 tokens against a precomputed encoder output, then 4
    decode steps: each step's logits against JAX's forward_with_cache and
    against the port's own full forward over the tokens so far."""
    jb, pb, jp, params = carried("whisper-medium", 4)
    jpp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(5).integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    frames = extras(jb, 2, 20, 6)["frames"]
    enc_j = jax.jit(jb.model.encode)(jpp, jnp.asarray(frames))
    enc_t = pb.model.encode(params, T(frames))
    cache_j = jb.model.init_cache(2, 24, jnp.float32)
    cache_t = pb.model.init_cache(2, 24, torch.float32)
    step = jax.jit(jb.model.forward_with_cache, static_argnames="last_only")
    lj, cache_j = step(jpp, jnp.asarray(toks[:, :16]), cache_j, jnp.int32(0), enc_out=enc_j,
                       last_only=True)
    lt, cache_t = pb.model.forward_with_cache(params, T(toks[:, :16]).long(), cache_t, 0,
                                              enc_out=enc_t, last_only=True)
    for i in range(16, 21):
        full, _ = pb.model.forward(params, T(toks[:, :i]).long(), frames=T(frames))
        assert rel(lt[:, -1], np.asarray(lj)[:, -1]) < 5e-4
        assert rel(lt[:, -1], full[:, -1]) < 5e-4
        if i == 20:
            break
        lj, cache_j = step(jpp, jnp.asarray(toks[:, i:i + 1]), cache_j, jnp.int32(i),
                           enc_out=enc_j)
        lt, cache_t = pb.model.forward_with_cache(params, T(toks[:, i:i + 1]).long(), cache_t,
                                                  i, enc_out=enc_t)
    for name in ("k", "v"):
        assert rel(cache_t[name], np.asarray(cache_j[name])) < 5e-4


# ---------------------------------------------------------------------------
# internvl


def test_internvl_forward_and_prefill_with_patch_embeds_match_jax():
    jb, pb, jp, params = carried("internvl2-76b", 7)
    jpp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(8).integers(0, pb.cfg.vocab, (2, 24)).astype(np.int32)
    patches = extras(jb, 2, 24, 9)["patch_embeds"]
    want, _ = jax.jit(jb.model.forward)(jpp, jnp.asarray(toks),
                                        patch_embeds=jnp.asarray(patches))
    got, _ = pb.model.forward(params, T(toks).long(), patch_embeds=T(patches))
    assert got.shape == want.shape
    assert rel(got, np.asarray(want)) < 1e-4
    # the patches reach the logits: other patches, other logits at every position
    other, _ = pb.model.forward(params, T(toks).long(), patch_embeds=T(patches + 1))
    assert rel(other[:, -1], got[:, -1]) > 1e-3
    cache_j = jb.model.init_cache(2, 24, jnp.float32)
    cache_t = pb.model.init_cache(2, 24, torch.float32)
    lj, _ = jax.jit(jb.model.forward_with_cache, static_argnames="last_only")(
        jpp, jnp.asarray(toks), cache_j, jnp.int32(0), patch_embeds=jnp.asarray(patches),
        last_only=True)
    lt, _ = pb.model.forward_with_cache(params, T(toks).long(), cache_t, 0,
                                        patch_embeds=T(patches), last_only=True)
    assert rel(lt, np.asarray(lj)) < 5e-4
    assert rel(lt[:, 0], got[:, -1]) < 5e-4


# ---------------------------------------------------------------------------
# serving and weights


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_serve_artifacts_match_jax(arch):
    """make_serve_artifacts with the extra input at prefill (whisper's
    encoder output kept in the serve state; internvl's patches at prefill
    only), then 4 decode steps, against the JAX package's artifacts."""
    jb, pb, jp, params = carried(arch, 10)
    toks = np.random.default_rng(11).integers(0, pb.cfg.vocab, (2, 20)).astype(np.int32)
    extra = extras(jb, 2, 16, 12)
    jart = jmake_serve_artifacts(jb, JShapeSpec("serve", "prefill", 24, 2), mesh=None,
                                 fsdp_axis=None, cache_dtype=jnp.float32)
    art = make_serve_artifacts(pb, ShapeSpec("serve", "prefill", 24, 2),
                               cache_dtype=torch.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    lj, sj = jart.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :16]),
                                       **{k: jnp.asarray(v) for k, v in extra.items()}})
    lt, st = art.prefill_fn(params, {"tokens": T(toks[:, :16]).long(),
                                     **{k: T(v) for k, v in extra.items()}})
    assert st.keys() == sj.keys()
    if "enc_out" in st:
        assert rel(st["enc_out"], np.asarray(sj["enc_out"])) < 1e-4
    for i in range(16, 21):
        assert rel(lt, np.asarray(lj)) < 5e-4
        if i == 20:
            break
        lj, sj = jart.decode_fn(jparams, sj, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        lt, st = art.decode_fn(params, st, T(toks[:, i:i + 1]).long(), i)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_encdec_weight_trees_round_trip(arch):
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_tree(jb, 13)
    params = pb.model.params_from_numpy(jp)
    back = pb.model.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, jp))
