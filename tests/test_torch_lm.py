"""The port's dense-transformer LM path against the JAX package on the CPU.

Layers, whole forwards (reduced qwen2-0.5b and h2o-danube-1.8b, through the
dense, streaming and flash-attention paths) and serving (prefill + decode)
get the same inputs, made with numpy, and the same weights, carried over by
``params_from_numpy``. Tolerances: 1e-5 for single layers, 1e-4 of the
largest logit for forwards (the JAX package's own bar for kernel against
streaming path, tests/test_models.py), 5e-4 for prefill + decode (its bar
for decode against the full forward). Both sides run f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro.configs.common import ShapeSpec as JShapeSpec
from repro.configs.registry import arch_cells as jarch_cells
from repro.configs.registry import arch_skips as jarch_skips
from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import list_archs as jlist_archs
from repro.models.transformer import Transformer as JTransformer
from repro.models.transformer import TransformerConfig as JTransformerConfig
from repro.train.steps import make_serve_artifacts as jmake_serve_artifacts
from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import arch_cells, arch_skips, get_arch, list_archs
from repro_torch.kernels import cuda
from repro_torch.models import layers as tl
from repro_torch.models.transformer import Transformer, TransformerConfig, params_from_numpy
from repro_torch.train.steps import make_serve_artifacts

T = torch.from_numpy


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def jax_params(model, seed):
    return jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))


@pytest.fixture
def lowered_threshold(monkeypatch):
    """FLASH_THRESHOLD lowered to 16 in both packages, so 16+ token
    sequences take the streaming path or the kernel."""
    monkeypatch.setattr(jl, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tl, "FLASH_THRESHOLD", 16)


# ---------------------------------------------------------------------------
# layers


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=32).astype(np.float32)
    want = np.asarray(jax.jit(jl.rms_norm)({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    assert rel(tl.rms_norm(tl.RMSNorm(T(scale)), T(x)), want) < 1e-5
    want = np.asarray(jax.jit(jl.nonparam_layer_norm)(jnp.asarray(x)))
    assert rel(tl.nonparam_layer_norm(T(x)), want) < 1e-5


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = (np.arange(40, dtype=np.int32)[None] + np.array([[0], [7]], np.int32))
    want = np.asarray(jax.jit(jl.rope)(jnp.asarray(x), jnp.asarray(pos), jnp.float32(theta)))
    got = tl.rope(T(x), T(pos), torch.tensor(theta, dtype=torch.float32))
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("window,valid", [(0, 20), (5, 20), (0, 13), (6, 9)])
def test_attention_scores_with_causal_window_mask_match_jax(window, valid):
    rng = np.random.default_rng(window + valid)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 20, 2, 16)).astype(np.float32) for _ in range(2))
    q_pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32), (2, 8)).copy()
    k_pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    k_valid = k_pos < valid

    def jfn(q, k, v, qp, kp, kv):
        return jl.attention_scores(q, k, v, jl.causal_window_mask(qp, kp, kv, window))

    want = np.asarray(jax.jit(jfn)(*map(jnp.asarray, (q, k, v, q_pos, k_pos, k_valid))))
    mask = tl.causal_window_mask(T(q_pos), T(k_pos), T(k_valid), window)
    got = tl.attention_scores(T(q), T(k), T(v), mask)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("window,k_len", [(0, 2048), (100, 2048), (0, 1500), (300, 1200)])
def test_streaming_attention_matches_jax(window, k_len):
    rng = np.random.default_rng(window + k_len)
    q = rng.normal(size=(1, 64, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2048, 2, 16)).astype(np.float32) for _ in range(2))
    q_pos = np.arange(1984, 2048, dtype=np.int32)[None]
    k_pos = np.arange(2048, dtype=np.int32)[None]
    want = np.asarray(jax.jit(jl._streaming_attention, static_argnums=(6,))(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos)), jnp.int32(k_len), window))
    got = tl._streaming_attention(T(q), T(k), T(v), T(q_pos), T(k_pos), k_len, window)
    assert rel(got, want) < 1e-5


def _attn_params(rng, d, h, hkv, dh, bias):
    shapes = {"q": (d, h * dh), "k": (d, hkv * dh), "v": (d, hkv * dh), "o": (h * dh, d)}
    out = {}
    for name, (i, o) in shapes.items():
        out[name] = {"w": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias and name != "o":
            out[name]["b"] = rng.normal(size=o).astype(np.float32)
    return out


def _to_torch_attn(p):
    return torch.nn.ModuleDict({n: tl.Dense(T(d["w"]), T(d["b"]) if "b" in d else None)
                                for n, d in p.items()})


# (cache_mode, use_pallas): no cache on the dense path, the streaming path
# and the kernel; and the three cache modes.
@pytest.mark.parametrize("mode,use_pallas,window", [
    (None, False, 0), (None, False, 5), (None, True, 0), (None, True, 5),
    ("fresh_only", False, 0), ("append_slice", False, 0), ("append_slice", False, 5),
    ("inplace", False, 0), ("inplace", False, 5),
])
def test_gqa_attention_matches_jax(mode, use_pallas, window, lowered_threshold):
    rng = np.random.default_rng(11)
    b, d, h, hkv, dh, s_max = 2, 32, 4, 2, 16, 40
    p = _attn_params(rng, d, h, hkv, dh, bias=True)
    s, idx = (1, 23) if mode in ("append_slice", "inplace") else (32, 0)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    pos = (idx + np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))).copy()
    cache = None
    if mode is not None:
        cache = tuple(rng.normal(size=(b, s_max, hkv, dh)).astype(np.float32) for _ in range(2))
    kw = dict(n_heads=h, n_kv=hkv, d_head=dh, rope_theta=10_000.0, window=window,
              cache_mode=mode or "inplace", use_pallas=use_pallas)

    def jfn(p, x, pos, cache):
        return jl.gqa_attention(p, x, pos, kv_cache=cache,
                                cache_index=None if cache is None else jnp.int32(idx), **kw)

    jcache = None if cache is None else tuple(map(jnp.asarray, cache))
    out_j, kv_j = jax.jit(jfn)(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                jnp.asarray(pos), jcache)
    before = cuda.launches["flash_attention"]
    out_t, kv_t = tl.gqa_attention(
        _to_torch_attn(p), T(x), T(pos), kv_cache=None if cache is None else tuple(map(T, cache)),
        cache_index=None if cache is None else idx, **kw)
    assert cuda.launches["flash_attention"] == before  # the CPU runs the plain version
    assert rel(out_t, np.asarray(out_j)) < 1e-5
    assert (kv_t is None) == (kv_j is None)
    if kv_t is not None:
        for got, want in zip(kv_t, kv_j):
            assert got.shape == want.shape and rel(got, np.asarray(want)) < 1e-5


def test_swiglu_matches_jax():
    rng = np.random.default_rng(12)
    p = {n: {"w": rng.normal(size=shape).astype(np.float32) / 8}
         for n, shape in (("gate", (32, 64)), ("up", (32, 64)), ("down", (64, 32)))}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jl.swiglu)(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = tl.swiglu(torch.nn.ModuleDict({n: tl.Dense(T(d["w"])) for n, d in p.items()}), T(x))
    assert rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# whole model


def test_init_params_match_the_jax_tree():
    """Same leaves, shapes and dtypes as the JAX init, and the same scales,
    for all ten architectures."""
    for arch in list_archs():
        jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
        jp = jax_params(jb.model, 0)
        tp = pb.model.init_params(torch.Generator().manual_seed(0))
        carried = pb.model.params_from_numpy(jp)
        drawn = dict(tp.named_parameters())
        assert dict(carried.named_parameters()).keys() == drawn.keys()
        for name, x in carried.named_parameters():
            y = drawn[name]
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if x.numel() >= 1000:  # embeddings and weights: same std within 10%
                assert abs(float(x.std()) / float(y.std()) - 1) < 0.1, name
            elif float(x.std()) == 0:  # biases, norm scales
                assert torch.equal(x, y), name


DENSE_ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b", "olmo-1b", "gemma3-27b"]


@pytest.mark.parametrize("path", ["dense", "streaming", "kernel"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reduced_forward_matches_jax(arch, path, monkeypatch):
    """32 tokens: below the default FLASH_THRESHOLD the dense path; with it
    lowered to 16 in both packages, the streaming path or the kernel."""
    if path != "dense":
        monkeypatch.setattr(jl, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(tl, "FLASH_THRESHOLD", 16)
    pallas = path == "kernel"
    jb = jget_arch(arch, reduced=True, use_pallas_attention=pallas)
    pb = get_arch(arch, reduced=True, use_pallas_attention=pallas)
    jp = jax_params(jb.model, 1)
    toks = np.random.default_rng(2).integers(0, jb.cfg.vocab, (2, 32)).astype(np.int32)
    want, _ = jax.jit(jb.model.forward)(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks))
    got, aux = pb.model.forward(params_from_numpy(pb.cfg, jp), T(toks).long())
    assert got.shape == want.shape and float(aux) == 0.0
    assert rel(got, np.asarray(want)) < 1e-4


def test_windowed_kernel_path_matches_streaming_and_jax(lowered_threshold):
    """The config of tests/test_models.py's kernel test: windows (8, 0)."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
                d_ff=128, vocab=256, window_pattern=(8, 0))
    jm = JTransformer(JTransformerConfig(**base))
    jp = jax_params(jm, 0)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 256))
    want, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks))
    cfg = TransformerConfig(**base)
    params = params_from_numpy(cfg, jp)
    streaming, _ = Transformer(cfg).forward(params, T(toks).long())
    kernel, _ = Transformer(dataclasses.replace(cfg, use_pallas_attention=True)).forward(
        params, T(toks).long())
    assert rel(kernel, streaming) < 1e-4
    assert rel(kernel, np.asarray(want)) < 1e-4


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_jax_serving_and_the_full_forward(arch):
    """16 prompt tokens, then 4 decode steps fed the same tokens on both
    sides; every step against JAX's make_serve_artifacts and against the
    port's own full forward over the tokens so far."""
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_params(jb.model, 3)
    params = params_from_numpy(pb.cfg, jp)
    toks = np.random.default_rng(4).integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    jart = jmake_serve_artifacts(jb, JShapeSpec("serve", "prefill", 24, 2), mesh=None,
                                 fsdp_axis=None, cache_dtype=jnp.float32)
    art = make_serve_artifacts(pb, ShapeSpec("serve", "prefill", 24, 2),
                               cache_dtype=torch.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    lj, sj = jart.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :16])})
    lt, st = art.prefill_fn(params, {"tokens": T(toks[:, :16]).long()})
    for i in range(16, 21):
        full, _ = pb.model.forward(params, T(toks[:, :i]).long())
        assert lt.shape == (2, 1, pb.cfg.vocab)
        assert rel(lt[:, 0], np.asarray(lj)[:, 0]) < 5e-4
        assert rel(lt[:, 0], full[:, -1]) < 5e-4
        if i == 20:
            break
        lj, sj = jart.decode_fn(jparams, sj, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        lt, st = art.decode_fn(params, st, T(toks[:, i:i + 1]).long(), i)
    for name in ("k", "v"):
        assert rel(st["cache"]["sub_0"][name], np.asarray(sj["cache"]["sub_0"][name])) < 5e-4


def test_inplace_cache_mode_decode_matches_append_slice():
    """attn_sharding='seq' makes decode write the cache in place; the
    logits and the cache agree with the default append-slice decode."""
    pb = get_arch("qwen2-0.5b", reduced=True)
    seq = get_arch("qwen2-0.5b", reduced=True, attn_sharding="seq")
    params = pb.model.init_params(torch.Generator().manual_seed(5))
    toks = torch.randint(0, pb.cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(6))
    out = []
    for bundle in (pb, seq):
        cache = bundle.model.init_cache(2, 16, torch.float32)
        _, cache = bundle.model.forward_with_cache(params, toks[:, :11], cache, 0)
        logits, cache = bundle.model.forward_with_cache(params, toks[:, 11:], cache, 11)
        out.append((logits, cache))
    assert rel(out[1][0], out[0][0]) < 1e-5
    for name in ("k", "v"):
        assert rel(out[1][1]["sub_0"][name], out[0][1]["sub_0"][name]) < 1e-5


# ---------------------------------------------------------------------------
# configs and entry point


def test_registry_has_the_dense_archs_and_names_the_roadmap_for_the_rest():
    """All ten architectures of the JAX registry, in its order (nothing is
    left to port): equal configs (nested ones too: MoE, the VLM backbone),
    parameter counts, bundles, extra inputs' shapes and dtypes, skips and
    cells; and TransformerConfig takes ``moe``."""
    assert list_archs() == jlist_archs()
    assert set(DENSE_ARCHS) < set(list_archs())
    for arch in list_archs():
        for reduced in (False, True):
            jb, pb = jget_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
            jc, pc = jb.cfg, pb.cfg
            assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
            assert pc.param_count() == jc.param_count()
            assert pc.active_param_count() == jc.active_param_count()
            assert (pb.arch_id, pb.family, pb.moment_dtype) == \
                (jb.arch_id, jb.family, jb.moment_dtype)
            assert pb.extra_inputs.keys() == jb.extra_inputs.keys()
            for name, make in pb.extra_inputs.items():
                spec, jspec = make(2, 32), jb.extra_inputs[name](2, 32)
                assert tuple(spec.shape) == jspec.shape and spec.device.type == "meta"
                assert str(spec.dtype).removeprefix("torch.") == jspec.dtype.name
        assert arch_skips(arch) == jarch_skips(arch)
        cells = [(shape.name, skip) for shape, skip in arch_cells(arch)]
        assert cells == [(shape.name, skip) for shape, skip in jarch_cells(arch)]
    moe = get_arch("grok-1-314b").cfg.moe
    cfg = TransformerConfig(name="m", n_layers=2, d_model=8, n_heads=2, n_kv=1, d_head=4,
                            d_ff=8, vocab=8, moe=dataclasses.replace(moe, interleave=2))
    assert (cfg.group_size, cfg.n_groups, cfg.sub_is_moe(0), cfg.sub_is_moe(1)) == \
        (2, 1, False, True)


@pytest.mark.parametrize("arch", jlist_archs())
def test_every_reduced_forward_is_finite(arch):
    """Each registered architecture, reduced, drawn by the port: the
    forward (with its stub inputs) gives finite logits of the vocab's width."""
    pb = get_arch(arch, reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = pb.model.init_params(gen)
    vocab = pb.cfg.vocab
    toks = torch.randint(0, vocab, (2, 32), generator=gen)
    extra = {n: torch.randn(make(2, 32).shape, generator=gen)
             for n, make in pb.extra_inputs.items()}
    logits, aux = pb.model.forward(params, toks, **extra)
    assert logits.shape == (2, 32, vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


def test_window_and_theta_arrays_match_jax():
    cfg = dict(name="g", n_layers=6, d_model=8, n_heads=2, n_kv=1, d_head=4, d_ff=8,
               vocab=8, window_pattern=(4, 4, 0), rope_theta_global=1e6)
    jc, pc = JTransformerConfig(**cfg), TransformerConfig(**cfg)
    assert np.array_equal(pc.window_array().numpy(), np.asarray(jc.window_array()))
    assert np.array_equal(pc.theta_array().numpy(), np.asarray(jc.theta_array()))


def test_serve_lm_runs_reduced_on_the_cpu(capsys):
    from repro_torch import serve_lm

    r = serve_lm.main(["--reduced", "--device", "cpu", "--batch", "2", "--tokens", "3"])
    assert r["tokens"].shape == (2, 3) and r["decode_steps"] == 2
    out = capsys.readouterr().out
    assert "prefill: batch 2 x 32 tokens" in out and "decode:  2 steps" in out


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-2.7b", "whisper-medium",
                                  "internvl2-76b"])
def test_serve_lm_runs_every_family_reduced_on_the_cpu(arch, capsys):
    """``--arch`` takes the other families; whisper's frames and internvl's
    patch embeddings are drawn from the seed."""
    from repro_torch import serve_lm

    r = serve_lm.main(["--reduced", "--device", "cpu", "--batch", "2", "--tokens", "3",
                       "--arch", arch])
    assert r["tokens"].shape == (2, 3) and bool(torch.isfinite(r["logits"]).all())
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out


def test_the_isolation_test_reaches_the_lm_modules():
    """tests/test_torch_isolation.py imports every module its rglob finds."""
    from test_torch_isolation import port_modules

    mods = set(port_modules())
    assert {"repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.moe", "repro_torch.models.mamba2", "repro_torch.models.zamba2",
            "repro_torch.models.whisper", "repro_torch.models.internvl",
            "repro_torch.models.jax_layout", "repro_torch.configs.registry",
            "repro_torch.train.steps", "repro_torch.serve_lm",
            "repro_torch.kernels.flash_attention"} <= mods
