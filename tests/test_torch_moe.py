"""The port's MoE layer and the MoE transformers against the JAX package on
the CPU.

Routing is discontinuous: an ulp in the router can flip a near-tied top-k
choice, and capacity then moves other tokens of that sequence too. So every
comparison first holds the port's ``expert_idx`` to the reference's (the
reference's own ``jax.lax.top_k`` on its own router output, captured from
inside its jitted forward), reports any flip with its gate margin (a flip
whose margin is not a rounding's, 1e-5, fails), and holds the outputs to the
bar only on the sequences whose choices agree in every layer
(``test_torch_moe_routing.agreeing_rows``). Bars: 1e-5 for
the layer alone, 1e-4 of the largest logit for forwards, 5e-4 for prefill +
decode (the JAX package's own bars, tests/test_models.py). Both sides f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.models.transformer as jtransformer
from repro.configs.common import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as jget_arch
from repro.train.steps import make_serve_artifacts as jmake_serve_artifacts
from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train.steps import make_serve_artifacts
from test_torch_moe_routing import agreeing_rows, routing_tap

T = torch.from_numpy
MOE_ARCHS = ["llama4-maverick-400b-a17b", "grok-1-314b"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def jax_routing(p, x, cfg):
    """The reference's router and top-k, as its moe_apply computes them."""
    gates = jax.nn.softmax(jax.numpy.asarray(x, jnp.float32) @ p["router"]["w"], axis=-1)
    return gates, jax.lax.top_k(gates, cfg.top_k)[1]


@pytest.fixture
def routing(monkeypatch):
    """Records every MoE layer's routing on both sides: ``(port, reference)``
    lists of ``(expert_idx, gates)`` numpy pairs, in layer order."""
    port, ref = routing_tap(monkeypatch), []
    j_apply = jtransformer.moe_apply

    def j_wrapped(p, x, cfg, act_axes=None):
        gates, idx = jax_routing(p, x, cfg)
        jax.debug.callback(lambda i, g: ref.append((np.asarray(i), np.asarray(g))),
                           idx, gates, ordered=True)
        return j_apply(p, x, cfg, act_axes=act_axes)

    monkeypatch.setattr(jtransformer, "moe_apply", j_wrapped)
    return port, ref


def jax_tree_spec(jb):
    """The JAX package's own init tree, shapes and dtypes only
    (``jax.eval_shape``: nothing is drawn)."""
    return jax.eval_shape(jb.model.init_params, jax.random.PRNGKey(0))


def jax_tree(jb, seed):
    """Standard normal numpy leaves, from ``seed``, in that tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), jax_tree_spec(jb))


def carried(arch, seed):
    """The reduced bundles of both packages and one set of weights in each:
    drawn by the port from ``seed`` (the JAX package's eager init compiles
    op by op, seconds a family on the CPU) and handed to the JAX package in
    the tree its own init gives, leaf for leaf in shape and dtype."""
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    params = pb.model.init_params(torch.Generator().manual_seed(seed))
    jp = pb.model.params_to_numpy(params)
    spec = jax_tree_spec(jb)
    assert jax.tree.structure(jp) == jax.tree.structure(spec)
    assert all(a.shape == s.shape and a.dtype == s.dtype
               for a, s in zip(jax.tree.leaves(jp), jax.tree.leaves(spec)))
    return jb, pb, jp, params


# ---------------------------------------------------------------------------
# the layer


def _moe_params(rng, d, cfg, uniform_router):
    e, ff = cfg.n_experts, cfg.d_ff
    p = {
        "router": {"w": (np.zeros((d, e)) if uniform_router
                         else rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)},
        "gate_w": (rng.normal(size=(e, d, ff)) / np.sqrt(d)).astype(np.float32),
        "up_w": (rng.normal(size=(e, d, ff)) / np.sqrt(d)).astype(np.float32),
        "down_w": (rng.normal(size=(e, ff, d)) / np.sqrt(ff)).astype(np.float32),
    }
    if cfg.shared_expert:
        p["shared"] = {n: {"w": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)}
                       for n, s in (("gate", (d, ff)), ("up", (d, ff)), ("down", (ff, d)))}
    return p


def _to_port(p) -> tmoe.MoEParams:
    shared = None
    if "shared" in p:
        shared = torch.nn.ModuleDict({n: tl.Dense(T(v["w"])) for n, v in p["shared"].items()})
    return tmoe.MoEParams(tl.Dense(T(p["router"]["w"])), T(p["gate_w"]), T(p["up_w"]),
                          T(p["down_w"]), shared)


def _ref_keep(expert_idx, cap, e):
    """The reference's capacity rule on its own choices (moe.py:96-101)."""
    flat = np.asarray(expert_idx).reshape(expert_idx.shape[0], -1)
    onehot = np.eye(e, dtype=np.int32)[flat]
    pos = ((np.cumsum(onehot, axis=1) - onehot) * onehot).sum(-1)
    return pos < cap, np.where(pos < cap, pos, cap)


# name: (top_k, shared expert, capacity factor, uniform router)
MOE_CASES = {
    "top1_shared": (1, True, 1.25, False),
    "top2_renormalised": (2, False, 1.25, False),
    "top2_dropping": (2, False, 0.5, False),
    "uniform_router_ties": (2, True, 1.0, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """Outputs, aux loss, expert choices and keep masks against
    ``repro.models.moe.moe_apply``. The dropping case keeps some entries and
    drops others; the uniform router ties every gate, so the choices are the
    lowest experts and every token of a sequence queues for the same ones."""
    top_k, shared, cf, uniform = MOE_CASES[case]
    b, s, d = 2, 16, 32
    jcfg = jmoe.MoEConfig(n_experts=4, top_k=top_k, d_ff=48, capacity_factor=cf,
                          shared_expert=shared)
    cfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    p = _moe_params(rng, d, jcfg, uniform)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jnp.asarray(x))
    jgates, jidx = jax.jit(lambda p, x: jax_routing(p, x, jcfg))(jp, jnp.asarray(x))

    tp = _to_port(p)
    got, aux = tmoe.moe_apply(tp, T(x), cfg)
    gates, _, idx = tmoe.route(tp, T(x), cfg)
    agree = agreeing_rows([(idx.numpy(), gates.numpy())], [(np.asarray(jidx), np.asarray(jgates))])

    cap = int(max(1, -(-s * top_k * cf // 4)))
    _, slot, keep = tmoe.dispatch_slots(idx, cap, 4)
    want_keep, want_slot = _ref_keep(np.asarray(jidx), cap, 4)
    assert np.array_equal(keep.numpy()[agree], want_keep[agree])
    assert np.array_equal(slot.numpy()[agree], want_slot[agree])
    if case == "top2_dropping":
        assert 0 < want_keep.sum() < want_keep.size
    if case == "uniform_router_ties":
        assert np.all(np.asarray(jidx) == np.arange(top_k))
    assert got.shape == (b, s, d)
    assert rel(got.numpy()[agree], np.asarray(want)[agree]) < 1e-5
    if agree.all():
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * max(abs(float(want_aux)), 1.0)


# ---------------------------------------------------------------------------
# the MoE transformers


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_forward_hidden_and_loss_match_jax(arch, routing):
    port_rec, ref_rec = routing
    jb, pb, jp, params = carried(arch, 1)
    toks, labels = _batch(jb.cfg.vocab, 2, 32, 2)
    jpp = jax.tree.map(jnp.asarray, jp)

    want, want_aux = jax.jit(jb.model.forward)(jpp, jnp.asarray(toks))
    got, aux = pb.model.forward(params, T(toks).long())
    agree = agreeing_rows(port_rec, ref_rec)
    assert got.shape == want.shape
    assert rel(got.numpy()[agree], np.asarray(want)[agree]) < 1e-4
    if agree.all():
        assert abs(float(aux) - float(want_aux)) <= 1e-4 * abs(float(want_aux))

    wh, _ = jax.jit(jb.model.hidden)(jpp, jnp.asarray(toks))
    h, _ = pb.model.hidden(params, T(toks).long())
    assert rel(h.numpy()[agree], np.asarray(wh)[agree]) < 1e-4

    batch = {"tokens": toks, "labels": labels}
    want_loss = jax.jit(jb.loss)(jpp, jax.tree.map(jnp.asarray, batch))
    loss = pb.loss(params, {k: T(v).long() for k, v in batch.items()})
    if agree.all():
        assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax_forward_with_cache(arch, routing):
    """16 prompt tokens, then 4 decode steps fed the same tokens on both
    sides, against JAX's make_serve_artifacts (the MoE capacity follows
    each call's length, so serving is not the full forward)."""
    port_rec, ref_rec = routing
    jb, pb, jp, params = carried(arch, 3)
    toks, _ = _batch(jb.cfg.vocab, 2, 20, 4)
    jart = jmake_serve_artifacts(jb, JShapeSpec("serve", "prefill", 24, 2), mesh=None,
                                 fsdp_axis=None, cache_dtype=jnp.float32)
    art = make_serve_artifacts(pb, ShapeSpec("serve", "prefill", 24, 2),
                               cache_dtype=torch.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    lj, sj = jart.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :16])})
    jax.block_until_ready(lj)
    lt, st = art.prefill_fn(params, {"tokens": T(toks[:, :16]).long()})
    for i in range(16, 21):
        agree = agreeing_rows(port_rec, ref_rec)
        assert lt.shape == (2, 1, pb.cfg.vocab)
        assert rel(lt.numpy()[agree], np.asarray(lj)[agree]) < 5e-4
        if i == 20:
            break
        lj, sj = jart.decode_fn(jparams, sj, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jax.block_until_ready(lj)
        lt, st = art.decode_fn(params, st, T(toks[:, i:i + 1]).long(), i)
    assert st["cache"].keys() == sj["cache"].keys()
    for sub, kv in st["cache"].items():
        for name, x in kv.items():
            assert rel(x.numpy()[:, agree], np.asarray(sj["cache"][sub][name])[:, agree]) < 5e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_weight_tree_round_trips(arch):
    """The JAX MoE tree (sub_0 dense, sub_1 MoE for llama4's group of 2; one
    MoE sub-layer for grok) crosses into the port and back unchanged, and
    to_jax_layout / from_jax_layout round-trip the names."""
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_tree(jb, 5)
    params = params_from_numpy(pb.cfg, jp)
    assert jax.tree.all(jax.tree.map(np.array_equal, pb.model.params_to_numpy(params), jp))
    assert jax.tree.structure(pb.model.params_to_numpy(params)) == jax.tree.structure(jp)
    named = dict(params.named_parameters())
    back = pb.model.from_jax_layout(pb.model.to_jax_layout(named))
    assert back.keys() == named.keys()
    assert all(torch.equal(back[n], x) for n, x in named.items())
    g = pb.cfg.group_size
    moe_layers = sorted({int(n.split(".")[1]) for n in named if ".moe." in n})
    assert moe_layers == list(range(g - 1, pb.cfg.n_layers, g))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_counts_match_jax_at_full_width(arch):
    jc, pc = jget_arch(arch).cfg, get_arch(arch).cfg
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()
    # and the drawn tree holds exactly param_count() parameters (shapes alone)
    meta = get_arch(arch).model.init_params(None, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == pc.param_count()
