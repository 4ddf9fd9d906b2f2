"""The port's training path against the JAX package on the CPU.

The loss and its gradients (reduced qwen2-0.5b, olmo-1b, gemma3-27b, through
``params_from_numpy``), rematerialisation, AdamW, the int8 / top-k
compression, the hierarchical sync, the pod resize, the synthetic data and
whole training steps get the same inputs, made from a seed with numpy, on
both sides. Both run f32. Tolerances: CE 1e-6 relative; the loss 1e-5
relative and each leaf's gradient within 1e-4 of that leaf's largest
magnitude; AdamW and the sync 1e-6 relative; compression, the resize and the
data bitwise; training losses 1e-4 relative at every step (the bar on the
parameters after the steps is stated at ``test_train_steps_match_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro.checkpoint.manager import elastic_pod_resize as jresize
from repro.configs.registry import get_arch as jget_arch
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import compress as jcompress
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.hierarchical import Hierarchical as JHierarchical
from repro.optim.hierarchical import HierarchicalConfig as JHierarchicalConfig
from repro.train.steps import make_train_artifacts as jmake_train_artifacts
from repro_torch.checkpoint.manager import elastic_pod_resize
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.hierarchical import Hierarchical, HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts

T = torch.from_numpy
ARCHS = ["qwen2-0.5b", "olmo-1b", "gemma3-27b"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_params(model, seed):
    return jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))


def flat(tree) -> dict[str, np.ndarray]:
    """A JAX tree's leaves keyed by their path, ``a/b/c``."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in leaves}


def port_tree_as_jax(model, named, lead=0) -> dict[str, np.ndarray]:
    """Tensors keyed by the port's parameter names (gradients, parameters)
    as :func:`flat` of ``model``'s JAX tree."""
    return flat(jax.tree.map(lambda x: x.detach().numpy(), model.to_jax_layout(named, lead),
                             is_leaf=lambda x: isinstance(x, torch.Tensor)))


def lm_batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}


@pytest.fixture
def lowered_threshold(monkeypatch):
    """FLASH_THRESHOLD lowered to 16 in both packages, so 16+ token
    sequences take the streaming path."""
    monkeypatch.setattr(jl, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tl, "FLASH_THRESHOLD", 16)


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (30, 8), (24, 1024)])
def test_cross_entropy_and_chunked_cross_entropy_match_jax(s, chunk):
    """Full CE and chunked CE (several chunks, one, and the single-chunk
    fall-back when ``S % chunk``) against JAX, and chunked against full."""
    rng = np.random.default_rng(s + chunk)
    b, d, v = 2, 16, 50
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7
    logits = h @ w
    want = jax.jit(jl.cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    got = tl.cross_entropy(T(logits), T(labels))
    assert rel(got, want) < 1e-6
    want_m = jax.jit(jl.cross_entropy)(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    assert rel(tl.cross_entropy(T(logits), T(labels), T(mask)), want_m) < 1e-6
    jw = jnp.asarray(w)
    want_c = jax.jit(lambda h, y: jl.chunked_cross_entropy(lambda x: x @ jw, h, y, chunk))(
        jnp.asarray(h), jnp.asarray(labels))
    tw = T(w)
    got_c = tl.chunked_cross_entropy(lambda x: x @ tw, T(h), T(labels), chunk)
    assert rel(got_c, want_c) < 1e-6
    assert rel(got_c, got) < 1e-6


def test_chunked_cross_entropy_gradients_match_the_full_loss():
    """Under autograd each chunk is a checkpoint: the gradients of h and of
    the unembedding equal those of the unchunked CE."""
    rng = np.random.default_rng(3)
    h = T(rng.normal(size=(2, 32, 16)).astype(np.float32)).requires_grad_()
    w = T(rng.normal(size=(16, 40)).astype(np.float32)).requires_grad_()
    y = T(rng.integers(0, 40, (2, 32)))
    got = torch.autograd.grad(tl.chunked_cross_entropy(lambda x: x @ w, h, y, 8), (h, w))
    want = torch.autograd.grad(tl.cross_entropy(h @ w, y), (h, w))
    for g, r in zip(got, want):
        assert rel(g, r) < 1e-5


@pytest.mark.parametrize("path", ["dense", "streaming"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, path, monkeypatch):
    """``Bundle.loss`` and its autograd gradients against
    ``jax.value_and_grad(bundle.loss)``: 32 tokens on the dense attention
    path, and with FLASH_THRESHOLD lowered to 16 in both packages on the
    streaming path (the one training takes at S >= 2048)."""
    if path == "streaming":
        monkeypatch.setattr(jl, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(tl, "FLASH_THRESHOLD", 16)
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_params(jb.model, 0)
    batch = lm_batch(jb.cfg.vocab, 2, 32, 1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jb.loss))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(pb.cfg, jp)
    assert jax.tree.all(jax.tree.map(np.array_equal, pb.model.params_to_numpy(params), jp))
    params.requires_grad_()
    named = dict(params.named_parameters())
    loss = pb.loss(params, {k: T(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    assert rel(loss.detach(), loss_j) < 1e-5
    got, want = port_tree_as_jax(pb.model, dict(zip(named, grads))), flat(grads_j)
    assert got.keys() == want.keys()
    for key, g in want.items():
        assert got[key].shape == g.shape, key
        assert np.abs(got[key] - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-30), key


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bitwise(arch, remat, lowered_threshold):
    """Rematerialised layers recompute the same ops on the same inputs: the
    loss and every gradient are bitwise those of ``remat="none"``."""
    base = get_arch(arch, reduced=True)
    out = []
    for mode in ("none", remat):
        bundle = get_arch(arch, reduced=True, remat=mode)
        params = base.model.init_params(torch.Generator().manual_seed(2)).requires_grad_()
        batch = {k: T(v) for k, v in lm_batch(base.cfg.vocab, 2, 32, 3).items()}
        loss = bundle.loss(params, batch)
        out.append((loss, torch.autograd.grad(loss, list(params.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(remat):
    bundle = get_arch("qwen2-0.5b", reduced=True, remat=remat)
    params = bundle.model.init_params(torch.Generator().manual_seed(4)).requires_grad_()
    tokens = T(lm_batch(bundle.cfg.vocab, 2, 32, 5)["tokens"]).long()
    h, _ = bundle.model.hidden(params, tokens)
    counter = _OpCounter()
    with counter:
        h.sum().backward()
    return counter.counts


def test_dots_policy_saves_the_weight_products_and_recomputes_the_rest(lowered_threshold):
    """``remat="dots"`` re-runs no ``mm`` in the backward (the weight
    products are saved, as ``checkpoint_dots_with_no_batch_dims`` saves
    them) but re-runs attention's batched products (``bmm``) and the
    elementwise work; ``"full"`` re-runs the ``mm`` too."""
    ops_none, ops_dots, ops_full = (_backward_ops(r) for r in ("none", "dots", "full"))
    # q, k, v, o, gate, up: "full"'s recompute stops once every saved tensor
    # is back, and the down projection's output is saved by nothing.
    n_layers, recomputed = 2, 6
    assert ops_dots["mm"] == ops_none["mm"]
    assert ops_full["mm"] == ops_none["mm"] + n_layers * recomputed
    assert ops_dots["bmm"] > ops_none["bmm"] and ops_full["bmm"] == ops_dots["bmm"]
    assert ops_dots["exp"] > ops_none.get("exp", 0)


# ---------------------------------------------------------------------------
# the optimizer and the slow tier


ADAMW_CASES = {
    "default": dict(cfg=dict(lr=1e-3, warmup_steps=1), count=0, gscale=0.1),
    "clip": dict(cfg=dict(lr=1e-3, warmup_steps=1, grad_clip=1.0), count=3, gscale=10.0),
    "no_clip": dict(cfg=dict(lr=1e-3, warmup_steps=1, grad_clip=0.0), count=1, gscale=10.0),
    "bf16_moments": dict(cfg=dict(lr=1e-3, warmup_steps=1, moment_dtype="bfloat16"),
                         count=2, gscale=0.1),
    "warmup": dict(cfg=dict(lr=3e-4, warmup_steps=10), count=4, gscale=0.1),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_update_matches_jax(case):
    """One update from the same grads, params and state (moments and count
    carried over): params, ``m``, ``v`` within 1e-6 relative; ``count`` and
    ``lr`` equal; the grad norm within 1e-6."""
    c = ADAMW_CASES[case]
    rng = np.random.default_rng(len(case))
    shapes = {"a": (8, 5), "b": (7,), "c": (3, 4, 2)}
    md = c["cfg"].get("moment_dtype", "float32")
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * c["gscale"]).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.01).astype(np.float32) for k, s in shapes.items()}
    v = {k: (rng.random(s) * 1e-4).astype(np.float32) for k, s in shapes.items()}
    jcfg, tcfg = JAdamWConfig(**c["cfg"]), AdamWConfig(**c["cfg"])
    jm = {k: jnp.asarray(x).astype(md) for k, x in m.items()}
    jv = {k: jnp.asarray(x).astype(md) for k, x in v.items()}
    jstate = {"m": jm, "v": jv, "count": jnp.int32(c["count"])}
    jp, js, jmet = jax.jit(lambda g, s, p: jadamw_update(g, s, p, jcfg))(
        jax.tree.map(jnp.asarray, g), jstate, jax.tree.map(jnp.asarray, p))
    tdt = getattr(torch, md)
    state = {"m": {k: T(x).to(tdt) for k, x in m.items()},
             "v": {k: T(x).to(tdt) for k, x in v.items()},
             "count": torch.tensor(c["count"], dtype=torch.int32)}
    params = {k: T(x.copy()) for k, x in p.items()}
    params, state, met = adamw_update({k: T(x) for k, x in g.items()}, state, params, tcfg)
    assert int(state["count"]) == int(js["count"]) == c["count"] + 1
    assert float(met["lr"]) == float(jmet["lr"])
    assert rel(met["grad_norm"], jmet["grad_norm"]) < 1e-6
    for k in shapes:
        assert rel(params[k], jp[k]) < 1e-6, k
        assert state["m"][k].dtype == tdt and state["v"][k].dtype == tdt
        for name in ("m", "v"):
            assert rel(state[name][k].float(), np.asarray(js[name][k], np.float32)) < 1e-6, (name, k)


def test_adamw_init_and_global_norm_match_jax():
    p = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)}
    for md in ("float32", "bfloat16"):
        st = adamw_init({k: T(x) for k, x in p.items()}, AdamWConfig(moment_dtype=md))
        js = jadamw_init(p, JAdamWConfig(moment_dtype=md))
        assert int(st["count"]) == 0 and st["count"].dtype == torch.int32
        for k in p:
            assert tuple(st["m"][k].shape) == js["m"][k].shape
            assert str(st["v"][k].dtype).endswith(md) and not st["v"][k].any()
    from repro.optim.adamw import global_norm as jglobal_norm
    assert rel(global_norm({k: T(x) for k, x in p.items()}), jglobal_norm(p)) < 1e-6


def _compress_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(33, 17)) * 3).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round half to even on both sides
    ef = (rng.normal(size=(33, 17)) * 0.01).astype(np.float32)
    return x, ef


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_encode_and_decode_are_bitwise_jax(seed):
    x, _ = _compress_inputs(seed)
    qj, sj = jax.jit(jcompress.int8_encode)(jnp.asarray(x))
    q, s = compress.int8_encode(T(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert np.array_equal(compress.int8_decode(q, s).numpy(),
                          np.asarray(jax.jit(jcompress.int8_decode)(qj, sj)))
    # exact halves on the grid of the scale round to even
    grid = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    assert np.array_equal(compress.int8_encode(T(grid))[0].numpy(),
                          np.asarray(jcompress.int8_encode(jnp.asarray(grid))[0]))


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_ef_compress_is_bitwise_jax(method):
    x, ef = _compress_inputs(5)
    dj, ej, wj = jax.jit(lambda x, e: jcompress.ef_compress(x, e, method, 0.05))(
        jnp.asarray(x), jnp.asarray(ef))
    d, e, w = compress.ef_compress(T(x), T(ef), method, 0.05)
    assert np.array_equal(d.numpy(), np.asarray(dj)) and np.array_equal(e.numpy(), np.asarray(ej))
    assert (w is None) == (wj is None)
    if w is not None:
        assert np.array_equal(w.numpy(), np.asarray(wj))
    mask = compress.topk_mask(T(x), 0.1)
    assert np.array_equal(mask.numpy(), np.asarray(jcompress.topk_mask(jnp.asarray(x), 0.1)))


@pytest.mark.parametrize("n_pods,live", [(2, None), (3, None), (3, (True, False, True)),
                                         (4, (False, True, True, True))])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_sync_step_matches_jax(compression, n_pods, live):
    """The slow tier from the same replicas, anchor and residuals, with and
    without a dropped pod: params, anchor and residuals within 1e-6."""
    rng = np.random.default_rng(n_pods + 7 * (live is not None))
    shapes = {"w": (6, 5), "b": (9,)}
    anchor = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    pods = {k: (anchor[k][None] + rng.normal(size=(n_pods,) + s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}
    ef = {k: (rng.normal(size=(n_pods,) + s) * 0.001).astype(np.float32)
          for k, s in shapes.items()}
    cfg = dict(sync_every=4, compression=compression)
    jh = JHierarchical(JHierarchicalConfig(**cfg), n_pods)
    jstate = {"anchor": jax.tree.map(jnp.asarray, anchor)}
    state = {"anchor": {k: T(x.copy()) for k, x in anchor.items()}}
    if compression != "none":
        jstate["ef"] = jax.tree.map(jnp.asarray, ef)
        state["ef"] = {k: T(x.copy()) for k, x in ef.items()}
    jlive = None if live is None else jnp.asarray(live)
    jp, js = jax.jit(jh.sync_step)(jax.tree.map(jnp.asarray, pods), jstate, jlive)
    h = Hierarchical(HierarchicalConfig(**cfg), n_pods)
    tp, ts = h.sync_step({k: T(x.copy()) for k, x in pods.items()}, state,
                         None if live is None else torch.tensor(live))
    assert ts.keys() == js.keys()
    for k in shapes:
        assert rel(tp[k], jp[k]) < 1e-6
        assert torch.equal(tp[k][0], tp[k][-1])  # every pod leaves with the average
        for part in ts:
            assert rel(ts[part][k], js[part][k]) < 1e-6, (part, k)
    if compression == "int8":
        assert h.wire_bytes == n_pods * (30 + 9 + 2 * 4)  # int8 payload + f32 scales


def test_replicate_and_init_sync_state_match_jax_shapes():
    bundle = get_arch("qwen2-0.5b", reduced=True)
    params = bundle.model.init_params(torch.Generator().manual_seed(0))
    h = Hierarchical(HierarchicalConfig(compression="int8"), 3)
    pods = h.replicate(params)
    for (n, x), y in zip(pods.named_parameters(), params.parameters()):
        assert x.shape == (3,) + tuple(y.shape)
        assert all(torch.equal(x[i], y) for i in range(3)), n
        assert x.data_ptr() != y.data_ptr()
    state = h.init_sync_state(params)
    assert state["anchor"].keys() == state["ef"].keys() == dict(params.named_parameters()).keys()
    assert all(x.dtype == torch.float32 and x.shape[0] == 3 for x in state["ef"].values())
    view = h.pod(pods, 1)
    with torch.no_grad():
        view.embed.add_(1.0)  # a pod's view writes through to the stacked leaf
    assert torch.equal(pods.embed[1], params.embed + 1.0)
    assert torch.equal(pods.embed[0], params.embed)


@pytest.mark.parametrize("n_new", [1, 2, 4])
@pytest.mark.parametrize("n_old", [2, 3])
def test_elastic_pod_resize_is_bitwise_jax(n_old, n_new):
    rng = np.random.default_rng(n_old * 10 + n_new)
    tree = {"params": {"w": rng.normal(size=(n_old, 4, 3)).astype(np.float32)},
            "opt": {"count": np.full((n_old,), 5, np.int32),
                    "m": {"w": rng.normal(size=(n_old, 4, 3)).astype(np.float32)}}}
    want = jax.tree.map(np.asarray, jresize(tree, n_new))
    got = elastic_pod_resize({"params": {"w": T(tree["params"]["w"])},
                              "opt": {"count": T(tree["opt"]["count"]),
                                      "m": {"w": T(tree["opt"]["m"]["w"])}}}, n_new)
    got_np = elastic_pod_resize(tree, n_new)
    for key, w in flat(want).items():
        parts = key.split("/")
        g, gn = got, got_np
        for part in parts:
            g, gn = g[part], gn[part]
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), key
        assert gn.dtype == w.dtype and np.array_equal(gn, w), key


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_synthetic_lm_batches_are_bitwise_jax(seed):
    jds, ds = JSyntheticLM(512, 24, 4, seed), SyntheticLM(512, 24, 4, seed)
    for step, (bj, bt) in enumerate(zip(jds.batches(7), ds.batches(7))):
        assert bj.keys() == bt.keys()
        for k in bj:
            assert bt[k].dtype == bj[k].dtype and np.array_equal(bt[k], bj[k]), (step, k)
        if step == 3:
            break
    b = host_batch(ds.batch(0), "cpu", n_pods=2)
    assert b["tokens"].shape == (2, 2, 24) and b["tokens"].dtype == torch.int32
    assert np.array_equal(b["labels"].reshape(4, 24).numpy(), ds.batch(0)["labels"])


def test_host_batch_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host_batch(SyntheticLM(64, 8, 2).batch(0))


# ---------------------------------------------------------------------------
# whole training steps


def _jax_state(jb, jp, opt_cfg, hier=None):
    params = jax.tree.map(jnp.asarray, jp)
    opt = jadamw_init(params, opt_cfg)
    if hier is None:
        return params, opt, None
    return hier.replicate(params), hier.replicate(opt), hier.init_sync_state(params)


@pytest.mark.parametrize("mode", ["sync", "sync_n_micro_2", "hier_none", "hier_int8"])
def test_train_steps_match_jax(mode, lowered_threshold):
    """``make_train_artifacts`` from the same params and batches as the JAX
    one: 5 sync steps (``n_micro`` 1 and 2), or 4 hierarchical local steps
    (2 pods) and a sync. Losses within 1e-4 relative at every step, and
    the grad norms too.

    The parameters after the steps: AdamW's step is ``m / (sqrt(v) + eps)``,
    about ``lr`` in size whatever the gradient's, so an element whose
    gradients are within rounding of zero can step the other way on the
    other side. The bar is therefore per element ``2 * lr * steps`` (the
    most such sign flips can move it), and 99% of the elements within 1e-5
    of the largest parameter. After an int8 sync an element near a
    rounding boundary of the int8 grid can land one grid step away, so
    there the 99% bar adds one step of a grid spanning ``2 * lr * steps``
    (``/ 127``)."""
    arch = "qwen2-0.5b"
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = jax_params(jb.model, 0)
    lr = 1e-3
    jopt_cfg, opt_cfg = JAdamWConfig(lr=lr, warmup_steps=2), AdamWConfig(lr=lr, warmup_steps=2)
    n_micro = 2 if mode == "sync_n_micro_2" else 1
    hier_cfg = None
    if mode.startswith("hier"):
        hier_cfg = dict(sync_every=4, compression=mode.split("_")[1])
    jart = jmake_train_artifacts(
        jb, jopt_cfg, mesh=None, fsdp_axis=None, n_micro=n_micro, donate=False,
        hier_cfg=None if hier_cfg is None else JHierarchicalConfig(**hier_cfg))
    art = make_train_artifacts(
        pb, opt_cfg, n_micro=n_micro, n_pods=2,
        hier_cfg=None if hier_cfg is None else HierarchicalConfig(**hier_cfg))
    jparams, jopt, jsync = _jax_state(jb, jp, jopt_cfg, jart.hier)
    params = params_from_numpy(pb.cfg, jp).requires_grad_()
    opt = adamw_init(params, opt_cfg)
    sync = None
    if art.hier is not None:
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    ds = SyntheticLM(jb.cfg.vocab, 32, 4, seed=1)
    steps = 5 if hier_cfg is None else 4
    for step in range(steps):
        b = ds.batch(step)
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        if hier_cfg is not None:
            jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in jbatch.items()}
        jparams, jopt, jmet = jart.step_fn(jparams, jopt, jbatch)
        params, opt, met = art.step_fn(params, opt, host_batch(
            b, "cpu", n_pods=None if hier_cfg is None else 2))
        assert rel(met["loss"], jmet["loss"]) < 1e-4, step
        assert rel(met["grad_norm"], jmet["grad_norm"]) < 1e-4, step
        assert np.array_equal(opt["count"].numpy(), np.asarray(jopt["count"]))
    if hier_cfg is not None:
        jparams, jsync = jart.sync_fn(jparams, jsync)
        params, sync = art.sync_fn(params, sync)
        for x in params.parameters():
            assert torch.equal(x[0], x[1])
    lead = 0 if hier_cfg is None else 1
    got = port_tree_as_jax(pb.model, named_leaves(params), lead)
    want = flat(jparams)
    top = max(np.abs(w).max() for w in want.values())
    bar = 1e-5 * top + (2 * lr * steps / 127 if mode == "hier_int8" else 0.0)
    close = total = 0
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * lr * steps, key
        close += int((d <= bar).sum())
        total += d.size
    assert close >= 0.99 * total


def test_train_artifacts_shapes_match_jax():
    """The parameter, optimizer and sync shapes on the meta device against
    the JAX artifacts' ShapeDtypeStructs, and the batch specs against
    ``Bundle.input_specs``."""
    from repro.configs.common import ShapeSpec as JShapeSpec
    jb, pb = jget_arch("olmo-1b", reduced=True), get_arch("olmo-1b", reduced=True)
    for hier in (None, "int8"):
        jart = jmake_train_artifacts(
            jb, mesh=None, fsdp_axis=None,
            hier_cfg=None if hier is None else JHierarchicalConfig(compression=hier))
        art = make_train_artifacts(
            pb, hier_cfg=None if hier is None else HierarchicalConfig(compression=hier))
        lead = 0 if hier is None else 1
        assert all(x.device.type == "meta" for x in named_leaves(art.params_sds).values())
        want = flat(jax.tree.map(lambda s: np.empty(s.shape, s.dtype), jart.params_sds))
        got = flat(jax.tree.map(
            lambda x: np.empty(x.shape, str(x.dtype).removeprefix("torch.")),
            pb.model.to_jax_layout(named_leaves(art.params_sds), lead),
            is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert {k: (x.shape, x.dtype) for k, x in got.items()} == \
            {k: (x.shape, x.dtype) for k, x in want.items()}
        for part in ("m", "v"):
            assert {n: tuple(x.shape) for n, x in art.opt_sds[part].items()} == \
                {n: tuple(x.shape) for n, x in named_leaves(art.params_sds).items()}
        assert tuple(art.opt_sds["count"].shape) == jart.opt_sds["count"].shape
        if hier is not None:
            assert art.sync_sds["ef"].keys() == art.sync_sds["anchor"].keys()
    for shape in (SHAPES["train_4k"].reduced(), SHAPES["train_4k"]):
        jspecs = jb.input_specs(JShapeSpec(*dataclasses.astuple(shape)))
        specs = pb.input_specs(shape)
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}
        assert all(v.dtype == torch.int32 and v.device.type == "meta" for v in specs.values())
    assert SHAPES["train_4k"].reduced() == ShapeSpec("train_4k", "train", 32, 2)


def test_a_train_step_needs_trainable_parameters():
    bundle = get_arch("qwen2-0.5b", reduced=True)
    params = bundle.model.init_params(torch.Generator().manual_seed(0))  # frozen
    art = make_train_artifacts(bundle)
    batch = host_batch(SyntheticLM(bundle.cfg.vocab, 16, 2).batch(0), "cpu")
    with pytest.raises(ValueError, match="requires_grad_"):
        art.step_fn(params, adamw_init(params, AdamWConfig()), batch)


# ---------------------------------------------------------------------------
# the flash kernel under autograd


def test_flash_attention_refuses_grad_and_serving_still_reaches_it(monkeypatch,
                                                                   lowered_threshold):
    """With grad mode on and an input that requires grad the kernel's entry
    point raises on every device (here the CPU: the plain version would
    have carried the gradients the card's kernel drops). Under
    ``inference_mode`` / ``no_grad`` the use_pallas forward still reaches
    it, once per layer, and a training step of a use_pallas config raises
    where the JAX kernel cannot be differentiated either."""
    rng = np.random.default_rng(0)
    q = T(rng.normal(size=(1, 16, 2, 16)).astype(np.float32)).requires_grad_()
    k, v = (T(rng.normal(size=(1, 16, 1, 16)).astype(np.float32)) for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, 0, 16)
    with torch.no_grad():
        ops.flash_attention(q, k, v, 0, 16)
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    bundle = get_arch("qwen2-0.5b", reduced=True, use_pallas_attention=True)
    params = bundle.model.init_params(torch.Generator().manual_seed(0))
    tokens = T(lm_batch(bundle.cfg.vocab, 2, 32, 0)["tokens"])
    with torch.inference_mode():
        bundle.model.forward(params, tokens)
    assert len(calls) == bundle.cfg.n_layers
    bundle.model.forward(params, tokens)  # frozen weights: nothing requires grad
    assert len(calls) == 2 * bundle.cfg.n_layers
    params.requires_grad_()
    with pytest.raises(RuntimeError, match="use_pallas_attention=False"):
        bundle.loss(params, {"tokens": tokens, "labels": tokens})
