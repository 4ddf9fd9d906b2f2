"""Training the six non-dense families (MoE llama4-maverick and grok-1,
mamba2, zamba2, whisper, internvl) against the JAX package on the CPU.

The same weights (drawn by the port, handed to the JAX package in its own
init tree, ``test_torch_moe.carried``), tokens and stub inputs (whisper's
frames, internvl's patches: numpy normals) go to both packages; both run
f32 on the reduced configs. Bars:

* the loss within 1e-5 relative, and every gradient leaf within 1e-4 of
  that leaf's largest magnitude, with an absolute floor of 1e-8: whisper's
  key biases (``enc_layers/attn/k/b``, ``dec_layers/cross_attn/k/b``) have
  an exact gradient of zero (a softmax does not move when a constant is
  added to every key), and both sides give rounding noise of ~1e-10 there;
* three AdamW steps through ``make_train_artifacts``: losses and grad
  norms within 1e-4 relative at every step, the parameters under
  ``test_torch_train.test_train_steps_match_jax``'s bar;
* rematerialisation bitwise.

MoE routing is discontinuous: the routing of both sides is recorded
(``test_torch_moe.routing``) and held by ``agreeing_rows``. The gradients
of a batch mix its rows, so they are compared on the rows whose expert
choices agree (all of them here, as the assertion on the rerun shows); a
training step's loss likewise needs every row to agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.hierarchical import HierarchicalConfig as JHierarchicalConfig
from repro.train.steps import make_train_artifacts as jmake_train_artifacts
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts
from test_torch_moe import carried, routing  # noqa: F401  (a fixture)
from test_torch_moe_routing import agreeing_rows
from test_torch_train import flat, port_tree_as_jax

T = torch.from_numpy
FAMILIES = ["llama4-maverick-400b-a17b", "grok-1-314b", "mamba2-2.7b", "zamba2-1.2b",
            "whisper-medium", "internvl2-76b"]
MOE = FAMILIES[:2]
GIANTS = ["llama4-maverick-400b-a17b", "grok-1-314b", "internvl2-76b"]  # bf16 moments


def family_batch(bundle, b, s, seed) -> dict[str, np.ndarray]:
    """Tokens and labels, and the stub frontends' inputs (numpy normals)."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, bundle.cfg.vocab, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    for name, make in bundle.extra_inputs.items():
        batch[name] = rng.normal(size=tuple(make(b, s).shape)).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: T(v) for k, v in batch.items()}


def _loss_and_grads(jb, pb, jp, params, batch):
    """(JAX loss, JAX gradients as flat leaves, port loss, port gradients
    as the same leaves)."""
    loss_j, grads_j = jax.jit(jax.value_and_grad(jb.loss))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    named = dict(params.named_parameters())
    loss = pb.loss(params, _port_batch(batch))
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss_j, flat(grads_j), loss.detach(), port_tree_as_jax(pb.model, dict(zip(named, grads)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax_value_and_grad(arch, routing):  # noqa: F811
    """``Bundle.loss`` and its autograd gradients against
    ``jax.value_and_grad(bundle.loss)``, B 2 x S 16: every leaf, through the
    router, the capacity dispatch and 0.01 x the aux loss (MoE), the SSD scan
    (mamba2, zamba2), the encoder and cross-attention (whisper) and the
    connector and splice (internvl)."""
    port_rec, ref_rec = routing
    jb, pb, jp, params = carried(arch, 0)
    params.requires_grad_()
    batch = family_batch(pb, 2, 16, 1)
    loss_j, want, loss, got = _loss_and_grads(jb, pb, jp, params, batch)
    if arch in MOE:
        rows = agreeing_rows(port_rec, ref_rec)
        if not rows.all():
            port_rec.clear()
            ref_rec.clear()
            batch = {k: v[rows] for k, v in batch.items()}
            loss_j, want, loss, got = _loss_and_grads(jb, pb, jp, params, batch)
            assert agreeing_rows(port_rec, ref_rec).all()
    else:
        assert not port_rec and not ref_rec
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert got.keys() == want.keys()
    for key, g in want.items():
        assert got[key].shape == g.shape, key
        bar = max(1e-4 * np.abs(g).max(), 1e-8)
        assert np.abs(got[key] - g).max() <= bar, (key, np.abs(got[key] - g).max(), bar)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_artifacts_shapes_and_moment_dtypes_match_jax(arch):
    """``make_train_artifacts``' meta-device parameter and optimizer shapes
    against the JAX artifacts' ShapeDtypeStructs, sync and hierarchical,
    in the model's own JAX layout: the bundle's moment dtype (bf16 for the
    giants) reaches ``adamw_init``."""
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    md = "bfloat16" if arch in GIANTS else "float32"
    assert pb.moment_dtype == jb.moment_dtype == md
    for hier in (None, "int8"):
        jart = jmake_train_artifacts(
            jb, mesh=None, fsdp_axis=None,
            hier_cfg=None if hier is None else JHierarchicalConfig(compression=hier))
        art = make_train_artifacts(
            pb, hier_cfg=None if hier is None else HierarchicalConfig(compression=hier))
        lead = 0 if hier is None else 1

        def shapes(tree):
            return {k: (x.shape, str(x.dtype)) for k, x in flat(tree).items()}

        def port(named):
            return shapes(jax.tree.map(
                lambda x: np.empty(x.shape, str(x.dtype).removeprefix("torch.")),
                pb.model.to_jax_layout(named, lead),
                is_leaf=lambda x: isinstance(x, torch.Tensor)))

        assert port(named_leaves(art.params_sds)) == shapes(jax.tree.map(
            lambda s: np.empty(s.shape, s.dtype), jart.params_sds))
        for part in ("m", "v"):
            want = shapes(jax.tree.map(lambda s: np.empty(s.shape, s.dtype),
                                       jart.opt_sds[part]))
            assert port(art.opt_sds[part]) == want
            assert {d for _, d in want.values()} == {md}


def _jax_state(jp, opt_cfg, hier=None):
    params = jax.tree.map(jnp.asarray, jp)
    opt = jadamw_init(params, opt_cfg)
    if hier is None:
        return params, opt, None
    return hier.replicate(params), hier.replicate(opt), hier.init_sync_state(params)


STEP_CASES = {"mamba2-2.7b-sync": ("mamba2-2.7b", None),
              "grok-1-314b-sync": ("grok-1-314b", None),
              "mamba2-2.7b-hier_int8": ("mamba2-2.7b", "int8")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case, routing):  # noqa: F811
    """Three AdamW steps of ``make_train_artifacts`` from the same weights
    and batches as the JAX artifacts (grok with its bf16 moments), or three
    hierarchical local steps (2 pods) and an int8 sync. Losses and grad
    norms within 1e-4 relative at every step, every MoE layer's routing
    the same on both sides, and the parameters as
    ``test_torch_train.test_train_steps_match_jax`` bounds them (AdamW's
    normalised step: every element within 2 x lr x steps, 99% within 1e-5
    of the largest, plus an int8 grid step after the sync)."""
    arch, compression = STEP_CASES[case]
    port_rec, ref_rec = routing
    jb, pb, jp, params = carried(arch, 0)
    lr, steps = 1e-3, 3
    md = pb.moment_dtype
    jopt_cfg = JAdamWConfig(lr=lr, warmup_steps=2, moment_dtype=md)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=2, moment_dtype=md)
    hier_cfg = None if compression is None else dict(sync_every=steps, compression=compression)
    jart = jmake_train_artifacts(
        jb, jopt_cfg, mesh=None, fsdp_axis=None, donate=False,
        hier_cfg=None if hier_cfg is None else JHierarchicalConfig(**hier_cfg))
    art = make_train_artifacts(
        pb, opt_cfg, n_pods=2, hier_cfg=None if hier_cfg is None else HierarchicalConfig(**hier_cfg))
    jparams, jopt, jsync = _jax_state(jp, jopt_cfg, jart.hier)
    params.requires_grad_()
    opt = adamw_init(params, opt_cfg)
    sync = None
    if art.hier is not None:
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    ds = SyntheticLM(pb.cfg.vocab, 16, 4, seed=1)
    pods = None if hier_cfg is None else 2
    for step in range(steps):
        b = ds.batch(step)
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        if pods:
            jbatch = {k: v.reshape((pods, 2) + v.shape[1:]) for k, v in jbatch.items()}
        jparams, jopt, jmet = jart.step_fn(jparams, jopt, jbatch)
        jax.block_until_ready(jmet["loss"])
        params, opt, met = art.step_fn(params, opt, host_batch(b, "cpu", n_pods=pods))
        if arch in MOE:
            assert agreeing_rows(port_rec, ref_rec).all(), step
            port_rec.clear()
            ref_rec.clear()
        for name in ("loss", "grad_norm"):
            want = np.asarray(jmet[name], np.float64)
            got = met[name].detach().double().numpy()
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), (step, name)
        assert np.array_equal(opt["count"].numpy(), np.asarray(jopt["count"]))
    if hier_cfg is not None:
        jparams, jsync = jart.sync_fn(jparams, jsync)
        params, sync = art.sync_fn(params, sync)
    lead = 0 if pods is None else 1
    got = port_tree_as_jax(pb.model, named_leaves(params), lead)
    want = flat(jparams)
    top = max(np.abs(w).max() for w in want.values())
    bar = 1e-5 * top + (2 * lr * steps / 127 if compression == "int8" else 0.0)
    close = total = 0
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * lr * steps, key
        close += int((d <= bar).sum())
        total += d.size
    assert close >= 0.99 * total
    for part in ("m", "v"):
        assert all(x.dtype == getattr(torch, md) for x in opt[part].values())


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b", "whisper-medium"])
def test_remat_equals_no_remat_bitwise(arch, remat):
    """The layer bodies that the JAX package checkpoints (every mamba layer,
    whisper's encoder and its decoder without a cache) recompute the same
    ops on the same inputs: the loss and every gradient are bitwise those
    of ``remat="none"``, and the checkpoints are really taken (the forward
    under autograd keeps fewer tensors for the backward)."""
    out, saved = [], []
    for mode in ("none", remat):
        bundle = get_arch(arch, reduced=True, remat=mode)
        params = bundle.model.init_params(torch.Generator().manual_seed(2)).requires_grad_()
        batch = _port_batch(family_batch(bundle, 2, 16, 3))
        count = [0]

        def pack(x, count=count):
            count[0] += 1
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss = bundle.loss(params, batch)
        saved.append(count[0])
        out.append((loss, torch.autograd.grad(loss, list(params.parameters()))))
    assert saved[1] < saved[0], saved
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)



def test_adamw_update_in_pieces_is_bitwise_the_whole_update(monkeypatch):
    """The update runs over pieces of the leaves (so that a 6.5 G-parameter
    model's f32 temporaries stay near 1 GiB on the card): pieces of 97
    elements, cutting leaves and gathering small ones, give the one-piece
    update bitwise over three steps, bf16 and f32 parameters and moments."""
    from repro_torch.optim import adamw

    rng = np.random.default_rng(0)
    shapes = {"a": (300, 7), "b": (5,), "c": (33, 10, 3), "d": (1000,)}
    for md in ("float32", "bfloat16"):
        for dt in (torch.float32, torch.bfloat16):
            p = {k: T(rng.normal(size=s).astype(np.float32)).to(dt) for k, s in shapes.items()}
            g = {k: T(rng.normal(size=s).astype(np.float32)).to(dt) for k, s in shapes.items()}
            cfg = AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype=md)
            runs = []
            for piece in (1 << 26, 97):
                monkeypatch.setattr(adamw, "UPDATE_PIECE", piece)
                params, state = {k: x.clone() for k, x in p.items()}, adamw_init(p, cfg)
                for _ in range(3):
                    adamw.adamw_update(g, state, params, cfg)
                runs.append((params, state))
            (p1, s1), (p2, s2) = runs
            for k in shapes:
                assert torch.equal(p1[k], p2[k]), (md, dt, k)
                assert torch.equal(s1["m"][k], s2["m"][k]) and torch.equal(s1["v"][k], s2["v"][k])
    assert adamw._pieces([5, 300, 2, 200], 100) == [
        [(0, 0, 5)], [(1, 0, 100)], [(1, 100, 200)], [(1, 200, 300)], [(2, 0, 2)],
        [(3, 0, 100)], [(3, 100, 200)]]
