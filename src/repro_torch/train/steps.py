"""Train and serve step builders: the glue between bundles, optimizer and
mesh. The port of ``repro.train.steps``.

``make_train_artifacts`` gives the step callable(s), the spec trees of the
parameters, optimizer, batch and sync state (the JAX artifacts' specs, each
``PartitionSpec`` a tuple, keyed in the JAX layout), and their shapes as
meta tensors (the JAX package's ``ShapeDtypeStruct`` trees). Two training
modes:

* ``sync`` (baseline): one parameter replica, one AdamW step on the batch's
  gradients, summed over every batch axis (the pods' too);
* ``hierarchical`` (the paper's technique): per-pod replicas, local steps
  and a separate every-D-steps ``sync_fn``.

Gradients come from ``torch.autograd`` on parameters that require grad
(``params.requires_grad_()``); with ``n_micro`` > 1 they accumulate in f32
over microbatches. A step updates its parameters and optimizer state in
place (the JAX step donates them) and returns them.

**On a mesh** (a :class:`~repro_torch.core.mesh.ProcessMesh`) every leaf of
the training state is held as this rank's shard, cut by its spec
(:meth:`TrainArtifacts.shard`; :func:`shard_state` / :func:`gather_state`
carry whole JAX-layout trees). A step runs the forward and backward on this
rank's slice of the batch (:func:`~repro_torch.data.pipeline.host_batch`)
one unit at a time, as the JAX layouts do under GSPMD
(:class:`~repro_torch.models.layers.FSDP`): each layer, the embedding, the
head and a final norm are gathered over the FSDP axes where they run
(inside the layer's checkpoint, so the backward gathers them again), and
each unit's gradient is summed over the batch axes straight into an f32
accumulator of this rank's shards (ZeRO-2), the ranks' slices added in f32
in row-major order (:func:`~repro_torch.core.comm.reduce_scatter_in_order`,
bitwise :func:`~repro_torch.core.comm.sum_in_order` cut to the shard). No
rank holds more than one unit gathered, nor a full-size gradient. The clip
takes the whole tree's norm, each leaf's f32 shard gathered in turn
(``norm_gather``), and AdamW runs on the shards.

On a mesh whose ``tp_axis`` extent is above 1 every family splits its
compute over ``tp_axis`` as the JAX package's specs split it under GSPMD
(:func:`tp_split`, :class:`~repro_torch.models.layers.TPSplit`): a leaf is
gathered over its spec's entries except ``tp_axis`` (nothing with FSDP
off), so a rank holds a unit's model shard whole and never a replica, and
the loss runs under the split: Megatron products, head- or context-parallel
attention, the vocab-parallel embedding and cross entropy, experts
computed where they are stored, an SSM's own heads (mamba2's and zamba2's
``in_proj`` and conv, whose stored blocks do not line up with the heads,
are computed on the stored block and gathered). The clip's norm sums the
split leaves' squares over ``tp_axis`` and counts each replicated leaf
once. A row-split product sums partial products, so the step is within the
reference's tolerances of the one-device step, not bitwise; the replicated
leaves stay bitwise alike across the model ranks. With a model extent of 1
and one microbatch a rank the step is bitwise the one-device step with
``n_micro`` = the batch axes' extent.

``make_serve_artifacts`` gives the prefill and decode callables, with the
reference's layout choices, spec trees and meta shapes. **Serving on a
mesh** holds between calls each rank's shards alone: the parameters, its
slice of the batch (the batch axes: ``("pod", "data")`` or ``("data",)``,
none for ``long_500k``) and its shards of the serve state; the cache is
never gathered. Where the KV heads divide the model axis the caches' heads
split over it, else (and for ``long_500k``) their sequence; an SSM state's
heads split over it. A call gathers each unit where it runs, as a step
does, over its spec's entries except ``tp_axis`` (a tied embedding at both
its uses), and computes only the rank's share (the training step's
layers, under ``torch.no_grad()``), the rank's vocab
columns of the logits gathered once a call. Attention splits as the cache
does: with the heads split a rank attends with its own heads over its own
shard and the output product's partials are summed; with the sequence
split q, k and v are gathered along their columns, a prompt's queries are
split by position (computed whole where the prompt does not divide over
the axis; attended in place over the shard where the model writes its
cache in place), a decode step attends over the positions each rank holds
and the softmax partials are merged by log-sum-exp in rank order. An SSM
layer steps its own heads from its state shard. Every sum adds in f32 in
rank order, so what every model rank computes alike (norms, routing, the
merge, the conv state) is bitwise alike across them; the row-split
products reorder sums, so a call is within the reference's bars of the
one-device serving of the rank's batch slice, not bitwise.

With a model extent of 1 a call is the batch split alone. On a
:class:`~repro_torch.core.mesh.MeshLayout` (meta tensors) the same calls
are priced by the dry run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.common import Bundle, ShapeSpec
from repro_torch.core import comm
from repro_torch.models import layers
from repro_torch.models.jax_layout import P
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.hierarchical import Hierarchical, HierarchicalConfig
from repro_torch.optim.tree import map_named, named_leaves

__all__ = ["TrainArtifacts", "make_train_artifacts", "tp_split", "shard_state",
           "gather_state", "ServeArtifacts", "make_serve_artifacts"]


def kv_heads(bundle: Bundle) -> int | None:
    """The KV heads of ``bundle``'s architecture as the reference's serving
    and dry run find them: the backbone's for the VLM, ``n_heads`` for the
    audio family, None without attention."""
    cfg = bundle.cfg
    n_kv = getattr(cfg, "n_kv", None)
    if n_kv is None and hasattr(cfg, "backbone"):
        n_kv = cfg.backbone.n_kv
    if n_kv is None and bundle.family == "audio":
        n_kv = cfg.n_heads
    return n_kv


def tp_split(bundle: Bundle, mesh, tp_axis: str = "model", *,
             kv: str | None = None) -> layers.TPSplit | None:
    """The compute split of ``bundle`` over ``tp_axis`` of ``mesh``: None
    without a mesh or with an extent of 1. The attention split is the
    cache's ``kv`` where given (serving), else ``cfg.attn_sharding`` where
    set, else ``"heads"`` where the extent divides the KV heads (or there
    is no attention) and ``"seq"`` where it does not (the JAX dry run's
    rule, on the mesh's own extent). An extent that does not divide what a
    rank's share is cut from raises ``ValueError`` naming it (the sequence
    is checked at each call): the SSM heads, the B/C groups they read,
    ``in_proj``'s columns and the conv channels of mamba2 and zamba2's
    mamba layers; the heads (whisper's, which are all head-parallel but
    its cached self-attention), the KV heads under ``"heads"``, the query
    and KV columns, ``d_ff``, the experts, zamba2's shared ``in_proj``
    columns and the VLM's connector columns; and the vocab."""
    if mesh is None or mesh.shape.get(tp_axis, 1) == 1:
        return None
    cfg = getattr(bundle.cfg, "backbone", bundle.cfg)
    n = mesh.shape[tp_axis]
    n_kv = kv_heads(bundle)
    attn = (kv or getattr(cfg, "attn_sharding", None)
            or ("heads" if n_kv is None or n_kv % n == 0 else "seq"))
    split = layers.TPSplit(mesh, tp_axis, attn, kv)
    if bundle.family in ("ssm", "hybrid"):
        mamba = bundle.model if bundle.family == "ssm" else bundle.model.mamba
        m = mamba.cfg
        mamba.own_groups(split.local(m.n_heads, "SSM heads"), 0)
        split.local(2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads, "in_proj columns")
        split.local(m.conv_dim, "conv channels")
    if bundle.family == "audio":
        split.local(cfg.n_heads, "heads")
    if n_kv is not None:
        if attn == "heads":
            split.local(n_kv, "KV heads")
        split.local(cfg.n_heads * cfg.d_head, "query columns")
        split.local(n_kv * cfg.d_head, "KV columns")
    if bundle.family == "hybrid":
        split.local(cfg.d_model, "shared in_proj columns")
    moe = getattr(cfg, "moe", None)
    if hasattr(cfg, "d_ff") and (moe is None or cfg.group_size > 1):
        split.local(cfg.d_ff, "d_ff columns")
    if moe is not None:
        if moe.expert_sharding == "ep":
            split.local(moe.n_experts, "experts")
        if moe.expert_sharding != "ep" or moe.shared_expert:
            split.local(moe.d_ff, "expert d_ff columns")
    if bundle.family == "vlm":
        split.local(cfg.d_model, "connector fc2 columns")
    split.local(cfg.vocab, "vocab rows")
    return split


def _entry_axes(e) -> tuple:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _without(spec: tuple, axis: str) -> tuple:
    """``spec`` with ``axis``'s entries unsplit: what a rank gathers over."""
    out = []
    for e in spec:
        names = _entry_axes(e)
        if axis in names and len(names) > 1:
            raise ValueError(f"spec entry {e} splits one dimension over {axis} and other axes")
        out.append(None if axis in names else e)
    return tuple(out)


def _only(spec: tuple, axis: str) -> tuple:
    """``spec`` with its ``axis`` entries alone: what stays split while a
    rank computes."""
    return tuple(e if axis in _entry_axes(e) else None for e in spec)


def _split_specs(named: dict, axis: str, split) -> tuple[dict, dict]:
    """``(what a rank gathers each leaf over, what stays split over
    ``axis`` as it computes)`` from the specs by leaf name: every entry
    but ``axis``'s and ``axis``'s alone under a compute split, else every
    entry and nothing."""
    if split is None:
        return named, {}
    return ({n: _without(s, axis) for n, s in named.items()},
            {n: _only(s, axis) for n, s in named.items()})


def _norm(names: list, sq: list, model_only: dict, mesh, axis: str) -> torch.Tensor:
    """The whole tree's gradient norm from each leaf's sum of squares
    ``sq`` (``global_norm``'s), of this rank's model shards under a split
    (``model_only`` not empty): the split leaves' sums summed over
    ``axis`` (in rank order, one collective), each replicated leaf counted
    once."""
    split_ix = [i for i, n in enumerate(names)
                if any(e is not None for e in model_only.get(n, ()))]
    if split_ix:
        summed = comm.sum_in_order(torch.stack([sq[i] for i in split_ix]), mesh, axis)
        for j, i in enumerate(split_ix):
            sq[i] = summed[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_state(tree: Any, specs: Any, mesh) -> Any:
    """A whole JAX-layout tree (nested dicts of numpy arrays or tensors)
    cut to this rank's shards by ``specs`` (the same tree of spec tuples):
    contiguous copies, numpy or torch as given. The identity without a
    mesh. A dimension its axes' extent does not divide raises
    ``ValueError``."""
    if mesh is None:
        return tree
    paths = iter(_paths(tree))

    def cut(x, spec):
        x = mesh.shard(x, spec, next(paths))
        return np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x.contiguous()
    return _tree_map(cut, tree, specs)


def gather_state(shards: Any, specs: Any, mesh) -> Any:
    """The inverse of :func:`shard_state`, collective over the mesh: every
    rank gets the whole tree (numpy leaves come back as numpy)."""
    if mesh is None:
        return shards

    def whole(x, spec):
        if isinstance(x, np.ndarray):
            return comm.gather_blocks(torch.from_numpy(x), mesh, spec).numpy()
        return comm.gather_blocks(x, mesh, spec)
    return _tree_map(whole, shards, specs)


def _paths(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


@dataclasses.dataclass
class TrainArtifacts:
    step_fn: Callable           # (params, opt_state, batch) -> (p', s', metrics)
    sync_fn: Callable | None    # hierarchical only: (params, sync_state) -> ...
    params_sds: Any             # meta tensors: the whole params (pod axis if hierarchical)
    opt_sds: Any
    batch_specs: Any            # spec trees in the JAX layout
    params_specs: Any
    opt_specs: Any
    sync_sds: Any = None
    sync_specs: Any = None
    hier: Hierarchical | None = None
    mesh: Any = None
    named_specs: dict = dataclasses.field(default_factory=dict)  # part -> {leaf name: spec}
    split: Any = None             # layers.TPSplit of the step, or None
    model_specs: dict = dataclasses.field(default_factory=dict)  # leaf name -> tp entries
    batch_axes: tuple = ("data",)  # on a mesh: the axes a step's gradients are summed over
    n_micro: int = 1

    def computed_bytes(self, params: Any) -> int:
        """Bytes of ``params`` (a whole parameter module, one pod's) as a
        step computes on them on this rank, one unit at a time: the model
        shards under a split, else the whole."""
        return _computed_bytes(params, self.model_specs, self.mesh)

    def accumulator_bytes(self, params: Any) -> int:
        """Bytes of the gradient accumulator a step on ``params`` holds (on
        a mesh this rank's shards, as the step holds it: ZeRO-2): f32 where
        it sums microbatches or batch ranks, else the gradients' own
        dtype."""
        d = 1 if self.mesh is None else self.mesh.extent(self.batch_axes)
        return sum(x.numel() * (4 if self.n_micro * d > 1 else x.element_size())
                   for x in named_leaves(params).values())

    def batch_sds(self, bundle: Bundle, shape: ShapeSpec, mesh=None) -> dict:
        """Meta tensors of a global batch of ``shape``, with the pod axis
        in hierarchical mode (``mesh`` for the JAX signature: the specs
        are :attr:`batch_specs`)."""
        del mesh
        specs = bundle.input_specs(shape)
        if self.hier is not None:
            n = self.hier.n_pods
            specs = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in specs.items()}
        return specs

    def shard(self, tree: Any, part: str) -> Any:
        """This rank's shards of a whole training-state tree in the port's
        layout: ``part`` ``"params"`` (a parameter module, trainable
        shards), ``"opt"`` (AdamW's state) or ``"sync"`` (the sync
        state). The identity without a mesh."""
        if self.mesh is None:
            return tree
        specs = self.named_specs[part]
        return map_named(lambda n, x: self.mesh.shard(x.detach(), specs[n], n).clone(), tree)

    def gather(self, shards: Any, part: str, axes: tuple[str, ...] | None = None) -> Any:
        """The inverse of :meth:`shard`, collective over the mesh: over
        ``axes`` only when given (every axis but the pod's gives a
        hierarchical rank its own pod's replica, a leading extent of 1)."""
        if self.mesh is None:
            return shards
        specs = self.named_specs[part]
        if axes is not None:
            specs = {n: _over(spec, axes) for n, spec in specs.items()}
        return map_named(lambda n, x: comm.gather_blocks(x.detach(), self.mesh, specs[n]), shards)


def _computed_bytes(params: Any, model_specs: dict, mesh) -> int:
    """Bytes of the whole parameter module ``params`` as a rank computes
    on them: each leaf cut by its entries over the model axis
    (``model_specs``; the whole leaf without)."""
    total = 0
    for n, x in named_leaves(params).items():
        numel = x.numel()
        for e in model_specs.get(n, ()):
            if e is not None:
                numel //= mesh.extent(e)
        total += numel * x.element_size()
    return total


def _over(spec: tuple, axes) -> tuple:
    """``spec`` with the entries outside ``axes`` left unsplit (None)."""
    out = []
    for e in spec:
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        inside = {a in axes for a in names}
        if len(inside) > 1:
            raise ValueError(f"spec entry {e} lies partly outside the axes {axes}")
        out.append(e if inside == {True} else None)
    return tuple(out)


def make_train_artifacts(
    bundle: Bundle,
    opt_cfg: AdamWConfig | None = None,
    mesh=None,
    *,
    batch_axes: tuple[str, ...] = ("data",),
    fsdp_axis: str | None = "data",
    tp_axis: str = "model",
    hier_cfg: HierarchicalConfig | None = None,
    n_pods: int = 2,
    n_micro: int = 1,
) -> TrainArtifacts:
    """``n_micro`` > 1 enables gradient accumulation over microbatches: the
    step splits the (per-pod, per-rank) batch into ``n_micro`` equal parts
    along the batch axis, one backward each, accumulating f32 gradients
    (the loss is their mean). ``n_pods`` replicas for ``hier_cfg`` without
    a mesh; on one the pod axis's extent. On a mesh ``batch_axes`` are the
    axes a batch is split over (the pod's own in hierarchical mode, which
    must not name the pod axis).

    On a mesh whose ``tp_axis`` extent is above 1 every family computes
    only this rank's share over it (:func:`tp_split`, held in
    :attr:`TrainArtifacts.split`; the module's docstring); an extent that
    does not divide what a share is cut from raises."""
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=bundle.moment_dtype)
    model = bundle.model
    p_specs = model.param_pspecs(fsdp=fsdp_axis, tp=tp_axis)
    probe = bundle.input_specs(ShapeSpec("probe", "train", 8, 8))
    split = tp_split(bundle, mesh, tp_axis)
    loss_fn = bundle.loss if split is None else functools.partial(bundle.loss, split=split)

    def trainable(params) -> dict:
        named = named_leaves(params)
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"training needs trainable parameters (params.requires_grad_()); "
                             f"{len(frozen)} are frozen, e.g. {frozen[0]}")
        return named

    def microbatches(batch):
        if n_micro == 1:
            return [batch]
        return [{k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()} for i in range(n_micro)]

    def grads_of(params, batch):
        named = trainable(params)
        leaves = list(named.values())
        if n_micro == 1:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(named, grads))
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for mb in microbatches(batch):
            loss = loss_fn(params, mb)
            g = torch.autograd.grad(loss, leaves)
            torch._foreach_add_(g_sum, [x.float() for x in g])
            del g
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / n_micro
        torch._foreach_mul_(g_sum, inv)
        return loss_sum * inv, dict(zip(named, g_sum))

    def base_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    named_p = model.named_pspecs(p_specs) if mesh is not None else {}
    gather_p, model_only = _split_specs(named_p, tp_axis, split)

    def mesh_step(params, opt_state, batch):
        """``base_step`` on this rank's shards and batch slice, one unit at
        a time (:class:`~repro_torch.models.layers.FSDP`): each
        microbatch's forward gathers a unit where it runs, and its backward
        adds each unit's gradient, summed over the batch axes, into the
        f32 accumulator of this rank's shards (ZeRO-2), which AdamW then
        reads."""
        trainable(params)
        d = mesh.extent(batch_axes)
        fsdp = layers.FSDP(mesh, gather_p, params, batch_axes, micro=n_micro)
        losses = []
        for mb in microbatches(batch):
            with fsdp.recording():
                loss = loss_fn(params, mb, fsdp=fsdp)
            loss.backward()
            fsdp.flush()
            losses.append(loss.detach())
        loss = losses[0]
        if n_micro > 1:  # summed as grads_of sums it
            loss = torch.zeros((), dtype=torch.float32, device=loss.device)
            for x in losses:
                loss = loss + x
            loss = loss * (1.0 / n_micro)
        if d > 1:  # the batch's other slices, added in the one-device trainer's order
            loss = comm.sum_in_order(loss, mesh, batch_axes) * (1.0 / d)
        grads = fsdp.finish()
        if n_micro * d > 1:
            torch._foreach_mul_(list(grads.values()), 1.0 / (n_micro * d))
        gnorm = _norm(list(grads), fsdp.grad_squares(), model_only, mesh, tp_axis)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg,
                                                  grad_norm=gnorm)
        return params, opt_state, {"loss": loss, **metrics}

    step = base_step if mesh is None else mesh_step
    params_sds = model.init_params(None, device="meta")
    opt_sds = adamw_init(params_sds, opt_cfg)
    o_specs = {"m": p_specs, "v": p_specs, "count": P()}
    if hier_cfg is None:
        b_specs = {k: P(batch_axes, *([None] * (v.dim() - 1))) for k, v in probe.items()}
        return TrainArtifacts(
            step_fn=step, sync_fn=None, params_sds=params_sds, opt_sds=opt_sds,
            batch_specs=b_specs, params_specs=p_specs, opt_specs=o_specs, mesh=mesh,
            named_specs=_named_specs(named_p, P()), split=split, model_specs=model_only,
            batch_axes=batch_axes, n_micro=n_micro)

    pod = hier_cfg.pod_axis
    if mesh is not None:
        n_pods = mesh.shape[pod]
        if pod in batch_axes:
            raise ValueError(f"hierarchical batch axes {batch_axes} name the pod axis {pod!r}: "
                             f"a local step sums gradients within its pod")
    hier = Hierarchical(hier_cfg, n_pods, mesh, param_specs=p_specs)
    pp_specs = hier.pspecs(p_specs)
    sync_specs = {"anchor": p_specs}
    if hier_cfg.compression != "none":
        sync_specs["ef"] = pp_specs
    named = {}
    if mesh is not None:
        named_pp = model.named_pspecs(pp_specs, lead=1)
        named = _named_specs(named_pp, P(pod))
        named["sync"] = {f"anchor.{n}": s for n, s in named_p.items()}
        if hier_cfg.compression != "none":
            named["sync"].update({f"ef.{n}": s for n, s in named_pp.items()})
    return TrainArtifacts(
        step_fn=hier.local_step(step), sync_fn=hier.sync_step,
        params_sds=hier.replicate(params_sds), opt_sds=hier.replicate(opt_sds),
        batch_specs={k: P(pod, batch_axes, *([None] * (v.dim() - 1)))
                     for k, v in probe.items()},
        params_specs=pp_specs, opt_specs={"m": pp_specs, "v": pp_specs, "count": P(pod)},
        sync_sds=hier.init_sync_state(params_sds), sync_specs=sync_specs, hier=hier,
        mesh=mesh, named_specs=named, split=split, model_specs=model_only,
        batch_axes=batch_axes, n_micro=n_micro)


def _named_specs(params: dict, count: tuple) -> dict:
    """The port-layout specs of the parameters and AdamW's state, by leaf
    name (:func:`~repro_torch.optim.tree.named_leaves`)."""
    if not params:
        return {}
    opt = {f"{part}.{n}": s for part in ("m", "v") for n, s in params.items()}
    return {"params": dict(params), "opt": {**opt, "count": count}}


# ---------------------------------------------------------------------------
# serving


@dataclasses.dataclass
class ServeArtifacts:
    prefill_fn: Callable   # (params, batch) -> (logits [B, 1, V], serve_state)
    decode_fn: Callable    # (params, serve_state, tokens [B, 1], idx) -> (logits, state)
    params_sds: Any = None        # meta tensors: the whole parameters
    params_specs: Any = None      # spec trees in the JAX layout
    state_sds: Any = None         # meta tensors: the whole serve state
    state_specs: Any = None
    batch_axes: tuple[str, ...] | None = None
    token_spec: tuple = ()
    mesh: Any = None
    named_specs: dict = dataclasses.field(default_factory=dict)  # leaf name -> spec
    split: Any = None             # layers.TPSplit on a mesh whose tp_axis extent is above 1
    model_specs: dict = dataclasses.field(default_factory=dict)  # leaf name -> tp entries

    def computed_bytes(self, params: Any) -> int:
        """Bytes of ``params`` (a whole parameter module) as a call
        computes on them on this rank, one unit at a time: the model shards
        under a compute split, else the whole."""
        return _computed_bytes(params, self.model_specs, self.mesh)

    def shard(self, params: Any) -> Any:
        """This rank's shards of a whole parameter module (frozen, as
        served). The identity without a mesh."""
        if self.mesh is None:
            return params
        return map_named(lambda n, x: self.mesh.shard(x.detach(), self.named_specs[n], n).clone(),
                         params, requires_grad=False)

    def gather_state(self, state: dict, axes: tuple[str, ...] | None = None) -> dict:
        """The whole serve state from the ranks' shards (over ``axes`` only
        when given), collective over the mesh; for checks, never within a
        call."""
        specs = self.state_specs
        if axes is not None:
            specs = _tree_map(lambda spec, _: _over(spec, axes), specs, specs)
        return gather_state(state, specs, self.mesh)


def make_serve_artifacts(bundle: Bundle, shape: ShapeSpec, mesh=None, *,
                         fsdp_axis: str | None = "data", tp_axis: str = "model",
                         cache_dtype=torch.bfloat16) -> ServeArtifacts:
    """Prefill / decode callables for ``shape`` (batch ``global_batch``, a
    cache of ``seq_len`` positions of ``cache_dtype``, on the parameters'
    device). Prefill fills the cache from an empty one and returns the last
    position's logits; decode appends one token per call. Both update the
    serve state's cache in place. The audio family encodes ``frames`` once at
    prefill and keeps the encoder output in the serve state for every
    decode; the VLM family takes ``patch_embeds`` at prefill only.

    The layout is the reference's: the ``long_500k`` cell (batch 1) has no
    batch axes and its caches' sequence over ``tp_axis``; every other cell
    has the batch over ``("pod", "data")`` (``("data",)`` without a pod
    axis), then the KV heads over ``tp_axis`` where they divide it, else the
    sequence. ``state_specs`` holds the caches' ``cache_pspecs`` under that
    choice (and whisper's ``enc_out``), ``params_specs`` ``param_pspecs``.

    **On a mesh** (a :class:`~repro_torch.core.mesh.ProcessMesh`, or a
    :class:`~repro_torch.core.mesh.MeshLayout` on meta tensors to price a
    call) a rank holds between calls its shards alone: the parameters
    (:meth:`ServeArtifacts.shard`), its batch and tokens
    (``host_batch(batch, mesh, art.batch_axes)``), and the serve state
    prefill makes, the caches and ``enc_out`` cut by ``state_specs``. The
    caches are never gathered: each attention layer and SSM layer works
    where its shard lies. A call gathers each unit over every axis but
    ``tp_axis`` where it runs (:class:`~repro_torch.models.layers.FSDP`)
    and computes only the rank's share (:func:`tp_split`
    with the cache's split, held in :attr:`ServeArtifacts.split`). The
    module's docstring says what it computes and how close it comes to one
    device."""
    model = bundle.model
    cfg = bundle.cfg
    b, s = shape.global_batch, shape.seq_len
    is_audio = bundle.family == "audio"
    is_vlm = bundle.family == "vlm"

    n_kv = kv_heads(bundle)
    tp_size = mesh.shape[tp_axis] if mesh is not None else 1
    head_axis = seq_axis = None
    if shape.name == "long_500k":
        batch_axes, seq_axis = None, tp_axis
    else:
        batch_axes = None
        if mesh is not None:
            batch_axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
        if n_kv is not None and tp_size > 1:
            if n_kv % tp_size == 0:
                head_axis = tp_axis
            else:
                seq_axis = tp_axis
    cache_specs = model.cache_pspecs(batch_axes=batch_axes, seq_axis=seq_axis,
                                     head_axis=head_axis)
    state_specs: dict = {"cache": cache_specs}
    state_sds: dict = {"cache": model.init_cache(b, s, cache_dtype, device="meta")}
    if is_audio:
        state_specs["enc_out"] = P(batch_axes, None, None)
        state_sds["enc_out"] = torch.empty((b, cfg.n_frames, cfg.d_model), dtype=cfg.cdtype,
                                           device="meta")
    p_specs = model.param_pspecs(fsdp=fsdp_axis, tp=tp_axis)

    split = named = None
    gather_p, model_only = {}, {}
    if mesh is not None:
        named = model.named_pspecs(p_specs)
        kv = None  # how the KV caches split over tp_axis (none without attention)
        if tp_size > 1 and n_kv is not None:
            kv = "heads" if head_axis is not None else "seq"
        split = tp_split(bundle, mesh, tp_axis, kv=kv)
        gather_p, model_only = _split_specs(named, tp_axis, split)
        local_cache = shard_state(state_sds["cache"], cache_specs, mesh)  # meta: shapes only

    def gather_point(params, kwargs: dict):
        """On a mesh, ``kwargs["fsdp"]``: this call's gather point."""
        if mesh is not None:
            kwargs["fsdp"] = layers.FSDP(mesh, gather_p, params)
        return kwargs.get("fsdp")

    @torch.no_grad()
    def prefill(params, batch):
        device = next(params.parameters()).device
        if mesh is None:
            cache = model.init_cache(b, s, cache_dtype, device=device)
        else:  # this rank's shards, made where they stay
            cache = _tree_map(lambda x, _: torch.zeros(x.shape, dtype=x.dtype, device=device),
                              local_cache, cache_specs)
        kwargs, state = {}, {}
        fsdp = gather_point(params, kwargs)
        if is_audio:
            state["enc_out"] = kwargs["enc_out"] = model.encode(params, batch["frames"], split,
                                                                fsdp)
        if is_vlm:
            kwargs["patch_embeds"] = batch["patch_embeds"]
        if split is not None:
            kwargs["split"] = split
        logits, cache = model.forward_with_cache(params, batch["tokens"], cache, 0,
                                                 last_only=True, **kwargs)
        return logits, {"cache": cache, **state}

    @torch.no_grad()
    def decode(params, serve_state, tokens, cache_index):
        kwargs = {"enc_out": serve_state["enc_out"]} if is_audio else {}
        gather_point(params, kwargs)
        if split is not None:
            kwargs["split"] = split
        logits, cache = model.forward_with_cache(params, tokens, serve_state["cache"],
                                                 cache_index, **kwargs)
        return logits, {**serve_state, "cache": cache}

    return ServeArtifacts(
        prefill_fn=prefill, decode_fn=decode,
        params_sds=model.init_params(None, device="meta"), params_specs=p_specs,
        state_sds=state_sds, state_specs=state_specs, batch_axes=batch_axes,
        token_spec=P(batch_axes, None), mesh=mesh, named_specs=named or {}, split=split,
        model_specs=model_only)
