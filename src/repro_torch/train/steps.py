"""Train and serve step builders: the glue between bundles, optimizer and
device. The port of ``repro.train.steps`` for one device.

``make_train_artifacts`` gives the step callable(s) and the shapes of the
parameters, optimizer and sync state as meta tensors (the JAX package's
``ShapeDtypeStruct`` trees). Two training modes:

* ``sync`` (baseline): one parameter replica, one AdamW step on the batch's
  gradients;
* ``hierarchical`` (the paper's technique): per-pod replicas, local steps
  pod by pod and a separate every-D-steps ``sync_fn``.

Gradients come from ``torch.autograd`` on parameters that require grad
(``params.requires_grad_()``); with ``n_micro`` > 1 they accumulate in f32
over microbatches. A step updates its parameters and optimizer state in
place (the JAX step donates them) and returns them. The sharding specs of
the JAX artifacts wait for the port's sharded paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.common import Bundle, ShapeSpec
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.hierarchical import Hierarchical, HierarchicalConfig
from repro_torch.optim.tree import named_leaves

__all__ = ["TrainArtifacts", "make_train_artifacts", "ServeArtifacts",
           "make_serve_artifacts"]


@dataclasses.dataclass
class TrainArtifacts:
    step_fn: Callable           # (params, opt_state, batch) -> (p', s', metrics)
    sync_fn: Callable | None    # hierarchical only: (params, sync_state) -> ...
    params_sds: Any             # meta tensors: TransformerParams (pod axis if hierarchical)
    opt_sds: Any
    sync_sds: Any = None
    hier: Hierarchical | None = None


def make_train_artifacts(
    bundle: Bundle,
    opt_cfg: AdamWConfig | None = None,
    *,
    hier_cfg: HierarchicalConfig | None = None,
    n_pods: int = 2,
    n_micro: int = 1,
) -> TrainArtifacts:
    """``n_micro`` > 1 enables gradient accumulation over microbatches: the
    step splits the (per-pod) batch into ``n_micro`` equal parts along the
    batch axis, one backward each, accumulating f32 gradients (the loss is
    their mean). ``n_pods`` replicas for ``hier_cfg`` (the JAX package takes
    the mesh's pod extent, 2 without a mesh)."""
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=bundle.moment_dtype)
    model = bundle.model

    def grads_of(params, batch):
        named = named_leaves(params)
        leaves = list(named.values())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"training needs trainable parameters (params.requires_grad_()); "
                             f"{len(frozen)} are frozen, e.g. {frozen[0]}")
        if n_micro == 1:
            loss = bundle.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(named, grads))
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss = bundle.loss(params, mb)
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

    params_sds = model.init_params(None, device="meta")
    opt_sds = adamw_init(params_sds, opt_cfg)
    if hier_cfg is None:
        return TrainArtifacts(step_fn=base_step, sync_fn=None, params_sds=params_sds,
                              opt_sds=opt_sds)

    hier = Hierarchical(hier_cfg, n_pods)
    return TrainArtifacts(
        step_fn=hier.local_step(base_step), sync_fn=hier.sync_step,
        params_sds=hier.replicate(params_sds), opt_sds=hier.replicate(opt_sds),
        sync_sds=hier.init_sync_state(params_sds), hier=hier)


# ---------------------------------------------------------------------------
# serving


@dataclasses.dataclass
class ServeArtifacts:
    prefill_fn: Callable   # (params, batch) -> (logits [B, 1, V], serve_state)
    decode_fn: Callable    # (params, serve_state, tokens [B, 1], idx) -> (logits, state)


def make_serve_artifacts(bundle: Bundle, shape: ShapeSpec, *,
                         cache_dtype=torch.bfloat16) -> ServeArtifacts:
    """Prefill / decode callables for ``shape`` (batch ``global_batch``, a
    cache of ``seq_len`` positions of ``cache_dtype``, on the parameters'
    device). Prefill fills the cache from an empty one and returns the last
    position's logits; decode appends one token per call. Both update the
    serve state's cache in place. The audio family encodes ``frames`` once at
    prefill and keeps the encoder output in the serve state for every
    decode; the VLM family takes ``patch_embeds`` at prefill only."""
    model = bundle.model
    b, s = shape.global_batch, shape.seq_len
    is_audio = bundle.family == "audio"
    is_vlm = bundle.family == "vlm"

    def prefill(params, batch):
        device = next(params.parameters()).device
        cache = model.init_cache(b, s, cache_dtype, device=device)
        kwargs, state = {}, {}
        if is_audio:
            state["enc_out"] = kwargs["enc_out"] = model.encode(params, batch["frames"])
        if is_vlm:
            kwargs["patch_embeds"] = batch["patch_embeds"]
        logits, cache = model.forward_with_cache(params, batch["tokens"], cache, 0,
                                                 last_only=True, **kwargs)
        return logits, {"cache": cache, **state}

    def decode(params, serve_state, tokens, cache_index):
        kwargs = {"enc_out": serve_state["enc_out"]} if is_audio else {}
        logits, cache = model.forward_with_cache(params, tokens, serve_state["cache"],
                                                 cache_index, **kwargs)
        return logits, {**serve_state, "cache": cache}

    return ServeArtifacts(prefill_fn=prefill, decode_fn=decode)
