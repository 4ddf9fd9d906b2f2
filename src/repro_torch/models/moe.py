"""Mixture-of-Experts layer: the port of ``repro.models.moe``.

A top-k router (f32) with GShard/Switch-style capacity dispatch, per
sequence: each token picks its top-k experts, and an expert takes at most
``cap = ceil(S * k * capacity_factor / E)`` of a sequence's (token, choice)
entries, token-major then choice-minor; the rest are dropped (their residual
passes through). Tokens are gathered into per-expert buffers
``[B, E, cap, D]``, so the expert products cost the active FLOPs only; they
are batched products over the experts (``torch.einsum``), as the reference
computes them outside any Pallas kernel. ``moe_pspecs`` is the JAX spec
tree as tuples: ``"ep"`` shards the experts over the model axis, ``"tp"``
their hidden width.

**Under a compute split** (:class:`~repro_torch.models.layers.TPSplit`;
training, and serving on a mesh) the experts are computed where they are
stored. The router is replicated,
so routing, the capacity dispatch's slots and the aux loss run whole on
every rank (the aux loss is not summed). With ``"ep"`` a rank fills, runs
and combines the buffers of its own ``E / n`` experts alone; with ``"tp"``
every expert runs on the rank's ``d_ff / n`` columns of ``gate_w`` /
``up_w`` and rows of ``down_w``. Either way the combine is linear in the
buffers, so the ranks' combined outputs are summed once over the axis
(``"partial_sum"``). No token crosses the axis: there is no all-to-all.
With ``"ep"`` and ``top_k`` <= 2 the routed output is bitwise the one-device
layer's: a token's at most two terms lie on one rank or on two, the other
ranks add exact zeros, and two terms added in f32 and rounded once give
what the one-device sum over ``k`` gives (an f32 accumulation); the
expert products themselves are the same per-expert products. A shared
expert is split as :func:`~repro_torch.models.layers.swiglu` is (a
row-split sum), which is not bitwise.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.jax_layout import P

__all__ = ["MoEConfig", "MoEParams", "moe_init", "route", "dispatch_slots", "dispatch",
           "expert_ffn", "combine", "moe_apply", "moe_pspecs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The JAX package's MoE config, field for field."""

    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden width
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on expert
    interleave: int = 1          # every `interleave`-th layer is MoE
    expert_sharding: str = "ep"  # 'ep' | 'tp'


class MoEParams(nn.Module):
    """``router`` (f32 ``Dense`` ``[D, E]``), the experts' ``gate_w`` /
    ``up_w`` ``[E, D, ff]`` and ``down_w`` ``[E, ff, D]``, and the optional
    SwiGLU ``shared`` expert: the JAX dict's names."""

    def __init__(self, router: layers.Dense, gate_w: torch.Tensor, up_w: torch.Tensor,
                 down_w: torch.Tensor, shared: nn.ModuleDict | None):
        super().__init__()
        self.router = router
        self.gate_w = layers._param(gate_w)
        self.up_w = layers._param(up_w)
        self.down_w = layers._param(down_w)
        self.shared = shared


def _experts(e: int, d_in: int, d_out: int, scale: float, *, generator, dtype,
             device) -> torch.Tensor:
    """``[E, d_in, d_out]`` weights ``normal(0, 1) * scale``, drawn expert by
    expert in f32 and cast, so the peak stays near the stack's own bytes
    (llama4's ``gate_w`` is 5.4 G elements)."""
    w = torch.empty(e, d_in, d_out, dtype=dtype, device=device)
    if device is not None and torch.device(device).type == "meta":
        return w
    for i in range(e):
        w[i] = torch.randn(d_in, d_out, generator=generator, device=device) * scale
    return w


def moe_init(d_model: int, cfg: MoEConfig, *, generator: torch.Generator | None,
             dtype=torch.float32, device=None) -> MoEParams:
    """The JAX initialisation's distributions: router N(0, 1/D) in f32,
    gate/up N(0, 1/D), down N(0, 1/ff), in ``dtype``."""
    dev = generator.device if generator is not None else device
    e, ff = cfg.n_experts, cfg.d_ff
    kw = dict(generator=generator, dtype=dtype, device=dev)
    router = layers.dense_init(d_model, e, generator=generator, device=dev)
    gate_w = _experts(e, d_model, ff, 1 / math.sqrt(d_model), **kw)
    up_w = _experts(e, d_model, ff, 1 / math.sqrt(d_model), **kw)
    down_w = _experts(e, ff, d_model, 1 / math.sqrt(ff), **kw)
    shared = (layers.swiglu_init(d_model, ff, generator=generator, dtype=dtype, device=dev)
              if cfg.shared_expert else None)
    return MoEParams(router, gate_w, up_w, down_w, shared)


def route(p: MoEParams, x: torch.Tensor, cfg: MoEConfig):
    """The router in f32: ``(gates [B, S, E], gate_vals [B, S, k],
    expert_idx [B, S, k])``. Top-k is a stable descending sort, so equal
    gates give the lower expert first, as ``jax.lax.top_k`` does (a uniform
    router ties every gate); the selected gates are renormalised."""
    gates = torch.softmax(layers.dense(p.router, x.float()), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return gates, vals, idx


def dispatch_slots(expert_idx: torch.Tensor, cap: int, n_experts: int):
    """Capacity dispatch of ``expert_idx [B, S, k]``, per sequence:
    ``(flat_e [B, S*k], slot [B, S*k], keep [B, S*k])``. An entry's slot is
    the number of earlier entries (token-major, choice-minor) routed to its
    expert; entries at or past ``cap`` are dropped to the overflow slot
    ``cap``."""
    bsz = expert_idx.shape[0]
    flat_e = expert_idx.reshape(bsz, -1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)       # [B, S*k, E]
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    keep = pos < cap
    return flat_e, torch.where(keep, pos, cap), keep


def dispatch(x: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor, cap: int,
             n_experts: int, k: int) -> torch.Tensor:
    """Each sequence's (token, choice) entries into the per-expert buffers
    ``[B, E, cap, D]``. Every dropped entry lands in the overflow slot,
    which is cut off; the kept (expert, slot) pairs are unique."""
    bsz, _, d = x.shape
    rows = torch.arange(bsz, device=x.device)[:, None].expand_as(flat_e)
    xe = x.new_zeros(bsz, n_experts, cap + 1, d)
    xe.index_put_((rows, flat_e, slot), x.repeat_interleave(k, dim=1))
    return xe[:, :, :cap]


def expert_ffn(p: MoEParams, xe: torch.Tensor) -> torch.Tensor:
    """The gated experts on their buffers, batched over the experts:
    ``[B, E, cap, D]`` -> ``[B, E, cap, D]`` in the buffers' dtype."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, p.gate_w.to(xe.dtype)))
    h = h * torch.einsum("becd,edf->becf", xe, p.up_w.to(xe.dtype))
    return torch.einsum("becf,efd->becd", h, p.down_w.to(xe.dtype))


def combine(ye: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor,
            gate_vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's kept entries gathered back from the buffers and weighted
    by their gates (a dropped entry reads the zero overflow slot, weight 0):
    ``[B, S, D]``."""
    bsz, e, _, d = ye.shape
    s, k = gate_vals.shape[1], gate_vals.shape[2]
    rows = torch.arange(bsz, device=ye.device)[:, None].expand_as(flat_e)
    ye = torch.cat([ye, ye.new_zeros(bsz, e, 1, d)], dim=2)
    gathered = ye[rows, flat_e, slot]                            # [B, S*k, D]
    weights = (gate_vals.reshape(bsz, s * k) * keep).to(ye.dtype)
    return (gathered * weights[..., None]).reshape(bsz, s, k, d).sum(dim=2)


def moe_apply(p: MoEParams, x: torch.Tensor, cfg: MoEConfig,
              split: layers.TPSplit | None = None):
    """Returns (output ``[B, S, D]``, the load-balance aux loss
    ``E * sum_e f_e P_e`` over all tokens, f32). Under ``split`` the
    experts' weights are this rank's shards (the module's docstring)."""
    s = x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, -(-s * k * cfg.capacity_factor // e)))   # ceil, per sequence

    gates, gate_vals, expert_idx = route(p, x, cfg)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    flat_e, slot, keep = dispatch_slots(expert_idx, cap, e)
    if split is None:
        ye = expert_ffn(p, dispatch(x, flat_e, slot, cap, e, k))
        combined = combine(ye, flat_e, slot, gate_vals, keep)
    else:
        combined = _split_experts(p, x, gate_vals, flat_e, slot, keep, cap, cfg, split)
    if cfg.shared_expert:
        combined = combined + layers.swiglu(p.shared, x, split)
    return combined, aux.float()


def _split_experts(p: MoEParams, x, gate_vals, flat_e, slot, keep, cap: int, cfg: MoEConfig,
                   split: layers.TPSplit) -> torch.Tensor:
    """The routed experts' combined output under ``split``: this rank's
    share (its experts, or every expert's slice of ``d_ff``), summed over
    the axis."""
    e, k = cfg.n_experts, cfg.top_k
    xs, gv = split.enter(x), split.enter(gate_vals)
    if cfg.expert_sharding == "ep":
        e_loc = split.local(e, "experts")
        e0 = split.index[0] * e_loc
        own = (flat_e >= e0) & (flat_e < e0 + e_loc)
        flat_e = torch.where(own, flat_e - e0, 0)
        slot = torch.where(own, slot, cap)   # another rank's entry: the overflow slot
        keep, e = keep & own, e_loc
    else:
        split.local(cfg.d_ff, "expert d_ff columns")
    ye = expert_ffn(p, dispatch(xs, flat_e, slot, cap, e, k))
    return split.sum(combine(ye, flat_e, slot, gv, keep))


def moe_pspecs(cfg: MoEConfig, fsdp: str | None, tp: str) -> dict:
    """The JAX spec tree of :func:`moe_init`'s parameters (no stack axis),
    each spec a tuple."""
    if cfg.expert_sharding == "ep":
        expert_in = P(tp, fsdp, None)     # [E, D, ff]: experts over the model axis
        expert_out = P(tp, None, fsdp)    # [E, ff, D]
    else:  # 'tp': d_ff inside every expert
        expert_in = P(None, fsdp, tp)
        expert_out = P(None, tp, fsdp)
    p = {
        "router": {"w": P(fsdp, None)},
        "gate_w": expert_in,
        "up_w": expert_in,
        "down_w": expert_out,
    }
    if cfg.shared_expert:
        p["shared"] = {
            "gate": {"w": P(fsdp, tp)},
            "up": {"w": P(fsdp, tp)},
            "down": {"w": P(tp, fsdp)},
        }
    return p
