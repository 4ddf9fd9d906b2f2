"""AdamW from scratch over named tensors, with a configurable moment dtype.

The port of ``repro.optim.adamw``, op for op: the clip scale
``min(1, clip / max(gnorm, 1e-9))``, bias corrections ``1 - b^count`` in
f32, f32 moments stored in ``moment_dtype``, decoupled weight decay on the
f32 parameter, the result cast back to the parameter's dtype. ``count``,
``lr`` and the bias corrections stay device tensors, so a step needs no host
synchronisation. The elementwise update runs as ``torch._foreach_*`` ops
over pieces of the leaves of about 2^26 elements (``_pieces``), so its f32
temporaries stay near 1 GiB for any model: every element's ops are the same
whatever the piece it falls in.

Where the JAX update returns new trees, this one updates the parameters and
the state in place (the JAX step donates its inputs) and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.tree import named_leaves

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        # ``step / warmup_steps`` as the jitted JAX step computes it: XLA
        # turns a division by a constant into a product with its reciprocal.
        warm = torch.clamp(step.float() * (1.0 / max(self.warmup_steps, 1)), max=1.0)
        return self.lr * warm


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """``{"m", "v"}``: zeros in ``moment_dtype`` keyed by the leaves' names,
    on their devices; ``count``: an int32 zero on the first leaf's device."""
    md = getattr(torch, cfg.moment_dtype)
    named = named_leaves(params)
    dev = next(iter(named.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=md, device=p.device)  # noqa: E731
                     for n, p in named.items()}
    return {"m": zeros(), "v": zeros(), "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in named_leaves(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig, *,
                 grad_norm: torch.Tensor | None = None
                 ) -> tuple[Any, dict, dict[str, torch.Tensor]]:
    """One AdamW step, in place. ``grads`` is keyed (or shaped) like the
    parameters. ``grad_norm`` is the norm that clips them, by default
    theirs; the trainer on a mesh passes the whole tree's and its shards.
    Returns (params, state, metrics ``grad_norm``, ``lr``)."""
    named = named_leaves(params)
    names = list(named)
    g_by_name = named_leaves(grads)
    p = [named[n] for n in names]
    g = [g_by_name[n] for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]

    count = state["count"].add_(1)
    gnorm = global_norm(g_by_name) if grad_norm is None else grad_norm
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = cfg.schedule(count)
    bc1 = 1.0 - torch.pow(cfg.b1, count.float())
    bc2 = 1.0 - torch.pow(cfg.b2, count.float())

    for piece in _pieces([x.numel() for x in p], UPDATE_PIECE):
        _update([p[i].view(-1)[a:b] for i, a, b in piece],
                [g[i].reshape(-1)[a:b] for i, a, b in piece],
                [m[i].view(-1)[a:b] for i, a, b in piece],
                [v[i].view(-1)[a:b] for i, a, b in piece],
                scale, lr, bc1, bc2, cfg)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# Elements a piece of the elementwise update holds: its f32 temporaries
# (a few copies of the piece) stay near 1 GiB whatever the model's size.
UPDATE_PIECE = 1 << 26


def _pieces(sizes: list[int], piece: int):
    """The leaves' elements as pieces of at most ``piece`` elements:
    lists of ``(leaf, start, stop)``, small leaves gathered into one piece,
    a large one cut into several."""
    out, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        for a in range(0, size, piece):
            b = min(size, a + piece)
            if cur and n + b - a > piece:
                out.append(cur)
                cur, n = [], 0
            cur.append((i, a, b))
            n += b - a
    if cur:
        out.append(cur)
    return out


def _update(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """The elementwise AdamW update of one piece (flat slices of the
    leaves), in place: every element's ops are those of the whole-tree
    update, so the pieces give it bitwise."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = torch._foreach_mul([x.float() for x in g], scale)
    m32 = torch._foreach_mul([x.float() for x in m], b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
    v32 = torch._foreach_mul([x.float() for x in v], b2)
    torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - b2))
    del g32
    denom = torch._foreach_sqrt(torch._foreach_div(v32, bc2))
    torch._foreach_add_(denom, cfg.eps)
    step = torch._foreach_div(torch._foreach_div(m32, bc1), denom)
    del denom
    p32 = [x.float() for x in p]
    torch._foreach_add_(step, torch._foreach_mul(p32, cfg.weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(step, lr))
    del step, p32
    torch._foreach_copy_(p, new_p)
    torch._foreach_copy_(m, m32)
    torch._foreach_copy_(v, v32)
