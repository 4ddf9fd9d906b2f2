"""Gradient/delta compression for the slow (cross-pod) tier.

The port of ``repro.optim.compress``. The fast tier (intra-pod) stays exact;
only the rare cross-pod exchange is compressed, and error feedback re-injects
the truncation at the next sync, so the compression stays unbiased over
time.

* int8: per-tensor absmax scaling, 4x wire reduction vs f32 (2x vs bf16).
  ``torch.round`` rounds half to even, as ``jnp.round`` does.
* top-k: magnitude sparsification to a fraction of entries.
"""

from __future__ import annotations

import torch

__all__ = ["int8_encode", "int8_decode", "int8_residual", "topk_mask", "ef_compress"]


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # ``absmax / 127.0`` as the jitted JAX function computes it: XLA turns a
    # division by a constant into a product with its f32 reciprocal.
    scale = torch.max(torch.abs(x.float())) * (1.0 / 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_residual(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``y - int8_decode(q, scale)`` in f32 as the jitted JAX functions
    compute it: XLA fuses the product into the subtraction (one rounding,
    a fused multiply-add). The product of an int8 and an f32 is exact in
    f64, so the f64 difference rounded to f32 is that fused result."""
    return (y.double() - q.double() * scale.double()).float()


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Boolean mask keeping the top ``frac`` entries by magnitude."""
    flat = torch.abs(x.reshape(-1).float())
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x.float()) >= thresh).reshape(x.shape)


def ef_compress(
    x: torch.Tensor, ef: torch.Tensor, method: str, topk_frac: float = 0.01
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Error-feedback compression of one tensor.

    Returns (decoded payload as seen by receivers, new error residual,
    wire tensor for byte accounting or None for 'none').
    """
    if method == "none":
        return x, torch.zeros_like(ef), None
    y = x.float() + ef.float()
    if method == "int8":
        q, scale = int8_encode(y)
        dec = int8_decode(q, scale)
        return dec.to(x.dtype), int8_residual(y, q, scale).to(ef.dtype), q
    if method == "topk":
        mask = topk_mask(y, topk_frac)
        dec = torch.where(mask, y, 0.0)
        return dec.to(x.dtype), (y - dec).to(ef.dtype), dec
    raise ValueError(f"unknown compression method {method!r}")
