"""Fused GQA flash attention: the CUDA kernel and its plain version.

Port of ``repro.kernels.flash_attention``. Causal attention with an optional
sliding window (``window`` > 0) and a bound ``k_len`` on the valid keys, over
q ``[B, Sq, H, Dh]`` and k, v ``[B, Sk, Hkv, Dh]``; query head ``h`` reads KV
head ``h // (H // Hkv)``. The output has q's shape and dtype.

:func:`flash_attention_plain` transcribes the Pallas body: an online softmax
over key blocks of ``bk``, f32 inside, -1e30 both for masked logits and for
the running max's start, output ``acc / max(l, 1e-30)``. The kernel
(``csrc/flash_attention.cu``) computes the same function with its own tiles,
by one of two routes chosen by dtype: float32 on the CUDA cores, bfloat16 on
the tensor cores (wgmma and TMA, with P split into two bf16 terms so that the
probabilities keep f32 precision in the PV product).
Both keep the JAX wrapper's contract ``Sq % min(bq, Sq) == 0`` and
``Sk % min(bk, Sk) == 0``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda

__all__ = ["BQ", "BK", "HEAD_DIMS", "flash_attention_plain", "flash_attention_cuda"]

BQ = 512   # query rows per block of the Pallas grid
BK = 512   # key rows per block
HEAD_DIMS = (16, 32, 64, 80, 128)  # what the CUDA kernel is built for
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, bq: int, bk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Sq, H, Dh] and k, v [B, Sk, Hkv, Dh] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    sk = k.shape[1]
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"flash_attention: Sq % bq and Sk % bk must be 0, got "
                         f"Sq {sq}, bq {bq}, Sk {sk}, bk {bk}")


def flash_attention_plain(q, k, v, window, k_len, *, bq: int = BQ, bk: int = BK):
    """The Pallas kernel's arithmetic in plain PyTorch (any device).

    The query blocks of the Pallas grid are independent, so they are taken
    together here; the key blocks are walked in order as the grid does.
    """
    _check_shapes(q, k, v, bq, bk)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bk = min(bk, sk)
    scale = 1.0 / math.sqrt(dh)
    w, k_len = int(window), int(k_len)
    qg = q.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4).float()  # [B, Hkv, G, Sq, Dh]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, bk):
        kb = k[:, k0:k0 + bk].permute(0, 2, 1, 3).float()[:, :, None]  # [B, Hkv, 1, Bk, Dh]
        vb = v[:, k0:k0 + bk].permute(0, 2, 1, 3).float()[:, :, None]
        logits = torch.matmul(qg, kb.transpose(-1, -2)) * scale       # [B, Hkv, G, Sq, Bk]
        k_pos = k0 + torch.arange(bk, device=q.device)[None, :]
        d = q_pos - k_pos
        mask = (d >= 0) & ((w <= 0) | (d < w)) & (k_pos < k_len)
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def flash_attention_cuda(q, k, v, window, k_len):
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype
    (float32: CUDA cores; bfloat16: tensor cores, 16-byte aligned) with
    ``Dh`` in :data:`HEAD_DIMS`."""
    _check_shapes(q, k, v, BQ, BK)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype not in _DTYPES or x.dtype != q.dtype \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError(
                f"flash_attention kernel: {name} must be a contiguous CUDA float32 or "
                f"bfloat16 tensor on q's device and of q's dtype, got {x.dtype} on "
                f"{x.device}{'' if x.is_contiguous() else ', not contiguous'}")
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: bfloat16 {name} must start on a "
                             f"16-byte boundary (TMA), got address {x.data_ptr():#x}")
    b, sq, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in {HEAD_DIMS}")
    sk, hkv = k.shape[1], k.shape[2]
    lib = cuda.library("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, sq, sk, h, hkv, dh, int(window), int(k_len), stream)
    cuda.check("flash_attention", err)
    cuda.launches["flash_attention"] += 1
    return out
