"""Dense-transformer layers in PyTorch: the port of ``repro.models.layers``.

Parameters live in small ``nn.Module`` containers whose names mirror the JAX
parameter dicts (``Dense`` holds ``w`` ``[d_in, d_out]`` and ``b``; attention
is a ``ModuleDict`` of ``q``, ``k``, ``v``, ``o``; the SwiGLU MLP one of
``gate``, ``up``, ``down``), and the layers are plain functions of those
containers and tensors, as in JAX. Layouts are JAX's: activations
``[B, S, D]``, heads ``[B, S, H, Dh]``. Reductions (softmax, norms) run in
f32 inside a bf16 compute stream. The port has no mesh yet, so the JAX
``with_sharding_constraint`` pins (``attn_pspecs``) are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

__all__ = [
    "Dense",
    "RMSNorm",
    "dense_init",
    "dense",
    "rms_norm_init",
    "rms_norm",
    "nonparam_layer_norm",
    "rope",
    "attention_scores",
    "causal_window_mask",
    "FLASH_THRESHOLD",
    "attention_init",
    "gqa_attention",
    "swiglu_init",
    "swiglu",
]


def _param(x: torch.Tensor) -> nn.Parameter:
    # The slice is forward only (no backward kernel yet): no autograd state.
    return nn.Parameter(x, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` ``[d_in, d_out]``, as the JAX dict."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


# ---------------------------------------------------------------------------
# basics


def dense_init(
    d_in: int, d_out: int, *, generator: torch.Generator, bias: bool = False,
    dtype=torch.float32,
) -> Dense:
    """``normal(0, 1) / sqrt(d_in)`` drawn in f32, cast to ``dtype``; zero
    bias. On ``generator``'s device."""
    dev = generator.device
    w = (torch.randn(d_in, d_out, generator=generator, device=dev)
         / math.sqrt(d_in)).to(dtype)
    return Dense(w, torch.zeros(d_out, dtype=dtype, device=dev) if bias else None)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def rms_norm_init(d: int, dtype=torch.float32, device=None) -> RMSNorm:
    return RMSNorm(torch.ones(d, dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def rope(
    x: torch.Tensor,            # [B, S, H, Dh]
    positions: torch.Tensor,    # [B, S] int
    theta: float | torch.Tensor = 10_000.0,
) -> torch.Tensor:
    """Rotary position embedding; frequencies ``exp(-log(theta) * i / half)``
    in f32, as the JAX package builds them."""
    half = x.shape[-1] // 2
    # log(theta) in f32 on the host (theta is a float or a host tensor): an
    # f32 value as a Python scalar, so the device sees no copy and no sync.
    log_theta = float(torch.log(torch.as_tensor(theta, dtype=torch.float32)))
    freqs = torch.exp(-log_theta * (torch.arange(half, dtype=torch.float32,
                                                 device=x.device) / half))
    angles = positions.float()[..., None] * freqs   # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_scores(
    q: torch.Tensor,     # [B, S_q, H, Dh]
    k: torch.Tensor,     # [B, S_k, Hkv, Dh]
    v: torch.Tensor,     # [B, S_k, Hkv, Dh]
    mask: torch.Tensor,  # [B, 1, S_q, S_k] bool (True = attend)
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention core: logits in q's dtype,
    softmax in f32, probabilities cast back to q's dtype."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits / math.sqrt(dh)
    logits = torch.where(mask[:, :, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, dh)


def causal_window_mask(
    q_pos: torch.Tensor,            # [B, S_q]
    k_pos: torch.Tensor,            # [B, S_k]
    k_valid: torch.Tensor | None,   # [B, S_k] bool or None
    window: int,                    # <= 0: full causal; > 0: sliding window
) -> torch.Tensor:
    """``[B, 1, S_q, S_k]`` mask: causal, optionally windowed, optionally
    masking invalid (unwritten cache) keys."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    w = int(window)
    m = (d >= 0) & ((w <= 0) | (d < w))
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m[:, None]


# Above this many query positions, attention takes the streaming path (or
# the kernel): O(S) memory instead of [B, H, S_q, S_k]. Read at call time, so
# tests can lower it.
FLASH_THRESHOLD = 2048
_K_CHUNK = 1024


def _streaming_attention(
    q: torch.Tensor,       # [B, S_q, H, Dh]
    k: torch.Tensor,       # [B, S_k, Hkv, Dh]
    v: torch.Tensor,       # [B, S_k, Hkv, Dh]
    q_pos: torch.Tensor,   # [B, S_q]
    k_pos: torch.Tensor,   # [B, S_k]
    k_len: int,            # number of valid keys
    window: int,
) -> torch.Tensor:
    """Online-softmax attention: one loop over key blocks of 1024 with all
    query rows resident, the plain equivalent of flash attention."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kc = min(_K_CHUNK, sk)
    if sk % kc:
        raise ValueError(f"streaming attention: S_k {sk} is not a multiple of {kc}")
    scale = 1.0 / math.sqrt(dh)
    w = int(window)
    qf = q.reshape(b, sq, hkv, g, dh).float()
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, kc):
        k_j, v_j = k[:, k0:k0 + kc].float(), v[:, k0:k0 + kc].float()
        kp_j = k_pos[:, k0:k0 + kc]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_j) * scale
        d = q_pos[:, None, None, :, None] - kp_j[:, None, None, None, :]
        mask = (d >= 0) & ((w <= 0) | (d < w))
        mask = mask & (kp_j[:, None, None, None, :] < k_len)
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_j)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)   # [B, Hkv, G, S_q, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def gqa_attention(
    p: nn.ModuleDict,           # q, k, v, o: Dense
    x: torch.Tensor,            # [B, S, D]
    positions: torch.Tensor,    # [B, S]
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float | torch.Tensor = 10_000.0,
    window: int = 0,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # [B, S_max, Hkv, Dh]
    cache_index: int | None = None,   # number of valid cache entries
    cache_mode: str = "inplace",      # 'inplace' | 'append_slice' | 'fresh_only'
    use_pallas: bool = False,         # the flash kernel (full-sequence path only)
):
    """GQA attention with optional sliding window and KV cache.

    Without a cache: causal (optionally windowed) self-attention. With a
    cache: attends over cache + this call's K/V. ``inplace`` returns the
    cache with the fresh K/V written in (new tensors); ``append_slice``
    (decode) attends over concat(cache, fresh) and returns only the fresh
    slices; ``fresh_only`` (prefill from an empty cache) ignores the cache
    and returns the fresh slices. Query blocks of ``FLASH_THRESHOLD`` or more
    take the flash kernel (``use_pallas`` and no cache) or the streaming
    path. Returns (output [B, S, D], updated cache or fresh slices or None).
    """
    b, s, _ = x.shape
    q = dense(p["q"], x).reshape(b, s, n_heads, d_head)
    k = dense(p["k"], x).reshape(b, s, n_kv, d_head)
    v = dense(p["v"], x).reshape(b, s, n_kv, d_head)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    if kv_cache is None or cache_mode == "fresh_only":
        new_cache = None if kv_cache is None else (k, v)
        k_full, v_full = k, v
        k_pos = positions
        k_len = s if cache_index is None else cache_index + s
    elif cache_mode == "append_slice":
        ck, cv = kv_cache
        s_max = ck.shape[1]
        k_full = torch.cat([ck.to(q.dtype), k], dim=1)
        v_full = torch.cat([cv.to(q.dtype), v], dim=1)
        slots = torch.arange(s_max, dtype=torch.int32, device=x.device)
        k_pos = torch.cat([slots.expand(b, s_max), positions.to(torch.int32)], dim=1)
        # Valid: cache entries below cache_index and the fresh positions;
        # invalid cache slots are moved past every query.
        in_cache = torch.arange(s_max + s, device=x.device) < s_max
        k_pos = torch.where(in_cache[None, :] & (k_pos >= cache_index), 2**30, k_pos)
        k_len = 2**30
        new_cache = (k, v)
    elif cache_mode == "inplace":
        ck, cv = kv_cache
        s_max = ck.shape[1]
        ck, cv = ck.clone(), cv.clone()
        ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        new_cache = (ck, cv)
        k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device).expand(b, s_max)
        k_len = cache_index + s
    else:
        raise ValueError(f"unknown cache_mode {cache_mode!r}")

    if use_pallas and kv_cache is None and s >= FLASH_THRESHOLD:
        # The kernel's positions are block indices: canonical in the
        # full-sequence forward.
        out = ops.flash_attention(q, k_full, v_full, window, k_len)
    elif s >= FLASH_THRESHOLD:
        out = _streaming_attention(q, k_full, v_full, positions, k_pos, k_len, window)
    else:
        k_valid = (k_pos[0] < k_len).expand(k_pos.shape)
        mask = causal_window_mask(positions, k_pos, k_valid, window)
        out = attention_scores(q, k_full, v_full, mask)

    out = out.reshape(b, s, n_heads * d_head)
    return dense(p["o"], out), new_cache


def attention_init(
    d_model: int, n_heads: int, n_kv: int, d_head: int, *,
    generator: torch.Generator, bias: bool = False, dtype=torch.float32,
) -> nn.ModuleDict:
    def make(d_in, d_out, b):
        return dense_init(d_in, d_out, generator=generator, bias=b, dtype=dtype)

    return nn.ModuleDict({
        "q": make(d_model, n_heads * d_head, bias),
        "k": make(d_model, n_kv * d_head, bias),
        "v": make(d_model, n_kv * d_head, bias),
        "o": make(n_heads * d_head, d_model, False),
    })


# ---------------------------------------------------------------------------
# feed-forward


def swiglu_init(d_model: int, d_ff: int, *, generator: torch.Generator,
                dtype=torch.float32) -> nn.ModuleDict:
    return nn.ModuleDict({
        "gate": dense_init(d_model, d_ff, generator=generator, dtype=dtype),
        "up": dense_init(d_model, d_ff, generator=generator, dtype=dtype),
        "down": dense_init(d_ff, d_model, generator=generator, dtype=dtype),
    })


def swiglu(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))
