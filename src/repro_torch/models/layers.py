"""Dense-transformer layers in PyTorch: the port of ``repro.models.layers``.

Parameters live in small ``nn.Module`` containers whose names mirror the JAX
parameter dicts (``Dense`` holds ``w`` ``[d_in, d_out]`` and ``b``; attention
is a ``ModuleDict`` of ``q``, ``k``, ``v``, ``o``; the SwiGLU MLP one of
``gate``, ``up``, ``down``), and the layers are plain functions of those
containers and tensors, as in JAX. Layouts are JAX's: activations
``[B, S, D]``, heads ``[B, S, H, Dh]``. Reductions (softmax, norms) run in
f32 inside a bf16 compute stream.

**On a mesh** the compute splits over the model axis as the JAX
package's specs split it under GSPMD (:class:`TPSplit`, Megatron's
layout): a rank holds its model shard of each weight and computes with it.
q, k, v, gate and up are split by columns, o and down by rows and their
partial products summed over the axis; the embedding looks up the rank's
vocab rows and sums, the unembedding gives the rank's vocab columns, and
the cross entropy reduces over the split vocab
(:func:`chunked_cross_entropy` with ``split``). Attention is
head-parallel (``"heads"``: a rank's own KV heads and their query heads)
or context-parallel (``"seq"``: a rank's own query positions against the
whole K and V, its output gathered along the sequence), the pins the JAX
``attn_pspecs`` name. The collectives carry gradients
(:func:`~repro_torch.core.comm.enter_split` and its kin); serving runs
them under ``torch.no_grad()``, their forward alone.

On a mesh the weights are also sharded over the FSDP axes: each model
calls :func:`unit` where a unit (a layer, the embedding, the head, a final
norm) runs, inside the function a checkpoint wraps, and the unit is
gathered there alone (:mod:`~repro_torch.models.fsdp`).

Serving on a mesh also splits the cache, which stays where its shard lies
(:class:`TPSplit`'s ``kv``): with the KV heads split, a rank attends with
its own heads over its own cache shard; with the sequence split, a rank
attends over the positions it holds and the partial softmax sums are
merged by log-sum-exp (:func:`gqa_attention` with ``split``). Every
family serves and trains under the compute split: no weight is whole on a
mesh whose model extent is above 1.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core import comm
from repro_torch.kernels import ops
from repro_torch.models.fsdp import FSDP, unit

__all__ = [
    "TPSplit",
    "FSDP",
    "unit",
    "embed_lookup",
    "write_positions",
    "Dense",
    "RMSNorm",
    "dense_init",
    "dense",
    "rms_norm_init",
    "rms_norm",
    "nonparam_layer_norm",
    "LayerNorm",
    "layer_norm_init",
    "layer_norm",
    "gelu_mlp_init",
    "gelu_mlp",
    "sinusoidal_positions",
    "rope",
    "attention_scores",
    "causal_window_mask",
    "FLASH_THRESHOLD",
    "attention_init",
    "gqa_attention",
    "swiglu_init",
    "swiglu",
    "cross_entropy",
    "chunked_cross_entropy",
    "checkpointed",
]


def _param(x: torch.Tensor) -> nn.Parameter:
    # Frozen by default, for serving: training turns the weights on with
    # ``TransformerParams.requires_grad_()``. The flash kernel has no
    # backward (nor has the JAX one), so ``ops.flash_attention`` refuses
    # inputs that require grad.
    return nn.Parameter(x, requires_grad=False)


@dataclasses.dataclass(frozen=True)
class TPSplit:
    """How a rank's share of a model lies over ``axis`` of ``mesh``: the
    compute half (``attn``) and, serving, the cache half (``kv``).

    The layers take this rank's model shards of the weights (the stored
    shard along every dimension the specs split over ``axis``) and split
    the compute as Megatron does: the products, head-parallel (``attn``
    ``"heads"``) or context-parallel (``"seq"``) attention, the
    vocab-parallel embedding, unembedding and cross entropy, MoE experts
    where they are stored, and an SSM's heads (a family without attention
    takes ``"heads"``), through the collectives of
    :mod:`~repro_torch.core.comm`, counted under their names there.

    ``kv``: how a serving rank's KV cache lies over ``axis``: ``"heads"``
    (the KV heads split), ``"seq"`` (the sequence split: rank ``i`` of the
    axis holds positions ``[i L, (i + 1) L)``) or None (no KV cache split,
    as in training). Attention splits as the cache does. An SSM state's
    heads lie over ``"model"`` (every model's ``cache_pspecs`` names it).
    The sequence split's own collective is counted as
    ``"merge_partials"`` (softmax partials)."""

    mesh: Any
    axis: str = "model"
    attn: str = "heads"
    kv: str | None = None

    def __post_init__(self) -> None:
        if self.attn not in ("heads", "seq"):
            raise ValueError(f"unknown attention split {self.attn!r} (heads or seq)")
        if self.kv not in ("heads", "seq", None):
            raise ValueError(f"unknown cache split {self.kv!r} (heads, seq or None)")
        if self.kv is not None and self.kv != self.attn:
            raise ValueError(f"attention split {self.attn!r} does not follow the cache's "
                             f"{self.kv!r}")

    @property
    def index(self) -> tuple[int, int]:
        """``(this rank's index, the extent)`` along ``axis``."""
        return self.mesh.block(self.axis)

    def local(self, total: int, what: str) -> int:
        """``total`` over the extent; ``ValueError`` naming ``what`` where
        the extent does not divide it."""
        n = self.index[1]
        if total % n:
            raise ValueError(f"{what}: {total} do not divide over {self.axis} (extent {n})")
        return total // n

    def enter(self, x):
        return comm.enter_split(x, self.mesh, self.axis)

    def sum(self, x):
        return comm.sum_partials(x, self.mesh, self.axis)

    def gather(self, x, dim: int):
        return comm.gather_split(x, self.mesh, self.axis, dim=dim)

    def own(self, x, dim: int):
        return comm.own_slice(x, self.mesh, self.axis, dim=dim)

    def max(self, x):
        return comm.max_over(x, self.mesh, self.axis)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype,
                 split: TPSplit | None = None) -> torch.Tensor:
    """``table[tokens]`` in ``dtype``. Under ``split`` ``table`` is this
    rank's block of vocab rows: each rank looks up the tokens it holds,
    zeros elsewhere, and the ranks' rows are summed (exact: one rank holds
    each token, the others add zeros)."""
    if split is None:
        return table[tokens].to(dtype)
    rows = table.shape[0]
    local = tokens.long() - split.index[0] * rows
    own = (local >= 0) & (local < rows)
    h = table[local.clamp(0, rows - 1)].to(dtype)
    return split.sum(torch.where(own[..., None], h, torch.zeros((), dtype=dtype,
                                                                 device=h.device)))


def write_positions(buf: torch.Tensor, fresh: torch.Tensor, cache_index: int, dim: int,
                    split: TPSplit) -> None:
    """Write ``fresh`` (positions ``cache_index ...`` along ``dim``) into
    ``buf``, this rank's sequence shard under ``split``: only the positions
    the shard holds, none if it holds none."""
    length = buf.shape[dim]
    off = split.mesh.block(split.axis)[0] * length
    lo = max(cache_index, off)
    hi = min(cache_index + fresh.shape[dim], off + length)
    if lo < hi:
        buf.narrow(dim, lo - off, hi - lo).copy_(fresh.narrow(dim, lo - cache_index, hi - lo))


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


class LayerNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias)


# ---------------------------------------------------------------------------
# basics


def dense_init(
    d_in: int, d_out: int, *, generator: torch.Generator | None, bias: bool = False,
    dtype=torch.float32, device=None,
) -> Dense:
    """``normal(0, 1) / sqrt(d_in)`` drawn in f32, cast to ``dtype``; zero
    bias. On ``generator``'s device (``device`` without a generator, such as
    ``meta`` for shapes alone)."""
    dev = generator.device if generator is not None else device
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


def layer_norm_init(d: int, dtype=torch.float32, device=None) -> LayerNorm:
    return LayerNorm(torch.ones(d, dtype=dtype, device=device),
                     torch.zeros(d, dtype=dtype, device=device))


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with scale and bias, statistics in f32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def gelu_mlp_init(d_model: int, d_ff: int, *, generator: torch.Generator | None,
                  dtype=torch.float32, device=None) -> nn.ModuleDict:
    kw = dict(generator=generator, bias=True, dtype=dtype, device=device)
    return nn.ModuleDict({"up": dense_init(d_model, d_ff, **kw),
                          "down": dense_init(d_ff, d_model, **kw)})


def gelu_mlp(p: nn.ModuleDict, x: torch.Tensor, split: TPSplit | None = None) -> torch.Tensor:
    """``down(gelu(up(x)))`` with the tanh approximation of GELU:
    ``jax.nn.gelu``'s default. Under ``split`` up (and its bias) are this
    rank's columns and down's weight its rows; the partial products are
    summed and down's bias, whole on every rank, is added once after."""
    if split is None:
        return dense(p["down"], F.gelu(dense(p["up"], x), approximate="tanh"))
    a = F.gelu(dense(p["up"], split.enter(x)), approximate="tanh")
    return split.sum(a @ p["down"].w.to(a.dtype)) + p["down"].b.to(a.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int,
                         dtype=torch.float32) -> torch.Tensor:
    """``[B, S]`` positions -> ``[B, S, D]`` sinusoidal embeddings
    (Whisper-style): ``sin`` then ``cos`` of ``pos * exp(-log(1e4) i / (D/2 - 1))``."""
    half = d_model // 2
    log_base = float(torch.log(torch.tensor(10_000.0)))   # log in f32, as the reference
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                              device=positions.device) / max(half - 1, 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


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


def _streaming_partial(
    q: torch.Tensor,       # [B, S_q, H, Dh]
    k: torch.Tensor,       # [B, S_k, Hkv, Dh]
    v: torch.Tensor,       # [B, S_k, Hkv, Dh]
    q_pos: torch.Tensor,   # [B, S_q]
    k_pos: torch.Tensor,   # [B, S_k]
    k_len: int,            # number of valid keys
    window: int,
    kc: int,               # key block
):
    """The online-softmax loop of :func:`_streaming_attention` over key
    blocks of ``kc``, unnormalised: ``(m, denom, acc)``, f32, ``m`` and
    ``denom`` ``[B, Hkv, G, S_q]`` and ``acc`` ``[B, Hkv, G, S_q, Dh]``. A
    query row with no valid key keeps ``m`` at ``-1e30``."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
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
    return m, denom, acc


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
    sk = k.shape[1]
    kc = min(_K_CHUNK, sk)
    if sk % kc:
        raise ValueError(f"streaming attention: S_k {sk} is not a multiple of {kc}")
    _, denom, acc = _streaming_partial(q, k, v, q_pos, k_pos, k_len, window, kc)
    out = acc / torch.clamp(denom[..., None], min=1e-30)   # [B, Hkv, G, S_q, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def _dense_partial(q, k, v, q_pos, k_pos, k_len, window):
    """:func:`attention_scores`' logits (in q's dtype, then f32) under the
    mask :func:`gqa_attention`'s dense path builds, unnormalised:
    ``(m, denom, acc)`` as :func:`_streaming_partial` gives them, the
    products in f32. Masked logits are ``-1e30``, as there, so a row
    with no valid key has a finite ``m`` of ``-1e30``."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(dh)
    k_valid = (k_pos[0] < k_len).expand(k_pos.shape)
    mask = causal_window_mask(q_pos, k_pos, k_valid, window)
    logits = torch.where(mask[:, :, None], logits, -1e30)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())


def _merge_partials(m, denom, acc, split: TPSplit, dtype) -> torch.Tensor:
    """The ranks' partials over ``split.axis`` merged by log-sum-exp, added
    in rank order: ``[B, S_q, H, Dh]`` in ``dtype``. One gather of the
    packed partials (``acc``, ``m``, ``denom``; ``"merge_partials"``). A
    rank whose row held no valid key (``m`` -1e30) weighs ``exp(-1e30 -
    M)`` = 0."""
    b, hkv, g, sq, dh = acc.shape
    packed = torch.cat([acc, m[..., None], denom[..., None]], dim=-1)
    parts = comm.all_gather(packed[None], split.mesh, split.axis, dim=0,
                            count_as="merge_partials")
    top = parts[..., dh].amax(dim=0)
    num = torch.zeros_like(acc)
    den = torch.zeros_like(m)
    for part in parts.unbind(0):
        wgt = torch.exp(part[..., dh] - top)
        num = num + wgt[..., None] * part[..., :dh]
        den = den + wgt * part[..., dh + 1]
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, dh).to(dtype)


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
    use_rope: bool = True,
    cache_mode: str = "inplace",      # 'inplace' | 'append_slice' | 'fresh_only'
    use_pallas: bool = False,         # the flash kernel (full-sequence path only)
    split: TPSplit | None = None,     # on a mesh: the compute and cache split
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

    With a ``split`` the weights are this rank's model shards and the
    heads or the queries are split (:func:`_tp_attention`); ``kv_cache``,
    if any, is this rank's shard.
    """
    if split is not None:
        return _tp_attention(p, x, positions, n_heads=n_heads, n_kv=n_kv, d_head=d_head,
                             rope_theta=rope_theta, window=window, use_rope=use_rope,
                             use_pallas=use_pallas, split=split, kv_cache=kv_cache,
                             cache_index=cache_index, cache_mode=cache_mode)
    b, s, _ = x.shape
    q = dense(p["q"], x).reshape(b, s, n_heads, d_head)
    k = dense(p["k"], x).reshape(b, s, n_kv, d_head)
    v = dense(p["v"], x).reshape(b, s, n_kv, d_head)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    out, new_cache = _attend(q, k, v, positions, window, kv_cache, cache_index, cache_mode,
                             use_pallas)
    out = out.reshape(b, s, n_heads * d_head)
    return dense(p["o"], out), new_cache


def _attend(q, k, v, positions, window, kv_cache, cache_index, cache_mode, use_pallas):
    """The heads' attention of :func:`gqa_attention` after the projections:
    ``(out [B, S, H, Dh], updated cache or fresh slices or None)``."""
    b, s = q.shape[:2]
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
        slots = torch.arange(s_max, dtype=torch.int32, device=q.device)
        k_pos = torch.cat([slots.expand(b, s_max), positions.to(torch.int32)], dim=1)
        # Valid: cache entries below cache_index and the fresh positions;
        # invalid cache slots are moved past every query.
        in_cache = torch.arange(s_max + s, device=q.device) < s_max
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
        k_pos = torch.arange(s_max, dtype=torch.int32, device=q.device).expand(b, s_max)
        k_len = cache_index + s
    else:
        raise ValueError(f"unknown cache_mode {cache_mode!r}")

    if use_pallas and kv_cache is None and s >= FLASH_THRESHOLD:
        # The kernel's positions are block indices: canonical in the
        # full-sequence forward.
        return ops.flash_attention(q, k_full, v_full, window, k_len), new_cache
    if s >= FLASH_THRESHOLD:
        return _streaming_attention(q, k_full, v_full, positions, k_pos, k_len,
                                    window), new_cache
    k_valid = (k_pos[0] < k_len).expand(k_pos.shape)
    mask = causal_window_mask(positions, k_pos, k_valid, window)
    return attention_scores(q, k_full, v_full, mask), new_cache


def _seq_attend(q, k, v, positions, window, kv_cache, cache_index, cache_mode,
                split: TPSplit):
    """:func:`_attend` over this rank's sequence shard, merged over the
    ranks: ``(out [B, S, H, Dh], the updated shard or the fresh K/V)``."""
    r, n = split.mesh.block(split.axis)
    b, s = q.shape[:2]
    ck, cv = kv_cache
    length = ck.shape[1]
    off = r * length
    k_pos = off + torch.arange(length, dtype=torch.int32, device=q.device).expand(b, length)
    if cache_mode == "inplace":
        ck, cv = ck.clone(), cv.clone()
        write_positions(ck, k, cache_index, 1, split)
        write_positions(cv, v, cache_index, 1, split)
        new_cache = (ck, cv)
        k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
        k_len = cache_index + s
        s_max = n * length
    elif cache_mode == "append_slice":
        k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
        k_pos = torch.where(k_pos >= cache_index, 2**30, k_pos)
        if min(cache_index // length, n - 1) == r:  # the fresh keys enter here, once
            k_full, v_full = torch.cat([k_full, k], dim=1), torch.cat([v_full, v], dim=1)
            k_pos = torch.cat([k_pos, positions.to(torch.int32)], dim=1)
        k_len = 2**30
        new_cache = (k, v)
        s_max = n * length + s
    else:
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    if s >= FLASH_THRESHOLD:
        kc = min(_K_CHUNK, s_max)
        if k_full.shape[1] % kc:
            raise ValueError(
                f"streaming attention over a sequence split: the {kc}-key blocks of the "
                f"{s_max}-position cache do not tile a rank's shard of {k_full.shape[1]} "
                f"positions ({n} over {split.axis}); the shard is not gathered")
        m, denom, acc = _streaming_partial(q, k_full, v_full, positions, k_pos, k_len,
                                           window, kc)
    else:
        m, denom, acc = _dense_partial(q, k_full, v_full, positions, k_pos, k_len, window)
    return _merge_partials(m, denom, acc, split, q.dtype), new_cache


def _tp_attention(p, x, positions, *, n_heads, n_kv, d_head, rope_theta, window, use_rope,
                  use_pallas, split: TPSplit, kv_cache=None, cache_index=None,
                  cache_mode="inplace"):
    """:func:`gqa_attention` under a compute split, ``p`` this rank's
    shards (q, k, v by columns, o by rows) and ``kv_cache``, serving, this
    rank's cache shard. Returns (output [B, S, D], as :func:`_attend`'s
    cache result).

    * ``heads``: the rank's columns are its own KV heads and their query
      heads; it attends with them as one device would (over its own cache
      shard, which holds its KV heads), and the output product's partial
      sums are summed over the axis.
    * ``seq``: q, k and v are gathered whole over the axis (the columns
      may split a head). Without a cache or from an empty one
      (``fresh_only``) the rank keeps its own ``S / n`` query positions and
      attends over every key, and the output is gathered along the
      sequence; a serving prompt whose length does not divide over the
      axis attends whole on every rank (training refuses it). Against a
      cache the rank attends over the positions its shard holds and the
      partials are merged (:func:`_seq_attend`). Either way the rank's
      columns of the output are multiplied by its rows of o, then summed.
      The fresh K/V returned are every position's.
    """
    b, s, _ = x.shape
    x = split.enter(x)
    if split.attn == "heads":
        h_loc = split.local(n_heads, "query heads")
        kv_loc = split.local(n_kv, "KV heads")
        q = dense(p["q"], x).reshape(b, s, h_loc, d_head)
        k = dense(p["k"], x).reshape(b, s, kv_loc, d_head)
        v = dense(p["v"], x).reshape(b, s, kv_loc, d_head)
        if use_rope:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
        out, new_cache = _attend(q, k, v, positions, window, kv_cache, cache_index, cache_mode,
                                 use_pallas)
        return split.sum(dense(p["o"], out.reshape(b, s, h_loc * d_head))), new_cache
    r, n = split.index
    q = split.gather(dense(p["q"], x), -1).reshape(b, s, n_heads, d_head)
    k = split.enter(split.gather(dense(p["k"], x), -1)).reshape(b, s, n_kv, d_head)
    v = split.enter(split.gather(dense(p["v"], x), -1)).reshape(b, s, n_kv, d_head)
    if kv_cache is not None and cache_mode != "fresh_only":
        if use_rope:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
        out, new_cache = _seq_attend(q, k, v, positions, window, kv_cache, cache_index,
                                     cache_mode, split)
        out = out.reshape(b, s, n_heads * d_head)
    else:
        k_len = s if cache_index is None else cache_index + s
        whole = kv_cache is not None and s % n != 0
        s_loc = s if whole else split.local(s, "sequence positions")
        q_pos = positions if whole else positions[:, r * s_loc:(r + 1) * s_loc]
        if not whole:
            q = split.own(q, 1)
        if use_rope:
            q = rope(q, q_pos, rope_theta)
            k = rope(k, positions, rope_theta)
        new_cache = None if kv_cache is None else (k, v)
        if s_loc >= FLASH_THRESHOLD:
            out = _streaming_attention(q, k, v, q_pos, positions, k_len, window)
        else:
            out = attention_scores(q, k, v, causal_window_mask(q_pos, positions, None, window))
        out = out.reshape(b, s_loc, n_heads * d_head)
        if not whole:
            out = split.gather(out, 1)
    return split.sum(dense(p["o"], split.own(out, -1))), new_cache


def attention_init(
    d_model: int, n_heads: int, n_kv: int, d_head: int, *,
    generator: torch.Generator | None, bias: bool = False, dtype=torch.float32,
    device=None,
) -> nn.ModuleDict:
    def make(d_in, d_out, b):
        return dense_init(d_in, d_out, generator=generator, bias=b, dtype=dtype,
                          device=device)

    return nn.ModuleDict({
        "q": make(d_model, n_heads * d_head, bias),
        "k": make(d_model, n_kv * d_head, bias),
        "v": make(d_model, n_kv * d_head, bias),
        "o": make(n_heads * d_head, d_model, False),
    })


# ---------------------------------------------------------------------------
# feed-forward


def swiglu_init(d_model: int, d_ff: int, *, generator: torch.Generator | None,
                dtype=torch.float32, device=None) -> nn.ModuleDict:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return nn.ModuleDict({
        "gate": dense_init(d_model, d_ff, **kw),
        "up": dense_init(d_model, d_ff, **kw),
        "down": dense_init(d_ff, d_model, **kw),
    })


def swiglu(p: nn.ModuleDict, x: torch.Tensor, split: TPSplit | None = None) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))``; under ``split`` gate and up are this
    rank's columns and down its rows, the partial products summed."""
    if split is not None:
        x = split.enter(x)
    y = dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))
    return y if split is None else split.sum(y)


# ---------------------------------------------------------------------------
# loss


def cross_entropy(
    logits: torch.Tensor,              # [B, S, V]
    labels: torch.Tensor,              # [B, S] int
    mask: torch.Tensor | None = None,  # [B, S] bool
) -> torch.Tensor:
    """Mean next-token cross entropy, f32 accumulation."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _chunk_nll(unembed_fn, h_i: torch.Tensor, y_i: torch.Tensor) -> torch.Tensor:
    logits = unembed_fn(h_i).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_i[..., None].long())[..., 0]
    return (logz - gold).sum()


def _chunk_nll_split(unembed_fn, h_i: torch.Tensor, y_i: torch.Tensor, *,
                     split: TPSplit) -> torch.Tensor:
    """:func:`_chunk_nll` over the vocab split: ``unembed_fn`` gives this
    rank's vocab columns. The max goes over the axis without a gradient;
    the sum of exponentials and the gold logit are summed over it."""
    logits = unembed_fn(split.enter(h_i)).float()      # [B, c, V / n]
    cols = logits.shape[-1]
    m = split.max(logits.amax(dim=-1))
    sumexp = split.sum(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = y_i.long() - split.index[0] * cols
    own = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
    gold = split.sum(torch.where(own, gold, torch.zeros((), device=gold.device)))
    return (m + torch.log(sumexp) - gold).sum()


def chunked_cross_entropy(
    unembed_fn,
    h: torch.Tensor,        # [B, S, D] final hidden states
    labels: torch.Tensor,   # [B, S]
    chunk: int = 1024,
    split: TPSplit | None = None,
) -> torch.Tensor:
    """CE without ever materialising the full ``[B, S, V]`` logits.

    The unembedding and the log-softmax run per sequence chunk in a Python
    loop (one chunk when ``S % chunk``), summed in f32 and divided by
    ``B * S``, as the JAX scan does. Under autograd each chunk is a
    checkpoint: only its hidden states are kept, and the backward recomputes
    its ``[B, chunk, V]`` logits, so one chunk's logits exist at a time in
    the backward too (the unembedding weight's gradient accumulates over the
    chunks). Under ``split`` ``unembed_fn`` gives this rank's vocab
    columns and the log-softmax reduces over the axis
    (:func:`_chunk_nll_split`): the whole ``[B, S, V]`` logits exist on no
    rank, and the backward recomputes a chunk's collectives with it."""
    b, s, _ = h.shape
    if s % chunk != 0:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    nll_fn = _chunk_nll if split is None else functools.partial(_chunk_nll_split, split=split)
    for c0 in range(0, s, chunk):
        h_i, y_i = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if remat:
            nll = torch.utils.checkpoint.checkpoint(nll_fn, unembed_fn, h_i, y_i,
                                                    use_reentrant=False)
        else:
            nll = nll_fn(unembed_fn, h_i, y_i)
        total = total + nll
    return total / (b * s)


def checkpointed(fn, h: torch.Tensor, remat: str) -> torch.Tensor:
    """``fn(h)`` for one layer body; a checkpoint of it (its inside freed
    after the forward and recomputed in the backward) when ``remat`` is
    ``"full"`` or ``"dots"`` and autograd records. The JAX SSM, hybrid and
    audio bodies take a plain ``jax.checkpoint`` for both modes."""
    if remat in ("full", "dots") and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False)
    return fn(h)
