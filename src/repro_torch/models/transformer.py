"""Decoder-only dense transformer: the port of ``repro.models.transformer``.

``TransformerConfig`` is the JAX config field for field. ``Transformer``
holds a config and, like the JAX class, keeps no weights: ``init_params``
draws them into a :class:`TransformerParams` module (or
:func:`params_from_numpy` carries a JAX parameter tree over), and
``hidden`` / ``forward`` / ``forward_with_cache`` take it as their first
argument. Layers run in a Python loop where JAX scans; the per-layer window
sizes and rope bases stay data (``window_array`` / ``theta_array``, on the
host, so reading one costs no device synchronisation).

The dense paths are ported; a config with ``moe`` raises (MoE is a later
slice of the LM stack).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers

__all__ = ["TransformerConfig", "Transformer", "TransformerParams", "params_from_numpy"]

_MOE_TODO = ("MoE layers (models/moe.py: llama4, grok) are not ported to repro_torch "
             "yet (ROADMAP: LM stack, MoE)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's transformer config, field for field (see its docs)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None
    window_pattern: tuple[int, ...] = (0,)
    qkv_bias: bool = False
    norm: str = "rms"  # 'rms' | 'nonparam' (olmo)
    moe: Any = None
    tie_embeddings: bool = False
    embed_scale: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    act_batch_axes: tuple[str, ...] | None = None
    attn_sharding: str | None = None
    use_pallas_attention: bool = False

    def __post_init__(self) -> None:
        if self.moe is not None:
            raise NotImplementedError(f"{self.name}: {_MOE_TODO}")
        if self.n_heads % self.n_kv != 0:
            raise ValueError(f"{self.name}: n_heads must divide by n_kv")

    @property
    def group_size(self) -> int:
        return 1  # moe is None

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    # -- per-layer pattern arrays ([n_groups, group_size], on the host) -----

    def window_array(self) -> torch.Tensor:
        pat = self.window_pattern
        w = [pat[i % len(pat)] for i in range(self.n_layers)]
        return torch.tensor(w, dtype=torch.int32).reshape(self.n_groups, self.group_size)

    def theta_array(self) -> torch.Tensor:
        pat = self.window_pattern
        tg = self.rope_theta_global or self.rope_theta
        th = [tg if pat[i % len(pat)] == 0 and self.rope_theta_global else self.rope_theta
              for i in range(self.n_layers)]
        return torch.tensor(th, dtype=torch.float32).reshape(self.n_groups, self.group_size)

    def param_count(self) -> int:
        """Total parameters (dense)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2
        per_dense = attn + 3 * d * ff + 2 * d
        n = v * d + d
        if not self.tie_embeddings:
            n += d * v
        return n + self.n_layers * per_dense


class TransformerParams(nn.Module):
    """The weights: ``embed`` ``[V, D]``, ``layers[i]`` (a ``ModuleDict`` of
    ``attn``, ``ffn`` and, for RMS norms, ``ln1`` / ``ln2``), ``final_norm``
    and, untied, ``lm_head`` ``[D, V]``."""

    def __init__(self, embed: torch.Tensor, layer_list: list[nn.ModuleDict],
                 final_norm: layers.RMSNorm | None, lm_head: torch.Tensor | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layer_list)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)


class Transformer:
    """Functional model: all methods are static given a config."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator) -> TransformerParams:
        """Weights on ``generator``'s device, drawn with the JAX package's
        distributions and scales (embedding N(0, 0.02^2), dense N(0, 1/d_in),
        lm_head N(0, 1/d_model), zero biases, unit norm scales)."""
        cfg = self.cfg
        pd, dev = cfg.pdtype, generator.device
        embed = (torch.randn(cfg.vocab, cfg.d_model, generator=generator, device=dev)
                 * 0.02).to(pd)
        layer_list = []
        for _ in range(cfg.n_layers):
            sub = nn.ModuleDict({
                "attn": layers.attention_init(
                    cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                    generator=generator, bias=cfg.qkv_bias, dtype=pd),
                "ffn": layers.swiglu_init(cfg.d_model, cfg.d_ff, generator=generator,
                                          dtype=pd),
            })
            if cfg.norm == "rms":
                sub["ln1"] = layers.rms_norm_init(cfg.d_model, pd, dev)
                sub["ln2"] = layers.rms_norm_init(cfg.d_model, pd, dev)
            layer_list.append(sub)
        final_norm = layers.rms_norm_init(cfg.d_model, pd, dev) if cfg.norm == "rms" else None
        lm_head = None
        if not cfg.tie_embeddings:
            lm_head = (torch.randn(cfg.d_model, cfg.vocab, generator=generator, device=dev)
                       / math.sqrt(cfg.d_model)).to(pd)
        return TransformerParams(embed, layer_list, final_norm, lm_head)

    # ----------------------------------------------------------------- norms

    def _norm(self, sub: nn.ModuleDict, which: str, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.norm == "rms":
            return layers.rms_norm(sub[which], x)
        return layers.nonparam_layer_norm(x)

    def _final_norm(self, params: TransformerParams, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.norm == "rms":
            return layers.rms_norm(params.final_norm, h)
        return layers.nonparam_layer_norm(h)

    # ------------------------------------------------------------- layers

    def _layers(self, params, h, positions, *, cache=None, cache_index=None,
                cache_mode="inplace"):
        """Every layer in order; with a cache, also each layer's new K/V
        (fresh slices, or the whole updated cache in ``inplace`` mode)."""
        cfg = self.cfg
        windows, thetas = cfg.window_array(), cfg.theta_array()
        new_kv = []
        for i, sub in enumerate(params.layers):
            kv = None
            if cache is not None:
                kv = (cache["sub_0"]["k"][i], cache["sub_0"]["v"][i])
            attn_out, kv_i = layers.gqa_attention(
                sub["attn"], self._norm(sub, "ln1", h), positions,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                rope_theta=thetas[i, 0], window=int(windows[i, 0]),
                kv_cache=kv, cache_index=cache_index, cache_mode=cache_mode,
                use_pallas=cfg.use_pallas_attention)
            h = h + attn_out
            h = h + layers.swiglu(sub["ffn"], self._norm(sub, "ln2", h))
            new_kv.append(kv_i)
        return h, new_kv

    # --------------------------------------------------------------- forward

    def _embed(self, params: TransformerParams, tokens: torch.Tensor) -> torch.Tensor:
        h = params.embed[tokens].to(self.cfg.cdtype)
        if self.cfg.embed_scale:
            h = h * math.sqrt(self.cfg.d_model)
        return h

    def unembed(self, params: TransformerParams, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params.embed.T.to(h.dtype)
        return h @ params.lm_head.to(h.dtype)

    def hidden(self, params: TransformerParams, tokens: torch.Tensor):
        """Full-sequence forward up to the final norm. Returns (h [B, S, D],
        aux loss 0: dense layers have none)."""
        b, s = tokens.shape
        h = self._embed(params, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        h, _ = self._layers(params, h, positions)
        return self._final_norm(params, h), torch.zeros((), device=h.device)

    def forward(self, params: TransformerParams, tokens: torch.Tensor):
        """Full-sequence forward. Returns (logits [B, S, V], aux loss)."""
        h, aux = self.hidden(params, tokens)
        return self.unembed(params, h), aux

    # ------------------------------------------------------------- serving

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """``{"sub_0": {"k", "v"}}``, each ``[n_layers, B, max_len, Hkv, Dh]``
        zeros, the JAX cache layout."""
        cfg = self.cfg
        shape = (cfg.n_groups, batch, max_len, cfg.n_kv, cfg.d_head)
        return {"sub_0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}}

    def forward_with_cache(self, params: TransformerParams, tokens: torch.Tensor,
                           cache: dict, cache_index: int, *, last_only: bool = False):
        """Prefill (``S`` > 1) or decode (``S`` = 1) against ``cache``.

        Returns (logits, cache). The cache is updated in place: the fresh
        K/V of every layer are merged into it at ``cache_index`` with one copy
        per call (JAX does the same with one dynamic update of a donated
        buffer)."""
        cfg = self.cfg
        b, s = tokens.shape
        h = self._embed(params, tokens)
        positions = cache_index + torch.arange(
            s, dtype=torch.int32, device=tokens.device).expand(b, s)
        if s > 1:
            cache_mode = "fresh_only"
        elif cfg.attn_sharding == "seq":
            cache_mode = "inplace"
        else:
            cache_mode = "append_slice"
        h, new_kv = self._layers(params, h, positions, cache=cache,
                                 cache_index=cache_index, cache_mode=cache_mode)
        for j, name in enumerate(("k", "v")):
            buf = cache["sub_0"][name]
            fresh = torch.stack([kv[j] for kv in new_kv])
            if cache_mode == "inplace":
                buf.copy_(fresh)  # the layers returned whole updated caches
            else:
                buf[:, :, cache_index:cache_index + s] = fresh.to(buf.dtype)
        h = self._final_norm(params, h)
        if last_only:
            h = h[:, -1:]
        return self.unembed(params, h), cache


def params_from_numpy(cfg: TransformerConfig, tree: Mapping, device=None) -> TransformerParams:
    """The JAX parameter tree (numpy arrays; per-layer leaves with a leading
    ``[n_groups]`` axis under ``layers.sub_0``) as the port's parameters."""
    def t(x) -> torch.Tensor:
        a = np.array(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch reads no such numpy dtype
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(a).to(device)

    def dense(d: Mapping, i: int) -> layers.Dense:
        return layers.Dense(t(d["w"][i]), t(d["b"][i]) if "b" in d else None)

    sub = tree["layers"]["sub_0"]
    layer_list = []
    for i in range(cfg.n_layers):
        mods = nn.ModuleDict({
            "attn": nn.ModuleDict({n: dense(sub["attn"][n], i) for n in ("q", "k", "v", "o")}),
            "ffn": nn.ModuleDict({n: dense(sub["ffn"][n], i) for n in ("gate", "up", "down")}),
        })
        if cfg.norm == "rms":
            mods["ln1"] = layers.RMSNorm(t(sub["ln1"]["scale"][i]))
            mods["ln2"] = layers.RMSNorm(t(sub["ln2"]["scale"][i]))
        layer_list.append(mods)
    final_norm = layers.RMSNorm(t(tree["final_norm"]["scale"])) if cfg.norm == "rms" else None
    lm_head = t(tree["lm_head"]) if "lm_head" in tree else None
    return TransformerParams(t(tree["embed"]), layer_list, final_norm, lm_head)
