"""Zamba2, a Mamba2 backbone with one *shared* attention block: the port of
``repro.models.zamba2``.

The same attention + SwiGLU parameters are applied every ``period`` mamba
layers, on ``concat(hidden, original embedding)`` projected back to
``d_model``. Layout: ``n_apps`` groups of (shared block, then ``period``
mamba layers), then ``n_tail`` trailing mamba layers. The shared block's
attention passes no ``use_pallas``, so this model launches no kernel, as in
the reference. Under autograd ``hidden`` checkpoints each mamba layer body
(not the shared block) as ``cfg.remat`` asks, as the JAX body does.
``param_pspecs`` / ``cache_pspecs`` are the JAX spec trees as tuples.

**On a mesh** (a :class:`~repro_torch.models.layers.TPSplit`) the mamba
layers split as mamba2's do, and the shared block computes this rank's
share: ``in_proj`` is column-parallel over ``d_model`` and its output, the
block's residual stream, is gathered whole; attention splits by heads (or
by positions, as the cache does) and the MLP is Megatron's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import jax_layout, layers
from repro_torch.models.jax_layout import P
from repro_torch.models.mamba2 import Mamba2, Mamba2Config

__all__ = ["Zamba2Config", "Zamba2", "Zamba2Params"]


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    """The JAX package's zamba2 config, field for field."""

    name: str
    n_layers: int           # mamba2 layers
    d_model: int
    vocab: int
    n_heads: int = 32
    n_kv: int = 32
    d_head: int = 64
    d_ff: int = 8192
    period: int = 6         # shared block applied every `period` mamba layers
    d_state: int = 64
    headdim: int = 64
    chunk: int = 128
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    act_batch_axes: tuple[str, ...] | None = None
    attn_sharding: str | None = None

    @property
    def n_apps(self) -> int:
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_apps * self.period

    def mamba_cfg(self) -> Mamba2Config:
        return Mamba2Config(
            name=f"{self.name}-mamba", n_layers=self.n_layers, d_model=self.d_model,
            vocab=self.vocab, d_state=self.d_state, headdim=self.headdim, chunk=self.chunk,
            param_dtype=self.param_dtype, compute_dtype=self.compute_dtype,
            act_batch_axes=self.act_batch_axes)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        base = self.mamba_cfg().param_count()
        d = self.d_model
        shared = (2 * d * d + d * self.n_heads * self.d_head * 2
                  + d * self.n_kv * self.d_head * 2 + 3 * d * self.d_ff + 4 * d)
        return base + shared

    def active_param_count(self) -> int:
        return self.param_count()


class Zamba2Params(nn.Module):
    """``embed``, ``shared`` (``in_proj`` ``[2D, D]``, ``ln1``, ``attn``,
    ``ln2``, ``ffn``), ``groups`` (the first ``n_apps * period`` mamba
    layers), ``tail`` (the rest), ``final_norm``, ``lm_head``: the JAX
    dict's names."""

    def __init__(self, embed, shared: nn.ModuleDict, groups: list[nn.Module],
                 tail: list[nn.Module], final_norm, lm_head):
        super().__init__()
        self.embed = layers._param(embed)
        self.shared = shared
        self.groups = nn.ModuleList(groups)
        self.tail = nn.ModuleList(tail)
        self.final_norm = final_norm
        self.lm_head = layers._param(lm_head)


class Zamba2(jax_layout.Stacked):
    """Functional model: all methods are static given a config. The JAX
    tree stacks ``groups`` leaves ``[n_apps * period, ...]`` and ``tail``
    leaves ``[n_tail, ...]``."""

    stacks = {"groups": None, "tail": None}

    def __init__(self, cfg: Zamba2Config):
        self.cfg = cfg
        self.mamba = Mamba2(cfg.mamba_cfg())

    def init_params(self, generator: torch.Generator | None, *, device=None) -> Zamba2Params:
        cfg = self.cfg
        pd = cfg.pdtype
        dev = generator.device if generator is not None else device
        base = self.mamba.init_params(generator, device=dev)
        kw = dict(generator=generator, dtype=pd, device=dev)
        shared = nn.ModuleDict({
            "in_proj": layers.dense_init(2 * cfg.d_model, cfg.d_model, **kw),
            "ln1": layers.rms_norm_init(cfg.d_model, pd, dev),
            "attn": layers.attention_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head, **kw),
            "ln2": layers.rms_norm_init(cfg.d_model, pd, dev),
            "ffn": layers.swiglu_init(cfg.d_model, cfg.d_ff, **kw),
        })
        n_grp = cfg.n_apps * cfg.period
        mamba = list(base.layers)
        return Zamba2Params(base.embed.data, shared, mamba[:n_grp], mamba[n_grp:],
                            base.final_norm, base.lm_head.data)

    # --------------------------------------------------------------- forward

    def _shared_block(self, p: nn.ModuleDict, h, x0, positions, kv_cache=None,
                      cache_index=None, split=None):
        cfg = self.cfg
        zx = torch.cat([h, x0], dim=-1)
        if split is None:
            z = layers.dense(p["in_proj"], zx)
        else:  # this rank's columns, gathered: the block's residual stream
            z = split.gather(layers.dense(p["in_proj"], split.enter(zx)), -1)
        attn_out, new_kv = layers.gqa_attention(
            p["attn"], layers.rms_norm(p["ln1"], z), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
            kv_cache=kv_cache, cache_index=cache_index, split=split)
        z = z + attn_out
        z = z + layers.swiglu(p["ffn"], layers.rms_norm(p["ln2"], z), split)
        return h + z, new_kv

    def _mamba_layers(self, params: Zamba2Params):
        """Every mamba layer in order, the ``groups`` then the ``tail``."""
        return list(params.groups) + list(params.tail)

    def hidden(self, params: Zamba2Params, tokens: torch.Tensor, *,
               embeds_override: torch.Tensor | None = None, positions=None,
               split: layers.TPSplit | None = None, fsdp: layers.FSDP | None = None):
        cfg = self.cfg
        b, s = tokens.shape
        if embeds_override is not None:
            h = embeds_override.to(cfg.cdtype)
        else:
            h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, cfg.cdtype, split)
        x0 = h
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        for i, p in enumerate(self._mamba_layers(params)):
            if i < cfg.n_apps * cfg.period and i % cfg.period == 0:
                h, _ = self._shared_block(layers.unit(params.shared, fsdp), h, x0, positions,
                                          split=split)
            h = layers.checkpointed(
                lambda x, p=p: self.mamba.layer(layers.unit(p, fsdp), x, split=split)[0], h,
                cfg.remat)
        return (layers.rms_norm(layers.unit(params.final_norm, fsdp), h),
                torch.zeros((), device=h.device))

    def head(self, params: Zamba2Params, fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """``lm_head`` ``[D, V]``, gathered by ``fsdp`` on a mesh."""
        return layers.unit(params.lm_head, fsdp)

    def unembed(self, params: Zamba2Params, h: torch.Tensor,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        return h @ self.head(params, fsdp).to(h.dtype)

    def forward(self, params: Zamba2Params, tokens: torch.Tensor, *,
                embeds_override: torch.Tensor | None = None, positions=None):
        h, aux = self.hidden(params, tokens, embeds_override=embeds_override,
                             positions=positions)
        return self.unembed(params, h), aux

    # -------------------------------------------------------------- serving

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """The JAX cache: ``x0`` (an unused slot, kept), the shared block's
        K/V ``[n_apps, B, max_len, Hkv, Dh]``, and the mamba layers' conv
        and SSM states."""
        cfg = self.cfg
        kv = (cfg.n_apps, batch, max_len, cfg.n_kv, cfg.d_head)
        return {
            "x0": torch.zeros(batch, 1, cfg.d_model, dtype=dtype, device=device),
            "attn_k": torch.zeros(kv, dtype=dtype, device=device),
            "attn_v": torch.zeros(kv, dtype=dtype, device=device),
            **self.mamba.init_cache(batch, max_len, dtype, device),
        }

    def forward_with_cache(self, params: Zamba2Params, tokens: torch.Tensor, cache: dict,
                           cache_index: int, *, last_only: bool = False, split=None,
                           fsdp: layers.FSDP | None = None):
        """Prefill or decode. The shared block writes its K/V in place at
        ``cache_index`` (the reference's ``inplace`` mode); the mamba states
        are replaced. Returns (logits, cache updated in place). With a
        ``split`` (a mesh) the caches are this rank's shards, read and
        written where they lie, and the parameters its model shards;
        ``fsdp`` gathers each unit where it runs."""
        cfg = self.cfg
        b, s = tokens.shape
        h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, cfg.cdtype, split)
        x0 = h
        positions = cache_index + torch.arange(
            s, dtype=torch.int32, device=tokens.device).expand(b, s)
        for i, p in enumerate(self._mamba_layers(params)):
            if i < cfg.n_apps * cfg.period and i % cfg.period == 0:
                a = i // cfg.period
                h, (ck, cv) = self._shared_block(
                    layers.unit(params.shared, fsdp), h, x0, positions,
                    kv_cache=(cache["attn_k"][a], cache["attn_v"][a]), cache_index=cache_index,
                    split=split)
                cache["attn_k"][a], cache["attn_v"][a] = ck, cv
            h, st = self.mamba.layer(layers.unit(p, fsdp), h,
                                     {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, split)
            cache["conv"][i], cache["ssm"][i] = st["conv"], st["ssm"]
        h = layers.rms_norm(layers.unit(params.final_norm, fsdp), h)
        if last_only:
            h = h[:, -1:]
        logits = self.unembed(params, h, fsdp)
        return (logits if split is None else split.gather(logits, -1)), cache

    # ---------------------------------------------------------------- specs

    def param_pspecs(self, *, fsdp: str | None = "data", tp: str = "model") -> dict:
        """The JAX spec tree (mamba layer leaves stacked), each spec a tuple."""
        mspecs = self.mamba.param_pspecs(fsdp=fsdp, tp=tp)
        layer = mspecs["layers"]
        shared = {
            "in_proj": {"w": P(fsdp, tp)},
            "ln1": {"scale": P(None)},
            "attn": {
                "q": {"w": P(fsdp, tp)},
                "k": {"w": P(fsdp, tp)},
                "v": {"w": P(fsdp, tp)},
                "o": {"w": P(tp, fsdp)},
            },
            "ln2": {"scale": P(None)},
            "ffn": {
                "gate": {"w": P(fsdp, tp)},
                "up": {"w": P(fsdp, tp)},
                "down": {"w": P(tp, fsdp)},
            },
        }
        return {
            "embed": mspecs["embed"],
            "shared": shared,
            "groups": layer,
            "tail": layer,
            "final_norm": {"scale": P(None)},
            "lm_head": mspecs["lm_head"],
        }

    def cache_pspecs(self, *, batch_axes, seq_axis=None, head_axis=None) -> dict:
        return {
            "x0": P(batch_axes, None, None),
            "attn_k": P(None, batch_axes, seq_axis, head_axis, None),
            "attn_v": P(None, batch_axes, seq_axis, head_axis, None),
            "conv": P(None, batch_axes, None, None),
            "ssm": P(None, batch_axes, "model", None, None),
        }
