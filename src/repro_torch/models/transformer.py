"""Decoder-only transformer (dense / GQA / SWA / MoE): the port of
``repro.models.transformer``.

``TransformerConfig`` is the JAX config field for field. ``Transformer``
holds a config and, like the JAX class, keeps no weights: ``init_params``
draws them into a :class:`TransformerParams` module (or
:func:`params_from_numpy` carries a JAX parameter tree over), and
``hidden`` / ``forward`` / ``forward_with_cache`` take it as their first
argument. Layers run in a Python loop where JAX scans over groups of
``group_size`` sub-layers (the MoE interleave: the last sub-layer of each
group is the MoE one); the per-layer window sizes and rope bases stay data
(``window_array`` / ``theta_array``, on the host, so reading one costs no
device synchronisation).

Training: the weights are frozen as drawn; ``params.requires_grad_()``
(``nn.Module``'s own switch) makes them trainable, and ``hidden`` then
honours ``cfg.remat`` around each layer as the JAX group body does
(:func:`_dots_policy` says what ``"dots"`` keeps). ``to_jax_layout`` /
``from_jax_layout`` (:class:`~repro_torch.models.jax_layout.Stacked`) map
the parameters (or anything keyed by their names, such as optimizer
moments) to the JAX tree and back, so checkpoints of training state cross
between the packages. ``param_pspecs`` / ``cache_pspecs`` are the JAX spec
trees as tuples; the trainer on a mesh shards its state by them.

Under a compute split (``split``, a :class:`~repro_torch.models.layers.TPSplit`
whose ``attn`` is set: the only split this class takes) ``params`` holds
this rank's model shards: ``hidden`` and ``forward_with_cache`` embed by
vocab rows, each sub-layer's attention, MLP or MoE splits its products
over the model axis (each split sub-block enters the split region once),
and ``unembed`` gives this rank's vocab columns. Remat recomputes a
layer's collectives in the backward, alike on every rank. Serving
(``forward_with_cache``) runs the same layers with the cache split too
and gathers the logits' vocab columns once a call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import jax_layout, layers
from repro_torch.models.jax_layout import P
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init, moe_pspecs

__all__ = ["TransformerConfig", "Transformer", "TransformerParams", "params_from_numpy"]


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
    moe: MoEConfig | None = None
    tie_embeddings: bool = False
    embed_scale: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    act_batch_axes: tuple[str, ...] | None = None
    attn_sharding: str | None = None
    use_pallas_attention: bool = False

    def __post_init__(self) -> None:
        if self.n_layers % self.group_size != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by the "
                f"MoE interleave group {self.group_size}")
        if self.n_heads % self.n_kv != 0:
            raise ValueError(f"{self.name}: n_heads must divide by n_kv")

    @property
    def group_size(self) -> int:
        return self.moe.interleave if self.moe is not None else 1

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    def sub_is_moe(self, i: int) -> bool:
        """Within a group, the *last* sub-layer is the MoE one."""
        return self.moe is not None and i == self.group_size - 1

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
        """Total parameters (for 6ND roofline accounting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2
        per_dense = attn + 3 * d * ff + 2 * d
        n = v * d + d  # embed + final norm
        if not self.tie_embeddings:
            n += d * v
        if self.moe is None:
            return n + self.n_layers * per_dense
        g = self.group_size
        moe_ffn = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        if self.moe.shared_expert:
            moe_ffn += 3 * d * self.moe.d_ff
        per_group = (g - 1) * per_dense + (attn + moe_ffn + 2 * d)
        return n + self.n_groups * per_group

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2
        per_dense = attn + 3 * d * self.d_ff + 2 * d
        active_ffn = self.moe.top_k * 3 * d * self.moe.d_ff
        if self.moe.shared_expert:
            active_ffn += 3 * d * self.moe.d_ff
        per_moe = attn + active_ffn + 2 * d
        g = self.group_size
        n = self.vocab * d + d + (0 if self.tie_embeddings else d * self.vocab)
        return n + self.n_groups * ((g - 1) * per_dense + per_moe)


_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: the JAX ``checkpoint_dots_with_no_batch_dims``.

    Saves the outputs of ``aten.mm`` and ``aten.addmm``, the products
    without a batch dimension: every weight product (``x @ w`` on a
    ``[B, S, D]`` activation folds to ``mm`` of ``[B*S, D]``). Everything
    else is recomputed in the backward, attention's batched products
    (``aten.bmm``) and the elementwise work included."""
    if op in _DOTS_SAVED:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# torch.utils.checkpoint arguments per cfg.remat ('none' checkpoints nothing).
_REMAT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts, _dots_policy)},
}


class TransformerParams(nn.Module):
    """The weights: ``embed`` ``[V, D]``, ``layers[i]`` (a ``ModuleDict`` of
    ``attn``, ``ffn`` or, on an MoE sub-layer, ``moe``, and for RMS norms
    ``ln1`` / ``ln2``; layer ``i`` is sub-layer ``i % group_size`` of group
    ``i // group_size``), ``final_norm``
    and, untied, ``lm_head`` ``[D, V]``. Frozen as made; training calls
    ``requires_grad_()``."""

    def __init__(self, embed: torch.Tensor, layer_list: list[nn.ModuleDict],
                 final_norm: layers.RMSNorm | None, lm_head: torch.Tensor | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layer_list)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)


class Transformer(jax_layout.Stacked):
    """Functional model: all methods are static given a config."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    @property
    def stacks(self) -> dict:
        """The JAX tree stacks layer ``i`` as sub-layer ``i % group_size`` of
        group ``i // group_size`` (``layers.sub_j``)."""
        return {"layers": self.cfg.group_size}

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator | None, *,
                    device=None) -> TransformerParams:
        """Weights on ``generator``'s device, drawn with the JAX package's
        distributions and scales (embedding N(0, 0.02^2), dense N(0, 1/d_in),
        lm_head N(0, 1/d_model), zero biases, unit norm scales). Without a
        generator they go to ``device``: ``"meta"`` gives the shapes and
        dtypes alone (the JAX package's ``eval_shape``)."""
        cfg = self.cfg
        pd = cfg.pdtype
        dev = generator.device if generator is not None else device
        embed = (torch.randn(cfg.vocab, cfg.d_model, generator=generator, device=dev)
                 * 0.02).to(pd)
        layer_list = []
        for i in range(cfg.n_layers):
            sub = nn.ModuleDict({"attn": layers.attention_init(
                cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                generator=generator, bias=cfg.qkv_bias, dtype=pd, device=dev)})
            if cfg.sub_is_moe(i % cfg.group_size):
                sub["moe"] = moe_init(cfg.d_model, cfg.moe, generator=generator, dtype=pd,
                                      device=dev)
            else:
                sub["ffn"] = layers.swiglu_init(cfg.d_model, cfg.d_ff, generator=generator,
                                                dtype=pd, device=dev)
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

    def _final_norm(self, params: TransformerParams, h: torch.Tensor,
                    fsdp: layers.FSDP | None = None) -> torch.Tensor:
        if self.cfg.norm == "rms":
            return layers.rms_norm(layers.unit(params.final_norm, fsdp), h)
        return layers.nonparam_layer_norm(h)

    # ------------------------------------------------------------- layers

    def _layer(self, sub, h, positions, theta, window, kv=None, cache_index=None,
               cache_mode="inplace", split=None):
        """One sub-layer of the JAX group body: (h, its MoE aux loss or None
        for a dense sub-layer, its K/V). ``split``: the compute split (and,
        serving, the cache split)."""
        cfg = self.cfg
        attn_out, kv_i = layers.gqa_attention(
            sub["attn"], self._norm(sub, "ln1", h), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
            rope_theta=theta, window=window,
            kv_cache=kv, cache_index=cache_index, cache_mode=cache_mode,
            use_pallas=cfg.use_pallas_attention, split=split)
        h = h + attn_out
        hn = self._norm(sub, "ln2", h)
        if "moe" in sub:
            y, aux = moe_apply(sub["moe"], hn, cfg.moe, split)
        else:
            y, aux = layers.swiglu(sub["ffn"], hn, split), None
        return h + y, aux, kv_i

    def _layers(self, params, h, positions, *, cache=None, cache_index=None,
                cache_mode="inplace", split=None, fsdp=None):
        """Every layer in order: (h, the summed MoE aux loss, and with a cache
        each layer's new K/V: fresh slices, or the whole updated cache in
        ``inplace`` mode). Without a cache and under autograd, each layer is
        a checkpoint as ``cfg.remat`` asks. On a mesh each layer is
        gathered by ``fsdp`` where it runs, inside its checkpoint."""
        cfg = self.cfg
        g = cfg.group_size
        windows, thetas = cfg.window_array(), cfg.theta_array()
        remat = cfg.remat if cache is None and torch.is_grad_enabled() else "none"
        aux = torch.zeros((), device=h.device)
        new_kv = []
        for i, sub in enumerate(params.layers):
            theta, window = thetas[i // g, i % g], int(windows[i // g, i % g])
            if remat != "none":
                h, aux_i = torch.utils.checkpoint.checkpoint(
                    lambda x, sub=sub, theta=theta, window=window: self._layer(
                        layers.unit(sub, fsdp), x, positions, theta, window, split=split)[:2],
                    h, use_reentrant=False, **_REMAT[remat])
                aux = aux if aux_i is None else aux + aux_i
                continue
            kv = None
            if cache is not None:
                c = cache[f"sub_{i % g}"]
                kv = (c["k"][i // g], c["v"][i // g])
            h, aux_i, kv_i = self._layer(layers.unit(sub, fsdp), h, positions, theta, window,
                                         kv, cache_index, cache_mode, split)
            aux = aux if aux_i is None else aux + aux_i
            new_kv.append(kv_i)
        return h, aux, new_kv

    # --------------------------------------------------------------- forward

    def _embed(self, params: TransformerParams, tokens: torch.Tensor,
               split: layers.TPSplit | None = None,
               fsdp: layers.FSDP | None = None) -> torch.Tensor:
        h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, self.cfg.cdtype, split)
        if self.cfg.embed_scale:
            h = h * math.sqrt(self.cfg.d_model)
        return h

    def head(self, params: TransformerParams, fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """The unembedding ``[D, V]`` (the embedding's transpose where
        tied), gathered by ``fsdp`` on a mesh; this rank's vocab columns
        where ``params`` are its model shards."""
        if self.cfg.tie_embeddings:
            return layers.unit(params.embed, fsdp).T
        return layers.unit(params.lm_head, fsdp)

    def unembed(self, params: TransformerParams, h: torch.Tensor,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """The logits; this rank's vocab columns where ``params`` are its
        model shards (the embedding's rows or the head's columns)."""
        return h @ self.head(params, fsdp).to(h.dtype)

    def hidden(self, params: TransformerParams, tokens: torch.Tensor, *,
               embeds_override: torch.Tensor | None = None,
               positions: torch.Tensor | None = None,
               split: layers.TPSplit | None = None, fsdp: layers.FSDP | None = None):
        """Full-sequence forward up to the final norm. ``embeds_override``
        ``[B, S, D]`` replaces the token embeddings (the VLM's spliced
        input). Returns (h [B, S, D], MoE aux loss; 0 for dense layers).
        ``fsdp``: on a mesh, the gather point of each unit."""
        b, s = tokens.shape
        if embeds_override is not None:
            h = embeds_override.to(self.cfg.cdtype)
        else:
            h = self._embed(params, tokens, split, fsdp)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        h, aux, _ = self._layers(params, h, positions, split=split, fsdp=fsdp)
        return self._final_norm(params, h, fsdp), aux

    def forward(self, params: TransformerParams, tokens: torch.Tensor, *,
                embeds_override: torch.Tensor | None = None,
                positions: torch.Tensor | None = None):
        """Full-sequence forward. Returns (logits [B, S, V], aux loss)."""
        h, aux = self.hidden(params, tokens, embeds_override=embeds_override,
                             positions=positions)
        return self.unembed(params, h), aux

    # ------------------------------------------------------------- serving

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """``{"sub_i": {"k", "v"}}`` for each sub-layer of a group, each
        ``[n_groups, B, max_len, Hkv, Dh]`` zeros: the JAX cache layout."""
        cfg = self.cfg
        shape = (cfg.n_groups, batch, max_len, cfg.n_kv, cfg.d_head)
        return {f"sub_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device)}
                for i in range(cfg.group_size)}

    def forward_with_cache(self, params: TransformerParams, tokens: torch.Tensor,
                           cache: dict, cache_index: int, *, last_only: bool = False,
                           embeds_override: torch.Tensor | None = None,
                           split: layers.TPSplit | None = None,
                           fsdp: layers.FSDP | None = None):
        """Prefill (``S`` > 1) or decode (``S`` = 1) against ``cache``.

        Returns (logits, cache). The cache is updated in place: the fresh
        K/V of every layer are merged into it at ``cache_index`` with one copy
        per sub-layer and call (JAX does the same with one dynamic update of
        a donated buffer). An MoE layer's capacity follows this call's
        ``S``, as in the reference. With a ``split`` (serving on a mesh) the
        parameters are this rank's model shards and the cache its shard:
        each layer computes its share and attends where the cache lies, only
        the positions or heads it holds are written, and the last
        positions' vocab columns are gathered into whole logits; ``fsdp``
        gathers each unit where it runs."""
        cfg = self.cfg
        b, s = tokens.shape
        if embeds_override is not None:
            h = embeds_override.to(cfg.cdtype)
        else:
            h = self._embed(params, tokens, split, fsdp)
        positions = cache_index + torch.arange(
            s, dtype=torch.int32, device=tokens.device).expand(b, s)
        if s > 1:
            cache_mode = "fresh_only"
        elif cfg.attn_sharding == "seq":
            cache_mode = "inplace"
        else:
            cache_mode = "append_slice"
        h, _, new_kv = self._layers(params, h, positions, cache=cache,
                                    cache_index=cache_index, cache_mode=cache_mode, split=split,
                                    fsdp=fsdp)
        g = cfg.group_size
        for i in range(g):
            for j, name in enumerate(("k", "v")):
                buf = cache[f"sub_{i}"][name]
                fresh = torch.stack([kv[j] for kv in new_kv[i::g]])
                if cache_mode == "inplace":
                    buf.copy_(fresh)  # the layers returned whole updated caches
                elif split is not None and split.kv == "seq":
                    layers.write_positions(buf, fresh.to(buf.dtype), cache_index, 2, split)
                else:
                    buf[:, :, cache_index:cache_index + s] = fresh.to(buf.dtype)
        h = self._final_norm(params, h, fsdp)
        if last_only:
            h = h[:, -1:]
        logits = self.unembed(params, h, fsdp)
        return (logits if split is None else split.gather(logits, -1)), cache

    # -------------------------------------------------------------- specs

    def param_pspecs(self, *, fsdp: str | None = "data", tp: str = "model") -> dict:
        """The JAX package's spec tree, keyed like its parameters (layer
        leaves stacked: a leading ``None``), each spec a tuple
        (:func:`~repro_torch.models.jax_layout.P`)."""
        cfg = self.cfg
        attn = {
            "q": {"w": P(fsdp, tp)},
            "k": {"w": P(fsdp, tp)},
            "v": {"w": P(fsdp, tp)},
            "o": {"w": P(tp, fsdp)},
        }
        if cfg.qkv_bias:
            for name in ("q", "k", "v"):
                attn[name]["b"] = P(tp)
        sub_dense = {
            "attn": attn,
            "ffn": {
                "gate": {"w": P(fsdp, tp)},
                "up": {"w": P(fsdp, tp)},
                "down": {"w": P(tp, fsdp)},
            },
        }
        sub_moe = {
            "attn": attn,
            "moe": moe_pspecs(cfg.moe, fsdp, tp) if cfg.moe else {},
        }
        if cfg.norm == "rms":
            for t in (sub_dense, sub_moe):
                t["ln1"] = {"scale": P(None)}
                t["ln2"] = {"scale": P(None)}
        group = {
            f"sub_{i}": (sub_moe if cfg.sub_is_moe(i) else sub_dense)
            for i in range(cfg.group_size)
        }
        specs = {"embed": P(tp, fsdp), "layers": jax_layout.stacked(group)}
        if cfg.norm == "rms":
            specs["final_norm"] = {"scale": P(None)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = P(fsdp, tp)
        return specs

    def cache_pspecs(self, *, batch_axes, seq_axis: str | None = None,
                     head_axis: str | None = None) -> dict:
        """Cache specs, ``[G, B, S, Hkv, Dh]`` a sub-layer's ``k`` / ``v``."""
        spec = P(None, batch_axes, seq_axis, head_axis, None)
        return {f"sub_{i}": {"k": spec, "v": spec} for i in range(self.cfg.group_size)}

    def _attn_pspecs(self):
        """The JAX attention-activation pins ``(q_spec, kv_spec)``, or None:
        head-parallel, or context-parallel (queries split by sequence, K
        and V whole). The port's training split follows the same choice
        (:class:`~repro_torch.models.layers.TPSplit`'s ``attn``); it takes
        no pin, since a rank computes only its share."""
        cfg = self.cfg
        if cfg.act_batch_axes is None or cfg.attn_sharding is None:
            return None
        b = cfg.act_batch_axes
        if cfg.attn_sharding == "heads":
            spec = P(b, None, "model", None)
            return (spec, spec)
        return (P(b, "model", None, None), P(b, None, None, None))



def params_from_numpy(cfg: TransformerConfig, tree: Mapping, device=None) -> TransformerParams:
    """The JAX parameter tree (numpy arrays; per-layer leaves with a leading
    ``[n_groups]`` axis under ``layers.sub_i``) as the port's parameters of
    ``cfg`` (:meth:`Transformer.params_from_numpy`)."""
    return Transformer(cfg).params_from_numpy(tree, device)
