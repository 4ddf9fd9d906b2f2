"""Mamba2 (SSD, state-space duality) language model: the port of
``repro.models.mamba2``.

The chunked SSD algorithm of Dao & Gu (2024): within a chunk the recurrence
is a masked quadratic form (batched products), across chunks a small
``[H, P, N]`` state is carried by a loop over the chunks. Decode is the O(1)
recurrence. Shapes: B batch, S sequence, H heads, P headdim, N d_state, G
B/C groups; the per-head B/C tensors are never materialised.

Parameters live in :class:`Mamba2Params`, one :class:`Mamba2Layer` a layer
under ``layers``, named as the JAX dict (whose layer leaves stack ``[n_layers]``).
Under autograd ``hidden`` checkpoints each layer body as ``cfg.remat`` asks.
``param_pspecs`` / ``cache_pspecs`` are the JAX spec trees as tuples.

**On a mesh** (a :class:`~repro_torch.models.layers.TPSplit`) a rank holds
the stored shards of the specs: a contiguous block of ``in_proj``'s fused
``[z | xBC | dt]`` columns and of the conv channels, which need not line up
with its heads, and the ``d_inner`` rows of ``gated_norm`` and
``out_proj``, which do (:meth:`Mamba2._split_mixer`). The embedding and
the head are vocab-parallel, as the transformer's.
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import jax_layout, layers
from repro_torch.models.jax_layout import P

__all__ = ["Mamba2Config", "Mamba2", "Mamba2Params", "segsum"]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """The JAX package's mamba2 config, field for field."""

    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 128
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    act_batch_axes: tuple[str, ...] | None = None
    attn_sharding: str | None = None  # accepted for uniform overrides; no-op

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        d, di, h = self.d_model, self.d_inner, self.n_heads
        in_proj = d * (2 * di + 2 * self.n_groups * self.d_state + h)
        conv = self.d_conv * self.conv_dim + self.conv_dim
        per_layer = in_proj + conv + 3 * h + di + di * d + 2 * d
        return self.vocab * d + d + self.n_layers * per_layer

    def active_param_count(self) -> int:
        return self.param_count()


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``segsum(x)[..., i, j] = sum_{k=j+1..i} x_k`` (i >= j), ``-inf``
    above the diagonal."""
    q = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


class Mamba2Params(nn.Module):
    """``embed`` ``[V, D]``, ``layers[i]`` (``norm``, ``in_proj``,
    ``conv_w`` ``[d_conv, conv_dim]``, ``conv_b``, ``A_log``, ``D``,
    ``dt_bias``, ``gated_norm``, ``out_proj``), ``final_norm``, ``lm_head``
    ``[D, V]``. Frozen as made."""

    def __init__(self, embed: torch.Tensor, layer_list: list[nn.Module],
                 final_norm: layers.RMSNorm, lm_head: torch.Tensor):
        super().__init__()
        self.embed = layers._param(embed)
        self.layers = nn.ModuleList(layer_list)
        self.final_norm = final_norm
        self.lm_head = layers._param(lm_head)


class Mamba2Layer(nn.Module):
    """One layer's weights, named as the JAX layer dict: ``norm``,
    ``in_proj``, ``conv_w`` ``[d_conv, conv_dim]``, ``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, ``gated_norm``, ``out_proj``."""

    def __init__(self, norm, in_proj, conv_w, conv_b, A_log, D, dt_bias, gated_norm,
                 out_proj):
        super().__init__()
        self.norm, self.in_proj = norm, in_proj
        self.conv_w, self.conv_b = layers._param(conv_w), layers._param(conv_b)
        self.A_log, self.D = layers._param(A_log), layers._param(D)
        self.dt_bias = layers._param(dt_bias)
        self.gated_norm, self.out_proj = gated_norm, out_proj


def layer_init(cfg: Mamba2Config, *, generator, device) -> Mamba2Layer:
    """One mamba2 layer with the JAX initialisation's distributions:
    ``A_log = log(linspace(1, 16, H))``, ``D = 1``, ``dt`` log-uniform in
    [0.001, 0.1] and ``dt_bias = dt + log(-expm1(-dt))`` (the inverse
    softplus), all f32; the rest in the parameter dtype."""
    pd = cfg.pdtype
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    u = torch.rand(cfg.n_heads, generator=generator, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    conv_w = torch.randn(cfg.d_conv, cfg.conv_dim, generator=generator, device=device)
    return Mamba2Layer(
        norm=layers.rms_norm_init(cfg.d_model, pd, device),
        in_proj=layers.dense_init(cfg.d_model, d_in_proj, generator=generator, dtype=pd,
                                  device=device),
        conv_w=(conv_w / math.sqrt(cfg.d_conv)).to(pd),
        conv_b=torch.zeros(cfg.conv_dim, dtype=pd, device=device),
        A_log=torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, device=device)),
        D=torch.ones(cfg.n_heads, device=device),
        dt_bias=dt + torch.log(-torch.expm1(-dt)),
        gated_norm=layers.rms_norm_init(cfg.d_inner, pd, device),
        out_proj=layers.dense_init(cfg.d_inner, cfg.d_model, generator=generator,
                                   dtype=pd, device=device))


class Mamba2(jax_layout.Stacked):
    """Functional model: all methods are static given a config. The JAX
    tree stacks the layer leaves ``[n_layers, ...]``."""

    stacks = {"layers": None}

    def __init__(self, cfg: Mamba2Config):
        self.cfg = cfg

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator | None, *, device=None) -> Mamba2Params:
        """Weights on ``generator``'s device (``device`` without one:
        ``"meta"`` for shapes alone)."""
        cfg = self.cfg
        pd = cfg.pdtype
        dev = generator.device if generator is not None else device
        embed = (torch.randn(cfg.vocab, cfg.d_model, generator=generator, device=dev)
                 * 0.02).to(pd)
        layer_list = [layer_init(cfg, generator=generator, device=dev)
                      for _ in range(cfg.n_layers)]
        lm_head = (torch.randn(cfg.d_model, cfg.vocab, generator=generator, device=dev)
                   / math.sqrt(cfg.d_model)).to(pd)
        return Mamba2Params(embed, layer_list, layers.rms_norm_init(cfg.d_model, pd, dev),
                            lm_head)

    # ------------------------------------------------------------- SSD core

    def _conv(self, p, xbc: torch.Tensor, conv_state: torch.Tensor | None):
        """Depthwise causal conv over S, seeded by a decode state
        ``[B, d_conv - 1, conv_dim]`` if given. Returns (SiLU of the conv
        output, the new conv state)."""
        xp = self._conv_input(xbc, conv_state)
        pad = self.cfg.d_conv - 1
        return self._conv_window(p.conv_w, p.conv_b, xp), xp[:, xp.shape[1] - pad:]

    def _conv_input(self, xbc: torch.Tensor, conv_state: torch.Tensor | None) -> torch.Tensor:
        """``xbc`` behind ``d_conv - 1`` positions of history: zeros or the
        decode state."""
        if conv_state is None:
            return F.pad(xbc, (0, 0, self.cfg.d_conv - 1, 0))
        return torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)

    def _conv_window(self, w: torch.Tensor, b: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
        """SiLU of the depthwise conv of ``w`` ``[d_conv, C]`` and ``b`` over
        the padded input ``xp`` ``[B, d_conv - 1 + S, C]``."""
        k = self.cfg.d_conv
        s = xp.shape[1] - (k - 1)
        w = w.to(xp.dtype)
        return F.silu(sum(xp[:, i:i + s] * w[i] for i in range(k)) + b.to(xp.dtype))

    def ssd_chunked(self, p, x, b_mat, c_mat, dt, h0=None):
        """Chunked SSD scan. ``x [B, S, H, P]``, ``b_mat`` / ``c_mat``
        ``[B, S, G, N]``, ``dt [B, S, H]`` (softplus'd), ``h0`` an optional
        initial state ``[B, H, P, N]``. Returns (y ``[B, S, H, P]`` in x's
        dtype, the last state ``[B, H, P, N]`` f32)."""
        cfg = self.cfg
        bsz, s, h, pdim = x.shape
        g, n = b_mat.shape[2], b_mat.shape[3]
        hg = h // g
        q = min(cfg.chunk, s)
        while s % q:  # odd lengths: the largest divisor <= chunk
            q -= 1
        nc = s // q

        a = -torch.exp(p.A_log.float())                      # [H]
        dtq = dt.float().reshape(bsz, nc, q, h)
        dtaq = dtq * a                                             # [B, nc, Q, H]
        xq = x.reshape(bsz, nc, q, g, hg, pdim).float()
        bq = b_mat.reshape(bsz, nc, q, g, n).float()
        cq = c_mat.reshape(bsz, nc, q, g, n).float()
        cum = torch.cumsum(dtaq, dim=2)                            # [B, nc, Q, H]

        # Intra-chunk (diagonal blocks): (C B^T * L) contracted with dt x.
        # The scores and the decay mask meet first, as [B, nc, G, Hg, Q, Q];
        # no order may build a [..., Q, Q, P] tensor.
        lmat = torch.exp(segsum(dtaq.permute(0, 1, 3, 2)))        # [B, nc, H, Q, Q]
        scores = torch.einsum("bcign,bcjgn->bcgij", cq, bq)        # [B, nc, G, Q, Q]
        m = scores[:, :, :, None] * lmat.reshape(bsz, nc, g, hg, q, q)
        dtx = xq * dtq.reshape(bsz, nc, q, g, hg)[..., None]       # [B, nc, Q, G, Hg, P]
        y_diag = torch.einsum("bcghij,bcjghp->bcighp", m, dtx)
        del m, lmat

        # Chunk end-states.
        dte = torch.exp(cum[:, :, -1:, :] - cum).reshape(bsz, nc, q, g, hg)
        s_end = torch.einsum("bcjghp,bcjgn->bcghpn", dtx * dte[..., None], bq)

        # Inter-chunk recurrence over the small state.
        total_decay = torch.exp(cum[:, :, -1, :]).reshape(bsz, nc, g, hg, 1, 1)
        h_prev = (torch.zeros(bsz, g, hg, pdim, n, dtype=torch.float32, device=x.device)
                  if h0 is None else h0.reshape(bsz, g, hg, pdim, n).float())
        h_prevs = []
        for c in range(nc):
            h_prevs.append(h_prev)
            h_prev = h_prev * total_decay[:, c] + s_end[:, c]
        h_prevs = torch.stack(h_prevs, dim=1)                      # [B, nc, G, Hg, P, N]

        # Inter-chunk contribution, decayed from each chunk's start.
        decay_in = torch.exp(cum).reshape(bsz, nc, q, g, hg)
        y_off = torch.einsum("bcign,bcghpn->bcighp", cq, h_prevs) * decay_in[..., None]

        y = (y_diag + y_off).reshape(bsz, s, h, pdim)
        y = y + x.float() * p.D.float()[None, None, :, None]
        return y.to(x.dtype), h_prev.reshape(bsz, h, pdim, n)

    def mixer(self, p, u: torch.Tensor, state: dict | None = None,
              split: layers.TPSplit | None = None):
        """One mamba2 block (the caller adds the residual). ``state`` is
        None (full sequence) or ``{"conv", "ssm"}`` (serving). Returns
        (out ``[B, S, D]``, the new state or None). Under ``split``
        :meth:`_split_mixer`."""
        if split is not None:
            return self._split_mixer(p, u, state, split)
        cfg = self.cfg
        bsz, s, _ = u.shape
        zxbcdt = layers.dense(p.in_proj, u)
        z, xbc, dt = torch.split(zxbcdt, [cfg.d_inner, cfg.conv_dim, cfg.n_heads], dim=-1)
        xbc, new_conv = self._conv(p, xbc, None if state is None else state["conv"])
        ng = cfg.n_groups * cfg.d_state
        x, b_mat, c_mat = torch.split(xbc, [cfg.d_inner, ng, ng], dim=-1)
        x = x.reshape(bsz, s, cfg.n_heads, cfg.headdim)
        b_mat = b_mat.reshape(bsz, s, cfg.n_groups, cfg.d_state)
        c_mat = c_mat.reshape(bsz, s, cfg.n_groups, cfg.d_state)
        dt = F.softplus(dt.float() + p.dt_bias.float())      # [B, S, H]

        y, h_last = self.ssd_chunked(p, x, b_mat, c_mat, dt,
                                     h0=None if state is None else state["ssm"])
        y = layers.rms_norm(p.gated_norm, y.reshape(bsz, s, cfg.d_inner) * F.silu(z))
        out = layers.dense(p.out_proj, y)
        if state is None:
            return out, None
        return out, {"conv": new_conv.to(state["conv"].dtype),
                     "ssm": h_last.to(state["ssm"].dtype)}

    def own_groups(self, h_loc: int, r: int) -> slice:
        """The B/C groups read by the ``h_loc`` heads of rank ``r``: whole
        groups, or the one group they lie in. ``ValueError`` where they
        straddle groups."""
        hg = self.cfg.n_heads // self.cfg.n_groups
        if h_loc % hg == 0:
            return slice(r * h_loc // hg, (r + 1) * h_loc // hg)
        if hg % h_loc == 0:
            return slice(r * h_loc // hg, r * h_loc // hg + 1)
        raise ValueError(f"SSM heads: {h_loc} a rank straddle the B/C groups of {hg} heads")

    def _split_mixer(self, p, u: torch.Tensor, state: dict | None, split: layers.TPSplit):
        """:meth:`mixer` on this rank's shards. ``in_proj`` and the conv
        are computed on the columns and channels the rank stores, and each
        is gathered whole over the axis (``split_gather``; its gradient is
        first summed over the ranks, ``split_grad_sum``, since each rank
        reads other columns of it). The rank then steps its own heads (and
        the B/C groups they read) from its ``ssm`` state shard; the gated
        RMSNorm sums its squares over the axis (``partial_sum``) and
        ``out_proj`` is row-parallel (``partial_sum``). The conv state lies
        whole on every rank and is updated whole from the whole pre-conv
        input, so it stays bitwise alike over the axis."""
        cfg = self.cfg
        bsz, s, _ = u.shape
        r, n = split.index
        di, cd, h, pd = cfg.d_inner, cfg.conv_dim, cfg.n_heads, cfg.headdim
        h_loc = split.local(h, "SSM heads")
        heads = slice(r * h_loc, (r + 1) * h_loc)
        cols = slice(r * h_loc * pd, (r + 1) * h_loc * pd)   # the heads' d_inner columns
        zxbcdt = split.enter(split.gather(layers.dense(p.in_proj, split.enter(u)), -1))
        z, xbc, dt = torch.split(zxbcdt, [di, cd, h], dim=-1)
        xp = self._conv_input(xbc, None if state is None else state["conv"])
        c_loc = split.local(cd, "conv channels")
        conv = self._conv_window(p.conv_w, p.conv_b, xp[..., r * c_loc:(r + 1) * c_loc])
        xbc = split.enter(split.gather(conv, -1))
        ng = cfg.n_groups * cfg.d_state
        groups = self.own_groups(h_loc, r)
        b_mat = xbc[..., di:di + ng].reshape(bsz, s, cfg.n_groups, cfg.d_state)[:, :, groups]
        c_mat = xbc[..., di + ng:].reshape(bsz, s, cfg.n_groups, cfg.d_state)[:, :, groups]
        x = xbc[..., cols].reshape(bsz, s, h_loc, pd)
        dt = F.softplus(dt[..., heads].float() + split.own(p.dt_bias, 0).float())
        own = types.SimpleNamespace(A_log=split.own(p.A_log, 0), D=split.own(p.D, 0))
        y, h_last = self.ssd_chunked(own, x, b_mat, c_mat, dt,
                                     h0=None if state is None else state["ssm"])
        # the gated RMSNorm over the whole d_inner: the squares summed over the axis
        g = (y.reshape(bsz, s, h_loc * pd) * F.silu(z[..., cols])).float()
        ms = split.enter(split.sum(torch.sum(g * g, dim=-1, keepdim=True))) * (1.0 / di)
        y = (g * torch.rsqrt(ms + 1e-6) * p.gated_norm.scale.float()).to(u.dtype)
        out = split.sum(layers.dense(p.out_proj, y))
        if state is None:
            return out, None
        pad = cfg.d_conv - 1
        return out, {"conv": xp[:, xp.shape[1] - pad:].to(state["conv"].dtype),
                     "ssm": h_last.to(state["ssm"].dtype)}

    def layer(self, p, h: torch.Tensor, state: dict | None = None,
              split: layers.TPSplit | None = None):
        """``h + mixer(rms_norm(h))``, and the layer's new state."""
        out, new_state = self.mixer(p, layers.rms_norm(p.norm, h), state, split)
        return h + out, new_state

    # --------------------------------------------------------------- forward

    def hidden(self, params: Mamba2Params, tokens: torch.Tensor, *,
               embeds_override: torch.Tensor | None = None, positions=None,
               split: layers.TPSplit | None = None, fsdp: layers.FSDP | None = None):
        """Full-sequence forward up to the final norm: (h, aux loss 0). SSMs
        carry position in their state, so ``positions`` is unused. Under
        ``split`` the parameters are this rank's model shards; ``fsdp`` (on
        a mesh) gathers each unit where it runs."""
        del positions
        if embeds_override is not None:
            h = embeds_override.to(self.cfg.cdtype)
        else:
            h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, self.cfg.cdtype,
                                    split)
        for p in params.layers:
            h = layers.checkpointed(
                lambda x, p=p: self.layer(layers.unit(p, fsdp), x, split=split)[0], h,
                self.cfg.remat)
        return (layers.rms_norm(layers.unit(params.final_norm, fsdp), h),
                torch.zeros((), device=h.device))

    def head(self, params: Mamba2Params, fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """``lm_head`` ``[D, V]``, gathered by ``fsdp`` on a mesh."""
        return layers.unit(params.lm_head, fsdp)

    def unembed(self, params: Mamba2Params, h: torch.Tensor,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """The logits; this rank's vocab columns where ``lm_head`` is its
        model shard."""
        return h @ self.head(params, fsdp).to(h.dtype)

    def forward(self, params: Mamba2Params, tokens: torch.Tensor, *,
                embeds_override: torch.Tensor | None = None, positions=None):
        h, aux = self.hidden(params, tokens, embeds_override=embeds_override,
                             positions=positions)
        return self.unembed(params, h), aux

    # -------------------------------------------------------------- serving

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """The conv state ``[L, B, d_conv - 1, conv_dim]`` in ``dtype`` and
        the SSM state ``[L, B, H, P, N]`` in f32: O(1) in the sequence."""
        cfg = self.cfg
        del max_len
        return {
            "conv": torch.zeros(cfg.n_layers, batch, cfg.d_conv - 1, cfg.conv_dim,
                                dtype=dtype, device=device),
            "ssm": torch.zeros(cfg.n_layers, batch, cfg.n_heads, cfg.headdim, cfg.d_state,
                               dtype=torch.float32, device=device),
        }

    def forward_with_cache(self, params: Mamba2Params, tokens: torch.Tensor, cache: dict,
                           cache_index: int, *, last_only: bool = False, split=None,
                           fsdp: layers.FSDP | None = None):
        """Prefill or decode: the state carries all history, so
        ``cache_index`` is unused. Returns (logits, cache updated in place);
        with a ``split`` the parameters are this rank's model shards, the
        SSM state its heads, and the logits' vocab columns are gathered;
        ``fsdp`` gathers each unit where it runs."""
        del cache_index
        h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, self.cfg.cdtype, split)
        for i, p in enumerate(params.layers):
            h, st = self.layer(layers.unit(p, fsdp), h,
                               {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, split)
            cache["conv"][i], cache["ssm"][i] = st["conv"], st["ssm"]
        h = layers.rms_norm(layers.unit(params.final_norm, fsdp), h)
        if last_only:
            h = h[:, -1:]
        logits = self.unembed(params, h, fsdp)
        return (logits if split is None else split.gather(logits, -1)), cache

    # ---------------------------------------------------------------- specs

    def param_pspecs(self, *, fsdp: str | None = "data", tp: str = "model") -> dict:
        """The JAX spec tree (layer leaves stacked), each spec a tuple."""
        layer = {
            "norm": {"scale": P(None)},
            "in_proj": {"w": P(fsdp, tp)},
            "conv_w": P(None, tp),
            "conv_b": P(tp),
            "A_log": P(None),
            "D": P(None),
            "dt_bias": P(None),
            "gated_norm": {"scale": P(tp)},
            "out_proj": {"w": P(tp, fsdp)},
        }
        return {
            "embed": P(tp, fsdp),
            "layers": jax_layout.stacked(layer),
            "final_norm": {"scale": P(None)},
            "lm_head": P(fsdp, tp),
        }

    def cache_pspecs(self, *, batch_axes, seq_axis=None, head_axis=None) -> dict:
        """The SSM state's heads over the model axis, the batch over
        ``batch_axes`` (an SSM cache has no sequence axis)."""
        del seq_axis, head_axis
        return {
            "conv": P(None, batch_axes, None, None),
            "ssm": P(None, batch_axes, "model", None, None),
        }
