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
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
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
        cfg = self.cfg
        w = p.conv_w.to(xbc.dtype)
        pad = cfg.d_conv - 1
        if conv_state is None:
            xp = F.pad(xbc, (0, 0, pad, 0))
        else:
            xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        s = xbc.shape[1]
        out = sum(xp[:, i:i + s] * w[i] for i in range(cfg.d_conv)) + p.conv_b.to(xbc.dtype)
        return F.silu(out), xp[:, xp.shape[1] - pad:]

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
        (out ``[B, S, D]``, the new state or None).

        With a ``split`` whose SSM axis has an extent above 1 (serving on a
        mesh), ``state["ssm"]`` holds this rank's heads only: ``in_proj``
        and the conv run whole (the conv state is not split), the rank steps
        its own heads' state (:meth:`_own_heads`), and the heads' ``y`` is
        gathered over the axis in rank order before the gated norm."""
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

        if state is not None and split is not None and split.ssm_block()[1] > 1:
            y, h_last = self._own_heads(p, x, b_mat, c_mat, dt, state["ssm"], split)
        else:
            y, h_last = self.ssd_chunked(p, x, b_mat, c_mat, dt,
                                         h0=None if state is None else state["ssm"])
        y = layers.rms_norm(p.gated_norm, y.reshape(bsz, s, cfg.d_inner) * F.silu(z))
        out = layers.dense(p.out_proj, y)
        if state is None:
            return out, None
        return out, {"conv": new_conv.to(state["conv"].dtype),
                     "ssm": h_last.to(state["ssm"].dtype)}

    def _own_heads(self, p, x, b_mat, c_mat, dt, h0, split: layers.TPSplit):
        """:meth:`ssd_chunked` on this rank's heads (and the B/C groups they
        read), from its state shard ``h0``: (y of every head, gathered over
        the SSM axis as ``"gather_heads"``; this rank's last state)."""
        r, n = split.ssm_block()
        h, g = self.cfg.n_heads, self.cfg.n_groups
        if h % n:
            raise ValueError(f"{h} SSM heads do not divide over model (extent {n})")
        h_loc, hg = h // n, h // g
        heads = slice(r * h_loc, (r + 1) * h_loc)
        if h_loc % hg == 0:      # whole groups
            groups = slice(r * h_loc // hg, (r + 1) * h_loc // hg)
        elif hg % h_loc == 0:    # within one group
            groups = slice(r * h_loc // hg, r * h_loc // hg + 1)
        else:
            raise ValueError(f"{h_loc} heads a rank straddle the B/C groups of {hg} heads")
        own = types.SimpleNamespace(A_log=p.A_log[heads], D=p.D[heads])
        y, h_last = self.ssd_chunked(own, x[:, :, heads], b_mat[:, :, groups],
                                     c_mat[:, :, groups], dt[:, :, heads], h0=h0)
        y = comm.all_gather(y, split.mesh, "model", dim=2, count_as="gather_heads")
        return y, h_last

    def layer(self, p, h: torch.Tensor, state: dict | None = None,
              split: layers.TPSplit | None = None):
        """``h + mixer(rms_norm(h))``, and the layer's new state."""
        out, new_state = self.mixer(p, layers.rms_norm(p.norm, h), state, split)
        return h + out, new_state

    # --------------------------------------------------------------- forward

    def hidden(self, params: Mamba2Params, tokens: torch.Tensor, *,
               embeds_override: torch.Tensor | None = None, positions=None):
        """Full-sequence forward up to the final norm: (h, aux loss 0). SSMs
        carry position in their state, so ``positions`` is unused."""
        del positions
        h = params.embed[tokens].to(self.cfg.cdtype)
        if embeds_override is not None:
            h = embeds_override.to(self.cfg.cdtype)
        for p in params.layers:
            h = layers.checkpointed(lambda x, p=p: self.layer(p, x)[0], h, self.cfg.remat)
        return layers.rms_norm(params.final_norm, h), torch.zeros((), device=h.device)

    def unembed(self, params: Mamba2Params, h: torch.Tensor) -> torch.Tensor:
        return h @ params.lm_head.to(h.dtype)

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
                           cache_index: int, *, last_only: bool = False, split=None):
        """Prefill or decode: the state carries all history, so
        ``cache_index`` is unused. Returns (logits, cache updated in place);
        with a ``split`` the SSM state is this rank's heads."""
        del cache_index
        h = params.embed[tokens].to(self.cfg.cdtype)
        for i, p in enumerate(params.layers):
            h, st = self.layer(p, h, {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, split)
            cache["conv"][i], cache["ssm"][i] = st["conv"], st["ssm"]
        h = layers.rms_norm(params.final_norm, h)
        if last_only:
            h = h[:, -1:]
        return self.unembed(params, h), cache

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
