"""Whisper-style encoder-decoder (audio frontend stubbed): the port of
``repro.models.whisper``.

The conv frontend is a stub: the caller supplies frame embeddings
``[B, T_enc, D]``. A pre-LN transformer encoder (bidirectional, full mask),
and a decoder with causal self-attention (no rope, a KV cache) and
cross-attention to the encoder output; GELU (tanh) MLPs, LayerNorm with bias,
sinusoidal positions in both stacks, the unembedding tied to the embedding.
Its attention passes no ``use_pallas``, so this model launches no kernel, as
in the reference. Under autograd the encoder's layer bodies, and the
decoder's without a cache, are checkpoints as ``cfg.remat`` asks, as the JAX
bodies are. ``param_pspecs`` / ``cache_pspecs`` are the JAX spec trees as
tuples.

**On a mesh** (a :class:`~repro_torch.models.layers.TPSplit`) a rank
computes its share with its model shards: the encoder's self-attention and
the cross-attention are head-parallel (q, k and v by columns with their
biases, o by rows, its partial products summed), the decoder's
self-attention splits as its cache does, the GELU MLPs are Megatron's
(down's bias added once, after the sum), and the tied embedding is
vocab-parallel both ways.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import jax_layout, layers
from repro_torch.models.jax_layout import P

__all__ = ["WhisperConfig", "Whisper", "WhisperParams"]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """The JAX package's whisper config, field for field."""

    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500  # encoder positions (30 s of audio at 50 Hz)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    act_batch_axes: tuple[str, ...] | None = None
    attn_sharding: str | None = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        d, ff = self.d_model, self.d_ff
        attn = 4 * d * d
        mlp = 2 * d * ff + d + ff
        enc = self.n_enc_layers * (attn + mlp + 4 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 6 * d)
        return self.vocab * d + enc + dec + 4 * d

    def active_param_count(self) -> int:
        return self.param_count()


class WhisperParams(nn.Module):
    """``embed`` ``[V, D]``, ``enc_layers[i]`` (``ln1``, ``attn``, ``ln2``,
    ``mlp``), ``enc_final_ln``, ``dec_layers[i]`` (``ln1``, ``self_attn``,
    ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``), ``dec_final_ln``: the JAX
    dict's names."""

    def __init__(self, embed, enc_layers, enc_final_ln, dec_layers, dec_final_ln):
        super().__init__()
        self.embed = layers._param(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_final_ln = enc_final_ln
        self.dec_layers = nn.ModuleList(dec_layers)
        self.dec_final_ln = dec_final_ln


class Whisper(jax_layout.Stacked):
    """Functional model: all methods are static given a config. The JAX
    tree stacks the layer leaves ``[n_layers, ...]``."""

    stacks = {"enc_layers": None, "dec_layers": None}

    def __init__(self, cfg: WhisperConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator | None, *, device=None) -> WhisperParams:
        cfg = self.cfg
        pd = cfg.pdtype
        dev = generator.device if generator is not None else device
        kw = dict(generator=generator, dtype=pd, device=dev)

        def attn():
            return layers.attention_init(cfg.d_model, cfg.n_heads, cfg.n_heads, cfg.d_head,
                                         bias=True, **kw)

        def ln():
            return layers.layer_norm_init(cfg.d_model, pd, dev)

        def mlp():
            return layers.gelu_mlp_init(cfg.d_model, cfg.d_ff, **kw)

        embed = (torch.randn(cfg.vocab, cfg.d_model, generator=generator, device=dev)
                 * 0.02).to(pd)
        enc = [nn.ModuleDict({"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp()})
               for _ in range(cfg.n_enc_layers)]
        dec = [nn.ModuleDict({"ln1": ln(), "self_attn": attn(), "ln_x": ln(),
                              "cross_attn": attn(), "ln2": ln(), "mlp": mlp()})
               for _ in range(cfg.n_dec_layers)]
        return WhisperParams(embed, enc, ln(), dec, ln())

    # ----------------------------------------------------------- components

    def _mha(self, p, q_x, kv_x, mask, split=None):
        """Full multi-head attention with separate query and key-value
        streams; under ``split`` head-parallel (this rank's heads, its
        output product's partials summed)."""
        cfg = self.cfg
        b, sq, _ = q_x.shape
        sk = kv_x.shape[1]
        h = cfg.n_heads
        if split is not None:
            h = split.local(h, "heads")
            same = kv_x is q_x
            q_x = split.enter(q_x)
            kv_x = q_x if same else split.enter(kv_x)
        q = layers.dense(p["q"], q_x).reshape(b, sq, h, cfg.d_head)
        k = layers.dense(p["k"], kv_x).reshape(b, sk, h, cfg.d_head)
        v = layers.dense(p["v"], kv_x).reshape(b, sk, h, cfg.d_head)
        out = layers.attention_scores(q, k, v, mask)
        out = layers.dense(p["o"], out.reshape(b, sq, h * cfg.d_head))
        return out if split is None else split.sum(out)

    def encode(self, params: WhisperParams, frames: torch.Tensor,
               split: layers.TPSplit | None = None,
               fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """``frames [B, T_enc, D]`` (the stub frontend's output) -> the
        encoder output ``[B, T_enc, D]`` (alike on every rank of a
        ``split``); ``fsdp`` gathers each layer inside its body."""
        cfg = self.cfg
        b, t, _ = frames.shape
        pos = torch.arange(t, dtype=torch.int32, device=frames.device).expand(b, t)
        h = frames.to(cfg.cdtype) + layers.sinusoidal_positions(pos, cfg.d_model, cfg.cdtype)
        full = torch.ones(b, 1, t, t, dtype=torch.bool, device=frames.device)

        def body(p, h):
            x = layers.layer_norm(p["ln1"], h)
            h = h + self._mha(p["attn"], x, x, full, split)
            return h + layers.gelu_mlp(p["mlp"], layers.layer_norm(p["ln2"], h), split)

        for p in params.enc_layers:
            h = layers.checkpointed(lambda x, p=p: body(layers.unit(p, fsdp), x), h, cfg.remat)
        return layers.layer_norm(layers.unit(params.enc_final_ln, fsdp), h)

    # --------------------------------------------------------------- decoder

    def _decoder(self, params: WhisperParams, tokens, enc_out, *, cache=None,
                 cache_index=None, last_only: bool = False, split=None, fsdp=None):
        """The decoder up to the final LayerNorm; with a cache, each layer's
        self-attention K/V are written in place at ``cache_index`` (the
        reference's ``inplace`` mode; into this rank's shard with a
        ``split``, under which every layer computes the rank's share)."""
        cfg = self.cfg
        b, s = tokens.shape
        base = cache_index if cache_index is not None else 0
        pos = base + torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        h = layers.embed_lookup(layers.unit(params.embed, fsdp), tokens, cfg.cdtype, split)
        h = h + layers.sinusoidal_positions(pos, cfg.d_model, cfg.cdtype)
        cross = torch.ones(b, 1, s, enc_out.shape[1], dtype=torch.bool, device=h.device)

        def body(p, h, kv=None):
            attn_out, new_kv = layers.gqa_attention(
                p["self_attn"], layers.layer_norm(p["ln1"], h), pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_heads, d_head=cfg.d_head,
                use_rope=False, kv_cache=kv, cache_index=cache_index, split=split)
            h = h + attn_out
            h = h + self._mha(p["cross_attn"], layers.layer_norm(p["ln_x"], h), enc_out, cross,
                              split)
            return h + layers.gelu_mlp(p["mlp"], layers.layer_norm(p["ln2"], h), split), new_kv

        for i, p in enumerate(params.dec_layers):
            if cache is None:
                h = layers.checkpointed(lambda x, p=p: body(layers.unit(p, fsdp), x)[0], h,
                                        cfg.remat)
            else:
                h, new_kv = body(layers.unit(p, fsdp), h, (cache["k"][i], cache["v"][i]))
                cache["k"][i], cache["v"][i] = new_kv
        h = layers.layer_norm(layers.unit(params.dec_final_ln, fsdp), h)
        return h[:, -1:] if last_only else h

    def head(self, params: WhisperParams, fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """The unembedding ``[D, V]``: the tied embedding's transpose,
        gathered by ``fsdp`` on a mesh."""
        return layers.unit(params.embed, fsdp).T

    def unembed(self, params: WhisperParams, h: torch.Tensor,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """The logits (tied); this rank's vocab columns where ``embed`` is
        its model shard."""
        return h @ self.head(params, fsdp).to(h.dtype)

    def hidden(self, params: WhisperParams, tokens: torch.Tensor, *,
               frames: torch.Tensor, positions=None, split: layers.TPSplit | None = None,
               fsdp: layers.FSDP | None = None):
        """(the decoder's hidden states after the final LayerNorm, aux 0)."""
        del positions
        h = self._decoder(params, tokens, self.encode(params, frames, split, fsdp), split=split,
                          fsdp=fsdp)
        return h, torch.zeros((), device=h.device)

    # ----------------------------------------------------------- public API

    def forward(self, params: WhisperParams, tokens: torch.Tensor, *,
                frames: torch.Tensor, positions=None):
        """(frames, decoder tokens) -> (logits, aux 0)."""
        h, aux = self.hidden(params, tokens, frames=frames, positions=positions)
        return self.unembed(params, h), aux

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Self-attention K/V ``[n_dec_layers, B, max_len, H, Dh]``."""
        cfg = self.cfg
        kv = (cfg.n_dec_layers, batch, max_len, cfg.n_heads, cfg.d_head)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}

    def forward_with_cache(self, params: WhisperParams, tokens: torch.Tensor, cache: dict,
                           cache_index: int, *, enc_out: torch.Tensor,
                           last_only: bool = False, split=None, fsdp=None):
        """Prefill or decode against a precomputed encoder output. Returns
        (logits, cache updated in place); with a ``split`` the parameters
        and the cache are this rank's shards and the logits' vocab columns
        are gathered; ``fsdp`` gathers each unit where it runs."""
        h = self._decoder(params, tokens, enc_out, cache=cache, cache_index=cache_index,
                          last_only=last_only, split=split, fsdp=fsdp)
        logits = self.unembed(params, h, fsdp)
        return (logits if split is None else split.gather(logits, -1)), cache

    # ---------------------------------------------------------------- specs

    def param_pspecs(self, *, fsdp: str | None = "data", tp: str = "model") -> dict:
        """The JAX spec tree (layer leaves stacked), each spec a tuple."""
        ln = {"scale": P(None), "bias": P(None)}
        attn = {
            "q": {"w": P(fsdp, tp), "b": P(tp)},
            "k": {"w": P(fsdp, tp), "b": P(tp)},
            "v": {"w": P(fsdp, tp), "b": P(tp)},
            "o": {"w": P(tp, fsdp)},
        }
        mlp = {
            "up": {"w": P(fsdp, tp), "b": P(tp)},
            "down": {"w": P(tp, fsdp), "b": P(None)},
        }
        enc = {"ln1": ln, "attn": attn, "ln2": ln, "mlp": mlp}
        dec = {"ln1": ln, "self_attn": attn, "ln_x": ln,
               "cross_attn": attn, "ln2": ln, "mlp": mlp}
        return {
            "embed": P(tp, fsdp),
            "enc_layers": jax_layout.stacked(enc),
            "enc_final_ln": ln,
            "dec_layers": jax_layout.stacked(dec),
            "dec_final_ln": ln,
        }

    def cache_pspecs(self, *, batch_axes, seq_axis=None, head_axis=None) -> dict:
        spec = P(None, batch_axes, seq_axis, head_axis, None)
        return {"k": spec, "v": spec}
