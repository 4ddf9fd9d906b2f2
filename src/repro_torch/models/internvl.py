"""InternVL2-style VLM, an InternLM2 language backbone with a stubbed ViT
frontend: the port of ``repro.models.internvl``.

The InternViT frontend is a stub: the caller supplies patch embeddings
``[B, n_patches, d_vit]`` (what the vision tower and pixel shuffle would
give). The MLP connector (fc1, tanh-GELU, fc2) projects them, and they
overwrite the first ``n_patches`` token positions of the backbone's input.
The backbone is the port's :class:`Transformer`, so with
``use_pallas_attention`` its full-sequence forward runs the
``flash_attention`` kernel. ``param_pspecs`` / ``cache_pspecs`` are the
JAX spec trees as tuples (the backbone's under ``lm``). Under a compute
split (training, and serving on a mesh) the backbone splits as the
transformer does, and the connector's ``fc2`` (``P(fsdp, tp)``) gives this
rank's columns, gathered over the model axis before the splice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import jax_layout, layers
from repro_torch.models.jax_layout import P
from repro_torch.models.transformer import Transformer, TransformerConfig, TransformerParams

__all__ = ["InternVLConfig", "InternVL", "InternVLParams"]


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    """The JAX package's InternVL config, field for field."""

    name: str
    backbone: TransformerConfig
    d_vit: int = 1024       # stubbed patch-embedding width
    n_patches: int = 256    # image tokens per sample

    @property
    def vocab(self) -> int:
        return self.backbone.vocab

    @property
    def n_layers(self) -> int:
        return self.backbone.n_layers

    @property
    def pdtype(self) -> torch.dtype:
        return self.backbone.pdtype

    @property
    def cdtype(self) -> torch.dtype:
        return self.backbone.cdtype

    def param_count(self) -> int:
        d = self.backbone.d_model
        connector = self.d_vit * d + d * d + 2 * d  # 2-layer MLP connector
        return self.backbone.param_count() + connector

    def active_param_count(self) -> int:
        return self.param_count() - self.backbone.param_count() \
            + self.backbone.active_param_count()


class InternVLParams(nn.Module):
    """``lm`` (the backbone's :class:`TransformerParams`) and ``connector``
    (``fc1`` ``[d_vit, D]``, ``fc2`` ``[D, D]``, with biases)."""

    def __init__(self, lm: TransformerParams, connector: nn.ModuleDict):
        super().__init__()
        self.lm = lm
        self.connector = connector


class InternVL(jax_layout.Stacked):
    """Functional model: all methods are static given a config."""

    def __init__(self, cfg: InternVLConfig):
        self.cfg = cfg
        self.lm = Transformer(cfg.backbone)

    @property
    def stacks(self) -> dict:
        """The JAX tree: ``lm`` (the backbone's, stacked as the backbone's)
        and ``connector``."""
        return {"lm." + k: g for k, g in self.lm.stacks.items()}

    def init_params(self, generator: torch.Generator | None, *, device=None) -> InternVLParams:
        dev = generator.device if generator is not None else device
        d = self.cfg.backbone.d_model
        kw = dict(generator=generator, bias=True, dtype=self.cfg.pdtype, device=dev)
        return InternVLParams(
            self.lm.init_params(generator, device=dev),
            nn.ModuleDict({"fc1": layers.dense_init(self.cfg.d_vit, d, **kw),
                           "fc2": layers.dense_init(d, d, **kw)}))

    def _splice(self, params: InternVLParams, tokens: torch.Tensor,
                patch_embeds: torch.Tensor, split: layers.TPSplit | None = None,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """Project the patch embeddings and overwrite the first
        ``n_patches`` positions of the token embeddings."""
        h = layers.embed_lookup(layers.unit(params.lm.embed, fsdp), tokens, self.cfg.cdtype,
                                split)
        c = layers.unit(params.connector, fsdp)
        a = F.gelu(layers.dense(c["fc1"], patch_embeds.to(self.cfg.cdtype)), approximate="tanh")
        if split is None:
            img = layers.dense(c["fc2"], a)
        else:  # this rank's columns of fc2, gathered
            img = split.gather(layers.dense(c["fc2"], split.enter(a)), -1)
        n_p = self.cfg.n_patches
        return torch.cat([img[:, :n_p], h[:, n_p:]], dim=1)

    def hidden(self, params: InternVLParams, tokens: torch.Tensor, *,
               patch_embeds: torch.Tensor, positions=None,
               split: layers.TPSplit | None = None, fsdp: layers.FSDP | None = None):
        h0 = self._splice(params, tokens, patch_embeds, split, fsdp)
        return self.lm.hidden(params.lm, tokens, embeds_override=h0, positions=positions,
                              split=split, fsdp=fsdp)

    def head(self, params: InternVLParams, fsdp: layers.FSDP | None = None) -> torch.Tensor:
        return self.lm.head(params.lm, fsdp)

    def unembed(self, params: InternVLParams, h: torch.Tensor,
                fsdp: layers.FSDP | None = None) -> torch.Tensor:
        return self.lm.unembed(params.lm, h, fsdp)

    def forward(self, params: InternVLParams, tokens: torch.Tensor, *,
                patch_embeds: torch.Tensor, positions=None):
        h, aux = self.hidden(params, tokens, patch_embeds=patch_embeds, positions=positions)
        return self.unembed(params, h), aux

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        return self.lm.init_cache(batch, max_len, dtype, device)

    def forward_with_cache(self, params: InternVLParams, tokens: torch.Tensor, cache: dict,
                           cache_index: int, *, patch_embeds: torch.Tensor | None = None,
                           last_only: bool = False, split=None, fsdp=None):
        """Prefill may carry image tokens (``patch_embeds``); decode steps
        never do. ``split``: the compute and cache split on a mesh (the
        connector's included); ``fsdp`` gathers each unit where it runs."""
        h0 = None if patch_embeds is None else self._splice(params, tokens, patch_embeds, split,
                                                             fsdp)
        return self.lm.forward_with_cache(params.lm, tokens, cache, cache_index,
                                          last_only=last_only, embeds_override=h0, split=split,
                                          fsdp=fsdp)

    # ---------------------------------------------------------------- specs

    def param_pspecs(self, *, fsdp: str | None = "data", tp: str = "model") -> dict:
        return {
            "lm": self.lm.param_pspecs(fsdp=fsdp, tp=tp),
            "connector": {
                "fc1": {"w": P(None, fsdp), "b": P(None)},
                "fc2": {"w": P(fsdp, tp), "b": P(tp)},
            },
        }

    def cache_pspecs(self, *, batch_axes, seq_axis=None, head_axis=None) -> dict:
        return self.lm.cache_pspecs(batch_axes=batch_axes, seq_axis=seq_axis,
                                    head_axis=head_axis)
