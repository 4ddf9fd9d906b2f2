"""Shared plumbing for architecture configs: shapes, bundles, input specs.

The port of ``repro.configs.common``. Where the JAX package describes an
input by a ``jax.ShapeDtypeStruct``, the port uses a tensor on the ``meta``
device: a shape and a dtype, no storage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import layers

__all__ = ["ShapeSpec", "SHAPES", "Bundle", "lm_input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeSpec":
        """Smoke-test scale: same kind, tiny extent."""
        return ShapeSpec(self.name, self.kind,
                         seq_len=min(self.seq_len, 32),
                         global_batch=min(self.global_batch, 2))


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Bundle:
    """What every architecture exposes: its model (``init_params``,
    ``hidden`` / ``unembed`` / ``forward``, cache methods) and config.

    ``extra_inputs`` maps additional forward kwargs (stub frontends:
    whisper's ``frames``, internvl's ``patch_embeds``) to shape-builders
    ``(batch, seq) -> meta tensor``.
    """

    arch_id: str
    family: str
    model: Any
    cfg: Any
    extra_inputs: dict[str, Callable[[int, int], torch.Tensor]] = \
        dataclasses.field(default_factory=dict)
    # Optimizer-moment dtype hint (bf16 for the giants of the JAX package).
    moment_dtype: str = "float32"

    def loss(self, params, batch, split: layers.TPSplit | None = None,
             fsdp: layers.FSDP | None = None) -> torch.Tensor:
        """Mean next-token CE (+ 0.01 x the aux loss) on a ``{'tokens',
        'labels', ...}`` batch, through the hidden-state API and the chunked
        CE, so the full ``[B, S, V]`` logits never exist. Under ``split``
        (on a mesh whose model extent is above 1) ``params`` are this
        rank's model shards, the CE is vocab-parallel, and every rank of
        the axis gets the same loss. ``fsdp`` (on a mesh) gathers each unit
        where it runs; the head is gathered once for every chunk of the
        CE."""
        extras = {k: batch[k] for k in self.extra_inputs}
        kw = {} if split is None else {"split": split}
        if fsdp is not None:
            kw["fsdp"] = fsdp
        h, aux = self.model.hidden(params, batch["tokens"], **extras, **kw)
        head = self.model.head(params, fsdp)
        ce = layers.chunked_cross_entropy(
            lambda hc: hc @ head.to(hc.dtype), h, batch["labels"], split=split)
        return ce + 0.01 * aux

    def input_specs(self, shape: ShapeSpec) -> dict[str, torch.Tensor]:
        """Meta tensors standing in for a *training* batch of this shape."""
        b, s = shape.global_batch, shape.seq_len
        specs = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
        for name, make in self.extra_inputs.items():
            specs[name] = make(b, s)
        return specs


def lm_input_specs() -> dict[str, Callable[[int, int], torch.Tensor]]:
    return {}
