"""Shared plumbing for architecture configs: shapes and bundles."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ShapeSpec", "SHAPES", "Bundle"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class Bundle:
    """What every architecture exposes: its model (``init_params``,
    ``forward``, cache methods) and config. The training loss waits for the
    training slice of the port."""

    arch_id: str
    family: str
    model: Any
    cfg: Any
