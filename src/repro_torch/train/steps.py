"""Serving step builders: the port of the serving half of
``repro.train.steps`` (``ServeArtifacts``, ``make_serve_artifacts``) for one
device. The sharding metadata of the JAX artifacts (parameter, state and
token specs) waits for the port's mesh; training waits for its own slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.common import Bundle, ShapeSpec

__all__ = ["ServeArtifacts", "make_serve_artifacts"]


@dataclasses.dataclass
class ServeArtifacts:
    prefill_fn: Callable   # (params, batch) -> (logits [B, 1, V], serve_state)
    decode_fn: Callable    # (params, serve_state, tokens [B, 1], idx) -> (logits, state)


def make_serve_artifacts(bundle: Bundle, shape: ShapeSpec, *,
                         cache_dtype=torch.bfloat16) -> ServeArtifacts:
    """Prefill / decode callables for ``shape`` (batch ``global_batch``, a
    cache of ``seq_len`` positions of ``cache_dtype``, on the parameters'
    device). Prefill fills the cache from an empty one and returns the last
    position's logits; decode appends one token per call. Both update the
    serve state's cache in place."""
    model = bundle.model
    b, s = shape.global_batch, shape.seq_len

    def prefill(params, batch):
        cache = model.init_cache(b, s, cache_dtype, device=params.embed.device)
        logits, cache = model.forward_with_cache(params, batch["tokens"], cache, 0,
                                                 last_only=True)
        return logits, {"cache": cache}

    def decode(params, serve_state, tokens, cache_index):
        logits, cache = model.forward_with_cache(params, tokens, serve_state["cache"],
                                                 cache_index)
        return logits, {**serve_state, "cache": cache}

    return ServeArtifacts(prefill_fn=prefill, decode_fn=decode)
