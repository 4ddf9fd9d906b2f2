"""Deterministic synthetic data pipeline (counter-based, no I/O).

The port of ``repro.data.pipeline``. Tokens are a pure function of (seed,
step, batch index, position) via the splitmix32 mixer the SNN drive uses:
any host can make exactly its own shard without coordination, and a restart
resumes bit-identically from the step counter. A light Zipf-ish transform
and planted bigrams give the stream enough structure that loss curves move.
numpy only, so batches are bitwise the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.mesh import ProcessMesh
from repro_torch.device import resolve_device

__all__ = ["SyntheticLM", "host_batch"]


def _splitmix32_np(x: np.ndarray) -> np.ndarray:
    x = (x + 0x9E3779B9).astype(np.uint32)
    x = ((x ^ (x >> 16)) * np.uint32(0x21F0AAAD)).astype(np.uint32)
    x = ((x ^ (x >> 15)) * np.uint32(0x735A2D97)).astype(np.uint32)
    return (x ^ (x >> 15)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Next-token LM stream: labels are tokens shifted by one."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        b, s = self.global_batch, self.seq_len
        idx = (
            np.uint32(self.seed) * np.uint32(0x9E37)
            + np.uint32(step) * np.uint32(b * (s + 1))
            + np.arange(b * (s + 1), dtype=np.uint32)
        ).reshape(b, s + 1)
        u = _splitmix32_np(idx).astype(np.float64) / 2**32
        # Zipf-ish skew: low token ids are exponentially more common.
        toks = np.minimum(
            (-np.log(1 - u * (1 - np.exp(-6.0))) / 6.0 * self.vocab),
            self.vocab - 1,
        ).astype(np.int32)
        # Planted bigram structure: every other token repeats the previous
        # one shifted by a constant (CE headroom below log V).
        toks[:, 1::2] = (toks[:, 0:-1:2] + 17) % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def host_batch(batch: dict[str, np.ndarray], device=None,
               batch_axes: tuple[str, ...] = ("data",), pod_axis: str | None = None, *,
               n_pods: int | None = None) -> dict[str, torch.Tensor]:
    """A host batch on ``device`` (default ``cuda``; raises without a GPU),
    with a leading ``[n_pods]`` axis for the hierarchical trainer when
    ``n_pods`` is given. Given a :class:`~repro_torch.core.mesh.ProcessMesh`
    instead of a device, this rank's slice of the global batch on the
    mesh's device: the batch split over ``batch_axes`` (row-major, as the
    JAX ``NamedSharding`` places it), after a leading pod axis of the mesh's
    extent when ``pod_axis`` is given (this rank's pod: extent 1)."""
    mesh = device if isinstance(device, ProcessMesh) else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = {}
    for k, v in batch.items():
        x = torch.from_numpy(np.ascontiguousarray(v))
        if mesh is not None:
            rest = (None,) * (x.dim() - 1)
            if pod_axis is not None:
                x = x.reshape((mesh.shape[pod_axis], -1) + tuple(x.shape[1:]))
                x = mesh.shard(x, (pod_axis, batch_axes, *rest), k)
            else:
                x = mesh.shard(x, (batch_axes, *rest), k)
        elif n_pods is not None:
            x = x.reshape((n_pods, -1) + tuple(x.shape[1:]))
        out[k] = x.to(dev)
    return out
