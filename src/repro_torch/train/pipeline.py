"""Pipeline parallelism: GPipe microbatch streaming over a ``pipe`` mesh axis.

The port of ``repro.train.pipeline``. Each rank along the axis holds one
*stage*, a contiguous slice of the layer stack, and activations stream
stage to stage through :func:`~repro_torch.core.comm.ppermute`. The schedule
is the classic GPipe fill-drain: with S stages and M microbatches it runs
M + S - 1 steps, and the bubble fraction is (S - 1) / (M + S - 1).

Where the JAX function runs under ``shard_map`` with stage-stacked
parameters sharded over the axis, the port runs one process a stage, and
each rank passes only its own stage's parameters. Forward only, as the
reference's test uses it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import comm

__all__ = ["pipeline_apply"]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,            # this rank's stage
    microbatches: torch.Tensor,   # [M, mb, ...], the same on every rank
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """``y_m = stage_{S-1}(... stage_0(x_m))`` for every microbatch ``m``.

    Every rank of the axis calls this with its own stage's parameters
    (stage ``i`` at axis index ``i``); ``stage_fn(params, x)`` maps an
    activation to one of the same shape and dtype. Stage 0 feeds microbatch
    ``t`` at step ``t``; each stage hands its output to the next with one
    ``ppermute`` a step; the last stage keeps microbatch ``t - (S - 1)``.
    A stage computes only at the steps that carry a microbatch to it (the
    reference computes on zeros in the bubble and discards the result).
    Returns the ``[M, mb, ...]`` outputs on every rank, broadcast from the
    last stage (the reference sums the last stage's with zeros elsewhere).
    """
    n_stages = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    m = microbatches.shape[0]
    last = n_stages - 1
    to_next = [(i, i + 1) for i in range(last)]
    buf = torch.zeros_like(microbatches[0])
    out = torch.zeros_like(microbatches)
    for t in range(m + last):
        if idx <= t < idx + m:  # microbatch t - idx reaches this stage
            y = stage_fn(stage_params, microbatches[t] if idx == 0 else buf)
            if idx == last:
                out[t - last] = y
        else:
            y = torch.zeros_like(buf)
        buf = comm.ppermute(y, mesh, axis, to_next)
    return comm.broadcast(out, mesh, axis, src=last)
