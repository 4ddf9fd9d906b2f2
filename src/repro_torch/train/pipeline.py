"""Pipeline parallelism: GPipe microbatch streaming over a ``pipe`` mesh axis.

The port of ``repro.train.pipeline``. Each rank along the axis holds one
*stage*, a contiguous slice of the layer stack, and activations stream
stage to stage through :func:`~repro_torch.core.comm.ppermute`. The schedule
is the classic GPipe fill-drain: with S stages and M microbatches it runs
M + S - 1 steps, and the bubble fraction is (S - 1) / (M + S - 1).

Where the JAX function runs under ``shard_map`` with stage-stacked
parameters sharded over the axis, the port runs one process a stage, and
each rank passes only its own stage's parameters.

**The gradient** is the one ``jax.grad`` takes through the reference (the
transpose of its ``scan`` of ``ppermute`` s and its final ``psum``):

* *The output is replicated*, and every rank computes the same loss from
  it (as from :func:`~repro_torch.core.comm.sum_partials`): the last stage
  takes its own cotangent of the output; the other ranks' cotangents are
  not summed in (that would be S times the gradient).
* *The backward runs in a fixed order on every rank*: one
  ``torch.autograd.Function`` over the whole call walks the steps in
  reverse (t = M + S - 2 ... 0) and posts the reverse permutation (pairs
  ``(i + 1, i)``) once a step, bubbles included, as the forward posts its
  own (``"ppermute_grad"``). Each active step's input cotangent goes to
  the stage before; the stage's leaves sum their gradients over the steps,
  the last microbatch's first, as the reference's scan transposes.
* *The microbatches* are a replicated input that only stage 0 consumes:
  their gradient is stage 0's, broadcast from it (``"broadcast_grad"``),
  bitwise alike on every rank.
* *Memory is GPipe's*: each stage keeps what its ``stage_fn`` saves for
  the backward at each of its M active steps (its own checkpointing is
  honoured; the wrapper rematerialises nothing), and frees each step's
  graph as the backward passes it.

Where no gradient is asked (grad mode off, or no input requiring grad)
the call runs the forward alone: the same M + S - 1 ``ppermute`` s and one
``broadcast``, and it saves nothing. Every rank must ask alike, and every
rank's loss must reach the output, since the ranks call the backward's
collectives together.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import comm
from repro_torch.optim.tree import named_leaves

__all__ = ["pipeline_apply"]


def _forward(stage_fn, stage_params, microbatches, mesh, axis, steps=None):
    """The GPipe forward: the ``[M, mb, ...]`` outputs broadcast from the
    last stage. With ``steps`` (a list), each active step's
    ``(t, input, output)`` is appended, its input a leaf and its output
    built under grad; the input requires grad where the backward sends its
    cotangent on (every stage but 0) or the microbatches require it."""
    n_stages = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    m = microbatches.shape[0]
    last = n_stages - 1
    to_next = [(i, i + 1) for i in range(last)]
    buf = torch.zeros_like(microbatches[0])
    out = torch.zeros_like(microbatches)
    for t in range(m + last):
        if idx <= t < idx + m:  # microbatch t - idx reaches this stage
            x = microbatches[t] if idx == 0 else buf
            if steps is None:
                y = stage_fn(stage_params, x)
            else:
                x = x.detach().requires_grad_(idx > 0 or microbatches.requires_grad)
                with torch.enable_grad():
                    y = stage_fn(stage_params, x)
                steps.append((t, x, y))
                y = y.detach()
            if idx == last:
                out[t - last] = y
        else:
            y = torch.zeros_like(buf)
        buf = comm.ppermute(y, mesh, axis, to_next)
    return comm.broadcast(out, mesh, axis, src=last)


class _Pipeline(torch.autograd.Function):
    """:func:`_forward` with the GPipe backward (see the module docstring);
    the inputs after ``axis`` are the microbatches and the stage's leaves
    that require grad."""

    @staticmethod
    def forward(ctx, stage_fn, stage_params, mesh, axis, microbatches, *leaves):
        ctx.mesh, ctx.axis, ctx.leaves = mesh, axis, leaves
        ctx.steps = []
        ctx.mb_like = (microbatches.shape, microbatches.dtype, microbatches.device)
        return _forward(stage_fn, stage_params, microbatches, mesh, axis, ctx.steps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        mesh, axis, leaves, steps = ctx.mesh, ctx.axis, ctx.leaves, ctx.steps
        n_stages = mesh.shape[axis]
        idx = mesh.axis_index(axis)
        last = n_stages - 1
        shape, dtype, device = ctx.mb_like
        m = shape[0]
        to_prev = [(i + 1, i) for i in range(last)]
        want_x = ctx.needs_input_grad[4]
        g_mb = torch.zeros(shape, dtype=dtype, device=device) if want_x else None
        g_leaves = [None] * len(leaves)
        g_buf = torch.zeros(shape[1:], dtype=dtype, device=device)
        for t in range(m + last - 1, -1, -1):
            if steps and steps[-1][0] == t:
                _, x, y = steps.pop()
                g_y = g_out[t - last] if idx == last else g_buf
                wrt = ([x] if x.requires_grad else []) + list(leaves)
                grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
                g_x = grads[0] if x.requires_grad else None
                for j, g in enumerate(grads[len(wrt) - len(leaves):]):
                    if g is not None:
                        g_leaves[j] = g if g_leaves[j] is None else g_leaves[j] + g
                if idx == 0 and want_x:
                    g_mb[t] = g_x
                g_x = torch.zeros_like(g_buf) if g_x is None else g_x
            else:
                g_x = torch.zeros_like(g_buf)
            g_buf = comm.ppermute(g_x, mesh, axis, to_prev, count_as="ppermute_grad")
        if want_x:
            g_mb = comm.broadcast(g_mb, mesh, axis, src=0, count_as="broadcast_grad")
        return (None, None, None, None, g_mb, *g_leaves)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,            # this rank's stage
    microbatches: torch.Tensor,   # [M, mb, ...], the same on every rank
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """``y_m = stage_{S-1}(... stage_0(x_m))`` for every microbatch ``m``.

    Every rank of the axis calls this with its own stage's parameters
    (stage ``i`` at axis index ``i``: a module, or a dict of modules or
    tensors); ``stage_fn(params, x)`` maps an activation to one of the same
    shape and dtype. Stage 0 feeds microbatch ``t`` at step ``t``; each
    stage hands its output to the next with one ``ppermute`` a step; the
    last stage keeps microbatch ``t - (S - 1)``. A stage computes only at
    the steps that carry a microbatch to it (the reference computes on
    zeros in the bubble and discards the result). Returns the
    ``[M, mb, ...]`` outputs on every rank, broadcast from the last stage
    (the reference sums the last stage's with zeros elsewhere).

    Under grad, with the microbatches or a leaf of ``stage_params``
    requiring grad, the output is differentiable with respect to both (the
    module docstring's contract: the same loss on every rank).
    """
    leaves = [p for p in named_leaves(stage_params).values() if p.requires_grad]
    if torch.is_grad_enabled() and (microbatches.requires_grad or leaves):
        return _Pipeline.apply(stage_fn, stage_params, mesh, axis, microbatches, *leaves)
    return _forward(stage_fn, stage_params, microbatches, mesh, axis)
