"""Delayed-current ring buffer (port of ``repro.core.ring_buffer``).

Each neuron owns ``ring_len`` future-input slots. A spike emitted at step
``t`` through a synapse with delay ``d`` deposits its weight into slot
``(t + d) % ring_len``; at the start of step ``t`` the engine reads -- and
clears -- slot ``t % ring_len``. The whole network's buffers form one dense
``[..., n, ring_len]`` tensor.

Unlike the JAX functions these update the ring **in place** (it is the
engine's largest state array) and return it; the engine clones the ring once
per window, so a caller's state is never modified. Every add is exact in any
order: weights lie on the 1/256 grid.
"""

from __future__ import annotations

import torch

__all__ = [
    "read_and_clear",
    "read_and_clear_block",
    "open_window",
    "merge_window_tail",
    "deposit",
    "deposit_scatter",
]


def read_and_clear(ring: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (input slot for step ``t``, ring with that slot zeroed)."""
    slot = t % ring.shape[-1]
    i_in = ring[..., slot].clone()
    ring[..., slot] = 0.0
    return i_in, ring


def read_and_clear_block(
    ring: torch.Tensor, t0: int, d: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (slots ``[t0, t0+d)`` as ``[..., d]``, ring with them zeroed).

    Requires phase alignment: ``ring.shape[-1] % d == 0`` and ``t0 % d == 0``
    (window starts), so the window's slots are contiguous.
    """
    r = ring.shape[-1]
    if r % d != 0:
        raise ValueError(f"ring_len={r} must be a multiple of the block d={d}")
    start = t0 % r
    blk = ring[..., start:start + d].clone()
    ring[..., start:start + d] = 0.0
    return blk, ring


def open_window(
    ring: torch.Tensor, t0: int, d: int, w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked read/clear + zero-extended live buffer ``fut [..., w]``.

    Columns ``[0, d)`` of ``fut`` are the window's input slots; ``[d, w)``
    start at zero and collect the window's own intra deposits that overhang
    its end (merged back by :func:`merge_window_tail`).
    """
    blk, ring = read_and_clear_block(ring, t0, d)
    fut = torch.zeros(blk.shape[:-1] + (max(w, d),), dtype=blk.dtype, device=blk.device)
    fut[..., :d] = blk
    return fut, ring


def merge_window_tail(ring: torch.Tensor, tail: torch.Tensor, t: int) -> torch.Tensor:
    """Add ``tail[..., j]`` (destined for absolute step ``t + j``) into the ring."""
    r, w = ring.shape[-1], tail.shape[-1]
    if w == 0:
        return ring
    if w > r:
        raise ValueError(f"tail width {w} exceeds ring length {r}")
    slots = torch.remainder(t + torch.arange(w, device=ring.device), r)
    return ring.index_add_(ring.ndim - 1, slots, tail)


def deposit(ring, vals, delays, t: int):
    """Add ``vals [N, K]`` into slots ``(t + delays) % R`` of ``ring [N, R]``
    through a one-hot einsum over the slot axis (the reference semantics)."""
    r = ring.shape[-1]
    slots = torch.remainder(t + delays.long(), r)
    onehot = torch.nn.functional.one_hot(slots, r).to(vals.dtype)
    return ring.add_(torch.einsum("nk,nkr->nr", vals, onehot))


def deposit_scatter(ring, vals, delays, t: int):
    """Scatter-add variant of :func:`deposit` (same result, no one-hot), over
    flat ``row * R + slot`` indices."""
    n, r = ring.shape
    slots = torch.remainder(t + delays.long(), r)
    flat_idx = torch.arange(n, device=ring.device)[:, None] * r + slots
    ring.view(-1).index_add_(0, flat_idx.reshape(-1), vals.reshape(-1))
    return ring
