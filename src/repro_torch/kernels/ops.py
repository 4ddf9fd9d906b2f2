"""Public wrappers around the kernels, dispatching on the tensors' device.

Port of ``repro.kernels.ops`` (``lif_update``, ``spike_deliver``,
``apply_contrib``, ``superstep_lif``, ``superstep_iaf``, the event path's
``sized_nonzero``, ``compact_ids_block``, ``event_deliver*`` and the
adaptive ladder's ``bucket_index``, ``ladder_rung``, ``ladder_switch``) and
of the call of ``flash_attention_pallas`` in ``repro.models.layers``. A
tensor on the CPU goes to the kernel's plain PyTorch version, a CUDA tensor
to the CUDA kernel, and any other device raises: there is no silent
fallback from the kernel to the plain version. Unlike the JAX wrappers
these pad nothing and do not widen int8 delays: the kernels mask their own
ragged edge and read int8 as stored.
"""

from __future__ import annotations

import bisect

import torch

from repro_torch.kernels import cycle as _cyc
from repro_torch.kernels import event_deliver as _evt
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lif_update as _lif
from repro_torch.kernels import spike_deliver as _dlv

__all__ = [
    "sized_nonzero", "compact_ids_block", "bucket_index", "ladder_rung", "ladder_switch",
    "lif_update", "spike_deliver", "apply_contrib", "event_deliver", "event_deliver_ids",
    "event_deliver_block", "superstep_lif", "superstep_iaf", "flash_attention",
]


def _pick(x: torch.Tensor, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"no kernel for device {x.device} (expected cpu or cuda)")


def _first_true(mask: torch.Tensor, size: int):
    """Per row of a ``[B, L]`` bool mask: ``(pos, keep, counts)``, where
    ``pos[r, j]`` (int32) is the position of row ``r``'s ``j``-th true entry
    wherever ``keep[r, j]``, i.e. ``j < counts[r]`` (int32, the row's true
    entries). Static shapes, no host sync, seven launches: one cumsum over
    the flattened mask (a single 1-D scan; scanning each of a few long rows
    is much slower on the card), then a binary search per row for the
    running count ``base[r] + j + 1``."""
    b, n = mask.shape
    dev = mask.device
    counts = mask.sum(dim=1, dtype=torch.int32)
    if n == 0:
        zeros = torch.zeros((b, size), dtype=torch.int32, device=dev)
        return zeros, zeros.bool(), counts
    csum = torch.cumsum(mask.reshape(-1), dim=0, dtype=torch.int32).view(b, n)
    ends = csum[:, -1:]
    want = (ends - counts[:, None]) + torch.arange(1, size + 1, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(csum, want, side="left", out_int32=True)
    return pos, want <= ends, counts


def sized_nonzero(mask: torch.Tensor, *, size: int, fill: int) -> torch.Tensor:
    """Indices (int32) of the first ``size`` true elements along the last
    axis of a bool mask, padded with ``fill``: under overflow the first
    ``size`` by index survive. A 1-D mask is the JAX package's case; a
    ``[B, L]`` mask gives ``[B, size]``, one packet per row. A cumsum + binary
    search, not ``torch.nonzero``: the shape is static and nothing waits for
    the device."""
    pos, keep, _ = _first_true(mask.reshape(-1, mask.shape[-1]), size)
    return torch.where(keep, pos, fill).view(*mask.shape[:-1], size)


def compact_ids_block(
    mask: torch.Tensor,  # [D, L] bool -- which entries to keep, per row
    ids: torch.Tensor,   # [D, L] or [L] int payload per entry
    *,
    size: int,
    fill_id: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked masked compaction, the id-packet primitive of the event path.

    Row ``d`` of the packets holds the ``ids`` of the first ``size`` kept
    entries of ``mask[d]`` (by index), padded with ``fill_id``; ``counts[d]``
    (int32) is the true number of kept entries, so ``max(counts - size, 0)``
    is what the packet dropped. Returns ``(packets [D, size] int32, counts)``.
    """
    pos, keep, counts = _first_true(mask, size)
    payload = torch.gather(ids.expand(mask.shape), 1, torch.where(keep, pos, 0).long())
    return torch.where(keep, payload, fill_id).to(torch.int32), counts


def bucket_index(ladder, need) -> int:
    """Index of the smallest ladder rung ``>= need`` (clamped to the top).

    A count landing exactly on a rung selects that rung, one past it the
    next. ``need`` may be a device scalar: reading it waits for the device
    (one sync per call).
    """
    return min(bisect.bisect_left(ladder, int(need)), len(ladder) - 1)


def ladder_rung(ladder, need) -> int:
    """The rung :func:`bucket_index` selects."""
    return ladder[bucket_index(ladder, need)]


def ladder_switch(ladder, need, fn, *operands):
    """``fn(rung, *operands)`` with the rung the count ``need`` selects.

    The JAX package compiles one branch per rung and lets ``lax.switch``
    pick one; eager PyTorch picks the rung on the host (one device sync for
    ``need``) and runs ``fn`` with it.
    """
    return fn(ladder_rung(ladder, need), *operands)


def lif_update(
    v, i_syn, refrac, i_in, alive,
    *, p11, p21, p22, v_th, v_reset, t_ref_steps,
):
    """Fused LIF step over state of any shape; see :mod:`.lif_update`."""
    fn = _pick(v, _lif.lif_update_plain, _lif.lif_update_cuda)
    return fn(v, i_syn, refrac, i_in, alive, p11=p11, p21=p21, p22=p22,
              v_th=v_th, v_reset=v_reset, t_ref_steps=t_ref_steps)


def spike_deliver(
    spikes, src, w, delay, *, steps_lo: int, r_span: int,
    rows_per_area: int | None = None, src_stride: int = 0,
):
    """Delay-resolved contributions ``[N, r_span]``; see :mod:`.spike_deliver`."""
    fn = _pick(src, _dlv.spike_deliver_plain, _dlv.spike_deliver_cuda)
    return fn(spikes, src, w, delay, steps_lo=steps_lo, r_span=r_span,
              rows_per_area=rows_per_area, src_stride=src_stride)


def apply_contrib(
    ring: torch.Tensor,     # [N, R], updated in place
    contrib: torch.Tensor,  # [N, r_span]
    t: int,
    steps_lo: int,
) -> torch.Tensor:
    """Add delay-resolved contributions into ring slots ``(t+steps_lo+j) % R``.

    In place (the ring is the engine's largest state array); returns ``ring``.
    """
    r = ring.shape[-1]
    slots = torch.remainder(
        t + steps_lo + torch.arange(contrib.shape[-1], device=ring.device), r)
    return ring.index_add_(1, slots, contrib)


def event_deliver_block(
    ring: torch.Tensor,     # [N_tgt, R], updated in place
    ids: torch.Tensor,      # [D, S] int32 fired ids per window cycle; >= N_src pads
    tgt_out: torch.Tensor,  # [N_src, K_out] int32 target ids (-1 = no target)
    w_out: torch.Tensor,    # [N_src, K_out] f32
    d_out: torch.Tensor,    # [N_src, K_out] int8/int32 delays (steps)
    t0: int,
    *,
    rows_per_area: int | None = None,
) -> torch.Tensor:
    """Scatter a whole window's id packets through the outgoing tables: entry
    ``(s, i)`` deposits its synapses at slots ``(t0 + s + d) % R``. With
    ``rows_per_area=n`` row ``a`` is instead area ``a``'s packet of cycle
    ``t0`` over per-area tables; see :mod:`.event_deliver`. Returns ``ring``."""
    fn = _pick(tgt_out, _evt.event_deliver_plain, _evt.event_deliver_cuda)
    return fn(ring, ids, tgt_out, w_out, d_out, t0, rows_per_area=rows_per_area)


def event_deliver_ids(ring, ids, tgt_out, w_out, d_out, t: int) -> torch.Tensor:
    """Scatter one already-compacted fired-id packet ``ids [S]`` at step
    ``t``: the ``D == 1`` case of :func:`event_deliver_block`."""
    return event_deliver_block(ring, ids.reshape(1, -1), tgt_out, w_out, d_out, t)


def event_deliver(ring, spikes, tgt_out, w_out, d_out, t: int, *, s_max: int) -> torch.Tensor:
    """Event-driven delivery of one cycle: compact the fired sources of the
    bool vector ``spikes [N_src]`` into an ``s_max`` packet, scatter their
    outgoing synapses."""
    fired = sized_nonzero(spikes, size=s_max, fill=tgt_out.shape[0])
    return event_deliver_ids(ring, fired, tgt_out, w_out, d_out, t)


def superstep_lif(
    v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
    *, d_win: int, steps_lo: int, r_span: int,
    p11, p21, p22, v_th, v_reset, t_ref_steps, seed, w_ext,
):
    """Fused LIF D-cycle window over ``[A, n]`` state; see :mod:`.cycle`.

    Returns ``(v, i_syn, refrac, fut, spikes)`` with the spikes in the
    engine's block layout ``[D, A, n]`` bool (the JAX wrapper returns
    ``[A, D, n]`` int8). ``fut`` is updated in place.
    """
    fn = _pick(v, _cyc.superstep_lif_plain, _cyc.superstep_lif_cuda)
    return fn(v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
              d_win=d_win, steps_lo=steps_lo, r_span=r_span, p11=p11, p21=p21,
              p22=p22, v_th=v_th, v_reset=v_reset, t_ref_steps=t_ref_steps,
              seed=seed, w_ext=w_ext)


def superstep_iaf(
    countdown, fut, interval, alive, src, w, delay,
    *, d_win: int, steps_lo: int, r_span: int,
):
    """Fused ignore-and-fire window; returns ``(countdown, fut, spikes)``
    with the spikes as ``[D, A, n]`` bool. See :func:`superstep_lif`."""
    fn = _pick(countdown, _cyc.superstep_iaf_plain, _cyc.superstep_iaf_cuda)
    return fn(countdown, fut, interval, alive, src, w, delay,
              d_win=d_win, steps_lo=steps_lo, r_span=r_span)


def flash_attention(q, k, v, window, k_len):
    """Causal (optionally windowed) GQA attention ``[B, Sq, H, Dh]`` over
    k, v ``[B, Sk, Hkv, Dh]``; see :mod:`.flash_attention`."""
    fn = _pick(q, _fa.flash_attention_plain, _fa.flash_attention_cuda)
    return fn(q, k, v, window, k_len)
