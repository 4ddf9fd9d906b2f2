"""Delay-resolved spike delivery: the CUDA kernel and its plain version.

Port of ``repro.kernels.spike_deliver``. Both compute

    contrib[n, j] = sum_k w[n,k] * spikes[off(n) + src[n,k]] * [delay[n,k] == steps_lo + j]

for ``j < r_span``, where ``off(n) = (n // rows_per_area) * src_stride``. The
intra pathway passes its per-area source stride so that ``src`` (indices
within the area) needs no lifted copy; the inter pathway leaves the default
``src_stride = 0`` because its ids are global. Delays are read as stored
(int8 in the production tables, int32 for specs whose cutoffs do not fit).
A synapse whose delay lies outside the window adds nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda

__all__ = ["spike_deliver_plain", "spike_deliver_cuda", "spike_deliver_meta", "allocations"]

# Rows per chunk of the plain version: bounds its int64/f32 temporaries
# (~20 B per synapse) at full size.
PLAIN_CHUNK_ROWS = 1 << 16


def _check_shapes(spikes, src, w, delay, rows_per_area):
    n, k = src.shape
    if w.shape != (n, k) or delay.shape != (n, k):
        raise ValueError(
            f"spike_deliver: src {tuple(src.shape)}, w {tuple(w.shape)} and "
            f"delay {tuple(delay.shape)} must share one [N, K] shape")
    if spikes.ndim != 1:
        raise ValueError(f"spike_deliver: spikes must be 1-D, got {tuple(spikes.shape)}")
    if rows_per_area is not None and rows_per_area <= 0:
        raise ValueError(f"spike_deliver: rows_per_area={rows_per_area} must be > 0")


def spike_deliver_plain(
    spikes, src, w, delay, *, steps_lo: int, r_span: int,
    rows_per_area: int | None = None, src_stride: int = 0,
):
    """Gather, then per-slot sums, in plain PyTorch (row chunks; any device)."""
    _check_shapes(spikes, src, w, delay, rows_per_area)
    n, k = src.shape
    rows_per_area = rows_per_area or max(n, 1)
    out = torch.zeros((n, r_span), dtype=w.dtype, device=w.device)
    if k == 0 or r_span == 0:
        return out
    for r0 in range(0, n, PLAIN_CHUNK_ROWS):
        r1 = min(n, r0 + PLAIN_CHUNK_ROWS)
        rows = torch.arange(r0, r1, device=src.device)
        off = (rows // rows_per_area) * src_stride
        vals = w[r0:r1] * spikes[src[r0:r1].long() + off[:, None]]
        j = delay[r0:r1].long() - steps_lo
        inside = (j >= 0) & (j < r_span)
        out[r0:r1].scatter_add_(
            1, torch.where(inside, j, 0), torch.where(inside, vals, 0.0))
    return out


def allocations(spikes, src, r_span: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """What the kernel's wrapper allocates for a launch: the ``[N, r_span]``
    f32 output and the scratch for the kernel's bitmask of nonzero spikes
    (one bit per source, in whole 16-byte units; None where nothing is
    launched: no rows, slots or synapses)."""
    n, k = src.shape
    out = torch.empty((n, r_span), dtype=torch.float32, device=src.device)
    if n == 0 or r_span == 0 or k == 0:
        return out, None
    return out, torch.empty(-(-spikes.numel() // 128) * 4, dtype=torch.int32,
                            device=src.device)


def spike_deliver_meta(
    spikes, src, w, delay, *, steps_lo: int, r_span: int,
    rows_per_area: int | None = None, src_stride: int = 0,
):
    """A launch priced on ``meta`` tensors: the kernel's :func:`allocations`,
    no arithmetic; returns the output."""
    _check_shapes(spikes, src, w, delay, rows_per_area)
    out, mask = allocations(spikes, src, r_span)
    del mask
    return out


def spike_deliver_cuda(
    spikes, src, w, delay, *, steps_lo: int, r_span: int,
    rows_per_area: int | None = None, src_stride: int = 0,
):
    """Launch the CUDA kernel; returns a new ``[N, r_span]`` f32 tensor.

    ``spikes`` f32 ``[N_src]``, ``src`` int32, ``w`` f32 and ``delay`` int8
    or int32 ``[N, K]``, all contiguous on one CUDA device.
    """
    _check_shapes(spikes, src, w, delay, rows_per_area)
    n, k = src.shape
    dtypes = {"spikes": (spikes, (torch.float32,)), "src": (src, (torch.int32,)),
              "w": (w, (torch.float32,)), "delay": (delay, (torch.int8, torch.int32))}
    for name, (x, ok) in dtypes.items():
        if not x.is_cuda or x.dtype not in ok or not x.is_contiguous() or x.device != src.device:
            raise ValueError(
                f"spike_deliver kernel: {name} must be a contiguous tensor of "
                f"{ok} on {src.device}, got {x.dtype} on {x.device}")
    if r_span > 1024:
        raise ValueError(f"spike_deliver kernel: r_span={r_span} exceeds 1024 "
                         "(each warp's accumulators live in shared memory)")
    out, mask = allocations(spikes, src, r_span)
    if mask is None:  # no rows or slots (nothing to write), or no synapses
        return out.zero_()
    lib = cuda.library("spike_deliver")
    fn = (lib.spike_deliver_i8_launch if delay.dtype == torch.int8
          else lib.spike_deliver_i32_launch)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(spikes.data_ptr(), spikes.numel(), mask.data_ptr(),
                 src.data_ptr(), w.data_ptr(), delay.data_ptr(), out.data_ptr(),
                 n, k, int(steps_lo), int(r_span), int(rows_per_area or n),
                 int(src_stride), stream)
    cuda.check("spike_deliver", err)
    cuda.launches["spike_deliver"] += 1
    return out
