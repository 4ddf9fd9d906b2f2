"""Event-driven delivery: the CUDA scatter kernel and its plain version.

Port of ``repro.kernels.ops.event_deliver_block`` (plain jnp in the JAX
package; it has no Pallas kernel). Both versions scatter the outgoing
synapses of fired-source id packets straight into the ring:

    for every packet row r, entry i with id = ids[r, i] a real source:
        for every k with tgt[row(id), k] a real target:
            ring[off(r) + tgt[row(id), k], (t0 + step(r) + d[row(id), k]) % R]
                += w[row(id), k]

Two packet layouts, one per pathway:

* per cycle (``rows_per_area=None``, the inter pathway): row ``r`` is cycle
  ``t0 + r`` of a window; ids and targets are global rows
  (``row(id) = id``, ``off(r) = 0``, ``step(r) = r``);
* per area (``rows_per_area=n``, the intra pathway): row ``r`` is area
  ``r``'s packet of one cycle ``t0``; ids and targets are indices within
  the area (``row(id) = r * n + id``, ``off(r) = r * n``, ``step(r) = 0``),
  as ``spike_deliver`` takes ``rows_per_area``/``src_stride``.

An id outside ``[0, n_src)`` is packet padding, and a target outside
``[0, n_tgt)`` (the tables pad with -1) is table padding: neither adds
anything. The JAX package adds ``+0.0`` into ring row 0 for both instead;
that is bitwise the same, because rings never hold ``-0.0`` (they start at
``+0.0`` and exact sums that cancel give ``+0.0``). The plain version adds
those ``+0.0`` as the JAX package does; the kernel skips them. Every add is
exact in any order: weights lie on the 1/256 grid.

The kernel needs every row of ``tgt`` ascending as unsigned 32-bit values:
real targets ascending, ``-1`` padding only at the end. The port's outgoing
tables are built so (``connectivity.add_outgoing_tables``, the JAX
package's stable-argsort order), and ``network_from_numpy`` refuses tables
that are not. A dense packet (from one add per 32-byte ring sector, a
quarter of one for per-area packets) has
the ring's rows cut into slices that fit the card's L2, reduced into one
slice after another; on a row that breaks the order the kernel would miss
adds. The plain version takes any order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda

__all__ = ["event_deliver_plain", "event_deliver_cuda", "event_deliver_forced", "slice_rows",
           "red_probe"]

# Packet entries per chunk of the plain version, times K_out: bounds its
# int64/f32 temporaries (~40 B per gathered synapse).
PLAIN_CHUNK_SYNAPSES = 1 << 24


def _layout(ring, ids, tgt, w, d, rows_per_area):
    """``(n_src, n_tgt)``: the id and target bounds of one packet row."""
    n_src_all, k = tgt.shape
    if w.shape != (n_src_all, k) or d.shape != (n_src_all, k):
        raise ValueError(
            f"event_deliver: tgt {tuple(tgt.shape)}, w {tuple(w.shape)} and d "
            f"{tuple(d.shape)} must share one [N_src, K_out] shape")
    if ids.ndim != 2 or ring.ndim != 2:
        raise ValueError(f"event_deliver: ids [rows, S] and ring [N_tgt, R] expected, "
                         f"got {tuple(ids.shape)} and {tuple(ring.shape)}")
    if rows_per_area is None:
        return n_src_all, ring.shape[0]
    rows = ids.shape[0]
    if rows_per_area <= 0 or n_src_all != rows * rows_per_area or (
            ring.shape[0] != rows * rows_per_area):
        raise ValueError(
            f"event_deliver: {rows} per-area packets of rows_per_area={rows_per_area} "
            f"need tables and ring of {rows * rows_per_area} rows, got "
            f"{n_src_all} and {ring.shape[0]}")
    return rows_per_area, rows_per_area


def event_deliver_plain(ring, ids, tgt, w, d, t0: int, *, rows_per_area: int | None = None):
    """Gather + ``index_add_`` on the flattened ring, in plain PyTorch (any
    device). Updates ``ring`` in place and returns it."""
    n_src, n_tgt = _layout(ring, ids, tgt, w, d, rows_per_area)
    rows, s_max = ids.shape
    r, k = ring.shape[1], tgt.shape[1]
    if rows * s_max == 0 or k == 0:
        return ring
    row = torch.arange(rows, device=ring.device).repeat_interleave(s_max)
    zero = torch.zeros_like(row)
    # Per entry: the table row offset of its ids, the ring row offset of its
    # targets, and its cycle within the window.
    if rows_per_area is None:
        off, step = zero, row
    else:
        off, step = row * rows_per_area, zero
    flat_ids = ids.reshape(-1).long()
    flat_ring = ring.view(-1)
    chunk = max(1, PLAIN_CHUNK_SYNAPSES // k)
    for e0 in range(0, flat_ids.numel(), chunk):
        i, o, s = flat_ids[e0:e0 + chunk], off[e0:e0 + chunk, None], step[e0:e0 + chunk, None]
        valid = (i >= 0) & (i < n_src)
        safe = torch.where(valid, i + o[:, 0], 0)
        tg = tgt[safe].long()
        ok = valid[:, None] & (tg >= 0) & (tg < n_tgt)
        tgt_rows = torch.where(ok, tg + o, 0)
        vals = torch.where(ok, w[safe], 0.0)
        slots = torch.remainder(t0 + s + d[safe].long(), r)
        flat_ring.index_add_(0, (tgt_rows * r + slots).reshape(-1), vals.reshape(-1))
    return ring


def event_deliver_cuda(ring, ids, tgt, w, d, t0: int, *, rows_per_area: int | None = None):
    """Launch the CUDA scatter (``csrc/event_deliver.cu``); updates ``ring``
    in place and returns it.

    ``ring`` f32 ``[N_tgt, R]``, ``ids`` int32 ``[rows, S]``, ``tgt`` int32,
    ``w`` f32 and ``d`` int8 or int32 ``[N_src, K_out]``, all contiguous on
    one CUDA device, ``tgt`` and ``w`` 32-byte aligned, ``d`` 8-byte (int8)
    or 32-byte (int32) aligned; every ``tgt`` row ascending as unsigned (see
    above). The kernel judges from a sample of the packet whether to slice
    the ring (into slices of :func:`slice_rows` rows) and how many warps
    serve an entry; nothing is read back to the host. Scratch: two counters
    and one int64 per packet entry, kept per device and stream between
    launches (``_scratch``); zeroed when made, and every launch leaves the
    counters zero.
    """
    if _launch(cuda.library("event_deliver"), ring, ids, tgt, w, d, t0, rows_per_area):
        cuda.launches["event_deliver"] += 1
    return ring


# The development builds of the kernel with its regime forced.
REGIMES = {"sliced": ("EVENT_DELIVER_REGIME=1",), "unsliced": ("EVENT_DELIVER_REGIME=2",)}


def event_deliver_forced(regime: str, ring, ids, tgt, w, d, t0: int, *,
                         rows_per_area: int | None = None):
    """:func:`event_deliver_cuda` with the kernel built to take one regime,
    ``"sliced"`` or ``"unsliced"``, whatever the packet: for timing both on
    one packet, to place the switch between them. Not a launch of the
    scatter: it is not counted."""
    _launch(cuda.library("event_deliver", REGIMES[regime]), ring, ids, tgt, w, d, t0,
            rows_per_area)
    return ring


def _launch(lib, ring, ids, tgt, w, d, t0, rows_per_area) -> bool:
    """Check the inputs and launch ``lib``'s scatter; False for an empty
    packet, which launches nothing."""
    n_src, n_tgt = _layout(ring, ids, tgt, w, d, rows_per_area)
    dtypes = {"ring": (ring, (torch.float32,)), "ids": (ids, (torch.int32,)),
              "tgt": (tgt, (torch.int32,)), "w": (w, (torch.float32,)),
              "d": (d, (torch.int8, torch.int32))}
    for name, (x, ok) in dtypes.items():
        if not x.is_cuda or x.dtype not in ok or not x.is_contiguous() or x.device != ring.device:
            raise ValueError(
                f"event_deliver kernel: {name} must be a contiguous tensor of "
                f"{ok} on {ring.device}, got {x.dtype} on {x.device}")
    for name, x, align in (("tgt", tgt, 32), ("w", w, 32), ("d", d, 8 * d.element_size())):
        if x.data_ptr() % align:
            raise ValueError(f"event_deliver kernel: {name} must start on a {align}-byte "
                             f"boundary (the kernel reads 8 entries at once)")
    rows, s_max = ids.shape
    r, k = ring.shape[1], tgt.shape[1]
    if rows * s_max == 0 or k == 0 or r == 0:
        return False
    fn = lib.event_deliver_i8_launch if d.dtype == torch.int8 else lib.event_deliver_i32_launch
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        scratch = _scratch(ring.device, stream, 2 + rows * s_max)
        err = fn(ids.data_ptr(), tgt.data_ptr(), w.data_ptr(), d.data_ptr(),
                 ring.data_ptr(), scratch.data_ptr(), rows, s_max, k, r,
                 int(t0) % max(r, 1), n_src, n_tgt, int(rows_per_area or 0), stream)
    if err:
        _scratches.pop((ring.device, stream), None)  # its counters may be left mid-count
    cuda.check("event_deliver", err)
    return True


# The kernel's scratch per (device, stream): its sliced regime needs a
# ticket counter and a count of finished blocks at zero when it starts, and
# leaves them so; the per-entry cursors may hold anything (the kernel checks
# each against its row). Launches on one stream run in order, so they can
# share it, and no launch needs a memset.
_scratches: dict = {}


def _scratch(device, stream: int, numel: int) -> torch.Tensor:
    buf = _scratches.get((device, stream))
    if buf is None or buf.numel() < numel:
        # Replaced: the caching allocator hands the old buffer's memory only
        # to work queued after the launches that used it on this stream.
        buf = torch.zeros(max(numel, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int64, device=device)
        _scratches[device, stream] = buf
    return buf


def slice_rows(ring_len: int, device=None) -> int:
    """Ring rows per slice of the kernel on ``device`` (a CUDA device), for
    rings of ``ring_len`` slots: a quarter of the card's L2, at least one
    row."""
    import ctypes

    lib = cuda.library("event_deliver")
    out = ctypes.c_int64(0)
    with torch.cuda.device(device):
        cuda.check("event_deliver", lib.event_deliver_slice_rows(int(ring_len),
                                                                 ctypes.byref(out)))
    return int(out.value)


def red_probe(buf: torch.Tensor, adds: int, threads: int) -> None:
    """The yardstick of the kernel's reductions: ``threads`` x ``adds`` f32
    reductions (RED) into pseudo-random positions of the contiguous f32 CUDA
    tensor ``buf``, on the current stream. Time it into a buffer that fits
    the L2 for the L2's reduction rate. Not a launch of the scatter: it is
    not counted."""
    if not buf.is_cuda or buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("red_probe: a contiguous f32 CUDA tensor expected")
    lib = cuda.library("event_deliver")
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.event_deliver_red_probe(buf.data_ptr(), buf.numel(), int(adds),
                                          int(threads), stream)
    cuda.check("event_deliver", err)
