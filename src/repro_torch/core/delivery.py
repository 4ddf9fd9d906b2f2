"""Backend-selectable spike delivery: the shared per-cycle hot path.

Port of ``repro.core.delivery`` for the dense backends, selected by
``EngineConfig.delivery_backend``:

* ``"onehot"``  -- gather + one-hot-einsum deposit (reference semantics);
* ``"scatter"`` -- gather + ``index_add_`` deposit;
* ``"pallas"``  -- the delay-resolved delivery kernel
  (:func:`repro_torch.kernels.ops.spike_deliver`; a CUDA kernel on the GPU),
  whose ``[N, r_span]`` contributions are added into the ring with
  :func:`~repro_torch.kernels.ops.apply_contrib`. The name is the JAX
  package's, kept so that configs carry over.
* ``"event"``   -- compact the fired neurons into fixed-size id packets
  (:func:`~repro_torch.kernels.ops.sized_nonzero`) and scatter their
  *outgoing* synapses (:func:`~repro_torch.kernels.ops.event_deliver_block`;
  a CUDA kernel on the GPU). Work scales with the packet, not with the
  table. Requires ``build_network(outgoing=True)``; ``s_max`` caps the
  packet, and the exchange counts what a packet drops
  (:func:`event_bounds`, :func:`bucket_ladder`).

All backends are bit-identical: delivery weights live on the exact 1/256
grid, so f32 ring accumulation is exact in any order. Rings are updated in
place (see :mod:`repro_torch.core.ring_buffer`).
"""

from __future__ import annotations

import torch

from repro_torch.core import ring_buffer
from repro_torch.core.connectivity import Network
from repro_torch.kernels import ops as kops

__all__ = [
    "BACKENDS",
    "ONEHOT_FOLD_LIMIT",
    "expected_area_spikes",
    "event_bounds",
    "bucket_ladder",
    "expected_bucket",
    "deliver_intra",
    "deliver_inter",
    "deliver_inter_block",
    "compact_fired",
    "compact_fired_block",
]

BACKENDS = ("onehot", "scatter", "pallas", "event")

# deliver_inter_block folds the window's cycle axis into the synapse axis;
# for the one-hot backend that materialises an [N, D*K, R] tensor. Above
# this element count (1 GiB f32) the blocked call deposits per cycle.
ONEHOT_FOLD_LIMIT = 2**28
# The scatter backend's deposits take at most this many synapse slots at a
# time (each slot costs ~30 B of int64 index and f32 value temporaries), in
# row chunks: a whole-table pass at the 32-area MAM's scale 0.2 (1.5 G
# slots) would need tens of GB of them.
SCATTER_CHUNK_SLOTS = 2**26


def expected_area_spikes(net: Network) -> float:
    """Expected spikes per (padded) area per cycle, the packet-sizing rule:
    ``n_pad x mean rate x dt``, the mean taken in f32 as the JAX package
    takes it. A shape-only network (meta tensors, ``network_sds``) carries
    no rates and takes the 2.5 Hz MAM ground state, as the reference's
    stand-ins do."""
    rate = net.rate_hz
    mean_rate = 2.5 if rate.device.type == "meta" else float(rate.float().mean())
    return net.alive.shape[1] * mean_rate * net.dt_ms * 1e-3


def event_bounds(
    net: Network, *, headroom: float, floor: int, burst_factor: int = 1
) -> tuple[int, int]:
    """Static event-packet bounds ``(s_max_area, s_max_all)``.

    ``s_max = headroom x expected spikes/cycle + floor``; the whole-network
    bound's constant slack is ``4 x floor``, times ``burst_factor`` (a
    network of B folded copies keeps each copy's burst slack). Spikes beyond
    a bound are dropped and counted in ``SimState.overflow``.
    """
    a = net.alive.shape[0]
    exp_area = expected_area_spikes(net)
    s_max_area = int(headroom * exp_area) + max(floor, 1)
    s_max_all = (int(headroom * exp_area * a)
                 + 4 * max(floor, 1) * max(int(burst_factor), 1))
    return s_max_area, s_max_all


def bucket_ladder(floor: int, cap: int) -> tuple[int, ...]:
    """The adaptive exchange's packet-size ladder: ``floor, 2 floor, 4 floor,
    ...`` topped by ``cap`` exactly. ``cap`` is the hard population bound
    (every neuron in scope fires once per cycle), so a packet sized by the
    rung that covers the counted need never drops a spike."""
    floor = max(int(floor), 1)
    cap = max(int(cap), floor)
    rungs = []
    b = floor
    while b < cap:
        rungs.append(b)
        b *= 2
    rungs.append(cap)
    return tuple(rungs)


def expected_bucket(ladder: tuple[int, ...], expected_count: float) -> int:
    """The rung a typical window lands on: the smallest rung >= the
    expectation."""
    need = int(-(-expected_count // 1)) if expected_count > 0 else 1
    for b in ladder:
        if b >= need:
            return b
    return ladder[-1]


def _deposit_onehot(ring, vals, delays, t):
    a, n, r = ring.shape
    k = vals.shape[-1]
    ring_buffer.deposit(ring.view(a * n, r), vals.reshape(a * n, k), delays.reshape(a * n, k), t)
    return ring


def _scatter_rows(ring, k: int, chunk, t: int) -> None:
    """The scatter backend's deposit into ``ring [N, R]`` in row chunks of
    at most :data:`SCATTER_CHUNK_SLOTS` slots: ``chunk(r0, r1)`` gives rows
    ``[r0, r1)``'s ``(values, delays)``, ``[r1 - r0, k]`` each. Exact in any
    order (the 1/256 grid)."""
    n = ring.shape[0]
    step = max(1, SCATTER_CHUNK_SLOTS // max(k, 1))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        ring_buffer.deposit_scatter(ring[r0:r1], *chunk(r0, r1), t)


def deliver_intra(
    ring: torch.Tensor,         # [A, n, R] target rows, updated in place
    area_spikes: torch.Tensor,  # [A, n_src] f32 per-area spike vectors
    net: Network,
    t: int,
    *,
    backend: str,
    s_max: int | None = None,
) -> torch.Tensor:
    """One cycle of intra-area (short-range pathway) delivery; ``s_max``
    bounds each area's packet on the event backend."""
    a, n, r = ring.shape
    k = net.k_intra
    if k == 0:
        return ring
    if backend == "event":
        # One packet per area, ids within the area; one scatter for all areas.
        n_src = area_spikes.shape[-1]
        ids = kops.sized_nonzero(area_spikes > 0, size=s_max, fill=n_src)
        k_out = net.tgt_intra.shape[-1]
        kops.event_deliver_block(
            ring.view(a * n, r), ids, net.tgt_intra.view(a * n, k_out),
            net.wout_intra.view(a * n, k_out), net.dout_intra.view(a * n, k_out),
            t, rows_per_area=n)
        return ring
    if backend == "pallas":
        # One launch for the whole network: the kernel offsets each area's
        # within-area source indices by area * n_src itself.
        n_src = area_spikes.shape[-1]
        contrib = kops.spike_deliver(
            area_spikes.reshape(-1), net.src_intra.view(a * n, k),
            net.w_intra.view(a * n, k), net.delay_intra.view(a * n, k),
            steps_lo=net.steps_lo_intra, r_span=net.r_span_intra,
            rows_per_area=n, src_stride=n_src)
        kops.apply_contrib(ring.view(a * n, r), contrib, t, net.steps_lo_intra)
        return ring
    if backend == "scatter":
        # Row r of the flat table belongs to area r // n, whose sources start
        # at (r // n) * n_src of the flat spike vector.
        n_src = area_spikes.shape[-1]
        flat = area_spikes.reshape(-1)
        src, w, d = (x.reshape(a * n, k)
                     for x in (net.src_intra, net.w_intra, net.delay_intra))

        def chunk(r0, r1):
            base = torch.arange(r0, r1, device=ring.device)[:, None] // n * n_src
            return w[r0:r1] * flat[base + src[r0:r1].long()], d[r0:r1]

        _scatter_rows(ring.view(a * n, r), k, chunk, t)
        return ring
    src = net.src_intra.reshape(a, n * k).long()
    vals = net.w_intra * torch.gather(area_spikes, 1, src).view(a, n, k)
    return _deposit_onehot(ring, vals, net.delay_intra, t)


def deliver_inter(
    ring: torch.Tensor,         # [A, n, R] target rows, updated in place
    flat_spikes: torch.Tensor,  # [N_global] f32 global spike vector
    net: Network,
    t: int,
    *,
    backend: str,
    s_max: int | None = None,
) -> torch.Tensor:
    """One cycle of inter-area (long-range pathway) delivery; ``s_max``
    bounds the whole network's packet on the event backend."""
    a, n, r = ring.shape
    k = net.k_inter
    if k == 0:
        return ring
    if backend == "event":
        k_out = net.tgt_inter.shape[-1]
        kops.event_deliver(
            ring.view(a * n, r), flat_spikes > 0, net.tgt_inter.view(a * n, k_out),
            net.wout_inter.view(a * n, k_out), net.dout_inter.view(a * n, k_out),
            t, s_max=s_max)
        return ring
    if backend == "pallas":
        contrib = kops.spike_deliver(
            flat_spikes, net.src_inter.view(a * n, k),
            net.w_inter.view(a * n, k), net.delay_inter.view(a * n, k),
            steps_lo=net.steps_lo_inter, r_span=net.r_span_inter)
        kops.apply_contrib(ring.view(a * n, r), contrib, t, net.steps_lo_inter)
        return ring
    if backend == "scatter":
        src, w, d = (x.reshape(a * n, k)
                     for x in (net.src_inter, net.w_inter, net.delay_inter))
        _scatter_rows(ring.view(a * n, r), k,
                      lambda r0, r1: (w[r0:r1] * flat_spikes[src[r0:r1].long()], d[r0:r1]), t)
        return ring
    vals = net.w_inter * flat_spikes[net.src_inter.long()]
    return _deposit_onehot(ring, vals, net.delay_inter, t)


def deliver_inter_block(
    ring: torch.Tensor,   # [A, n, R] target rows, updated in place
    block: torch.Tensor,  # [D, N_global] f32 global spike vectors, one per cycle
    net: Network,
    t0: int,              # cycle s of the block was emitted at t0 + s
    *,
    backend: str,
    s_max: int | None = None,
) -> torch.Tensor:
    """One lumped window of inter-area delivery in a single pass.

    Cycle ``s`` behaves exactly like ``deliver_inter(..., t0 + s)``. The
    event backend compacts each cycle into an id packet of ``s_max`` (an
    ``(id, step)`` packet of bound ``D * s_max``) and scatters all of them
    in one launch. The pallas backend makes D kernel launches and
    accumulates their ``[N, r_span]`` contributions, shifted by ``s``, into
    one ``[N, D-1+r_span]`` buffer in place, added into the ring once; the
    dense backends fold the cycle axis into the synapse axis and deposit
    once (the scatter backend row chunk by row chunk).
    """
    a, n, r = ring.shape
    k = net.k_inter
    d_win = block.shape[0]
    if k == 0:
        return ring
    if backend == "event":
        # One packet per cycle; positions are global ids on the single
        # host's whole-network view.
        fired = kops.sized_nonzero(block > 0, size=s_max, fill=a * n)
        k_out = net.tgt_inter.shape[-1]
        kops.event_deliver_block(
            ring.view(a * n, r), fired, net.tgt_inter.view(a * n, k_out),
            net.wout_inter.view(a * n, k_out), net.dout_inter.view(a * n, k_out), t0)
        return ring
    if backend == "pallas":
        span = net.r_span_inter
        wide = torch.zeros((a * n, d_win - 1 + span), dtype=torch.float32,
                           device=ring.device)
        for s in range(d_win):
            wide[:, s:s + span] += kops.spike_deliver(
                block[s], net.src_inter.view(a * n, k),
                net.w_inter.view(a * n, k), net.delay_inter.view(a * n, k),
                steps_lo=net.steps_lo_inter, r_span=span)
        kops.apply_contrib(ring.view(a * n, r), wide, t0, net.steps_lo_inter)
        return ring
    if backend == "scatter":
        # The cycle axis folded into the synapse axis, row chunk by row
        # chunk: cycle s's synapses deposit at delay + s from t0.
        src, w, d = (x.reshape(a * n, k)
                     for x in (net.src_inter, net.w_inter, net.delay_inter))
        shift = torch.arange(d_win, device=ring.device)[None, :, None]

        def chunk(r0, r1):
            vals = w[r0:r1, None] * block[:, src[r0:r1].long()].movedim(0, 1)
            delays = d[r0:r1, None].long() + shift
            return vals.reshape(r1 - r0, d_win * k), delays.reshape(r1 - r0, d_win * k)

        _scatter_rows(ring.view(a * n, r), d_win * k, chunk, t0)
        return ring
    if a * n * d_win * k * r > ONEHOT_FOLD_LIMIT:
        for s in range(d_win):
            vals = net.w_inter * block[s][net.src_inter.long()]
            _deposit_onehot(ring, vals, net.delay_inter, t0 + s)
        return ring
    vals = net.w_inter[None] * block[:, net.src_inter.long()]      # [D, A, n, K]
    delays = net.delay_inter[None].long() + torch.arange(
        d_win, device=ring.device)[:, None, None, None]             # [D, A, n, K]
    vals = torch.movedim(vals, 0, 2).reshape(a, n, d_win * k)
    delays = torch.movedim(delays, 0, 2).reshape(a, n, d_win * k)
    return _deposit_onehot(ring, vals, delays, t0)


# ---------------------------------------------------------------------------
# Sparse id packets: the event path's wire format.
# ---------------------------------------------------------------------------


def compact_fired(
    fired: torch.Tensor,  # [...] bool
    ids: torch.Tensor,    # [...] int payload per neuron (e.g. global ids)
    *,
    s_max: int,
    invalid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact fired neurons into one id packet: ``(packet [s_max] int32,
    count int32)``. The packet holds the ``ids`` of the first ``s_max``
    fired neurons, padded with ``invalid``; ``count > s_max`` means it
    dropped spikes."""
    packet, count = kops.compact_ids_block(
        fired.reshape(1, -1), ids.reshape(1, -1), size=s_max, fill_id=invalid)
    return packet[0], count[0]


def compact_fired_block(
    fired: torch.Tensor,  # [D, ...] bool -- one window of spike rasters
    ids: torch.Tensor,    # [...] int payload per neuron
    *,
    s_max: int,
    invalid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a whole window, one packet per cycle: ``(packets [D, s_max]
    int32, counts [D] int32)``. The same spikes survive as in D per-cycle
    :func:`compact_fired` calls."""
    d_win = fired.shape[0]
    return kops.compact_ids_block(
        fired.reshape(d_win, -1), ids.reshape(-1), size=s_max, fill_id=invalid)
