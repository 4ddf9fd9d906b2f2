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
* ``"event"`` is not ported yet and raises ``NotImplementedError``.

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
    "deliver_intra",
    "deliver_inter",
    "deliver_inter_block",
]

BACKENDS = ("onehot", "scatter", "pallas", "event")

# deliver_inter_block folds the window's cycle axis into the synapse axis;
# for the one-hot backend that materialises an [N, D*K, R] tensor. Above
# this element count (1 GiB f32) the blocked call deposits per cycle.
ONEHOT_FOLD_LIMIT = 2**28

_EVENT_TODO = ("the 'event' delivery backend is not ported yet (ROADMAP: the "
               "event backend with outgoing tables); use 'pallas', 'scatter' "
               "or 'onehot'")


def _deposit(ring, vals, delays, t, *, onehot: bool):
    a, n, r = ring.shape
    k = vals.shape[-1]
    fn = ring_buffer.deposit if onehot else ring_buffer.deposit_scatter
    fn(ring.view(a * n, r), vals.reshape(a * n, k), delays.reshape(a * n, k), t)
    return ring


def deliver_intra(
    ring: torch.Tensor,         # [A, n, R] target rows, updated in place
    area_spikes: torch.Tensor,  # [A, n_src] f32 per-area spike vectors
    net: Network,
    t: int,
    *,
    backend: str,
) -> torch.Tensor:
    """One cycle of intra-area (short-range pathway) delivery."""
    a, n, r = ring.shape
    k = net.k_intra
    if k == 0:
        return ring
    if backend == "event":
        raise NotImplementedError(_EVENT_TODO)
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
    src = net.src_intra.reshape(a, n * k).long()
    vals = net.w_intra * torch.gather(area_spikes, 1, src).view(a, n, k)
    return _deposit(ring, vals, net.delay_intra, t, onehot=(backend == "onehot"))


def deliver_inter(
    ring: torch.Tensor,         # [A, n, R] target rows, updated in place
    flat_spikes: torch.Tensor,  # [N_global] f32 global spike vector
    net: Network,
    t: int,
    *,
    backend: str,
) -> torch.Tensor:
    """One cycle of inter-area (long-range pathway) delivery."""
    a, n, r = ring.shape
    k = net.k_inter
    if k == 0:
        return ring
    if backend == "event":
        raise NotImplementedError(_EVENT_TODO)
    if backend == "pallas":
        contrib = kops.spike_deliver(
            flat_spikes, net.src_inter.view(a * n, k),
            net.w_inter.view(a * n, k), net.delay_inter.view(a * n, k),
            steps_lo=net.steps_lo_inter, r_span=net.r_span_inter)
        kops.apply_contrib(ring.view(a * n, r), contrib, t, net.steps_lo_inter)
        return ring
    vals = net.w_inter * flat_spikes[net.src_inter.long()]
    return _deposit(ring, vals, net.delay_inter, t, onehot=(backend == "onehot"))


def deliver_inter_block(
    ring: torch.Tensor,   # [A, n, R] target rows, updated in place
    block: torch.Tensor,  # [D, N_global] f32 global spike vectors, one per cycle
    net: Network,
    t0: int,              # cycle s of the block was emitted at t0 + s
    *,
    backend: str,
) -> torch.Tensor:
    """One lumped window of inter-area delivery in a single pass.

    Cycle ``s`` behaves exactly like ``deliver_inter(..., t0 + s)``. The
    pallas backend makes D kernel launches and accumulates their
    ``[N, r_span]`` contributions, shifted by ``s``, into one
    ``[N, D-1+r_span]`` buffer in place, added into the ring once; the dense
    backends fold the cycle axis into the synapse axis and deposit once.
    """
    a, n, r = ring.shape
    k = net.k_inter
    d_win = block.shape[0]
    if k == 0:
        return ring
    if backend == "event":
        raise NotImplementedError(_EVENT_TODO)
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
    if backend == "onehot" and a * n * d_win * k * r > ONEHOT_FOLD_LIMIT:
        for s in range(d_win):
            vals = net.w_inter * block[s][net.src_inter.long()]
            _deposit(ring, vals, net.delay_inter, t0 + s, onehot=True)
        return ring
    vals = net.w_inter[None] * block[:, net.src_inter.long()]      # [D, A, n, K]
    delays = net.delay_inter[None].long() + torch.arange(
        d_win, device=ring.device)[:, None, None, None]             # [D, A, n, K]
    vals = torch.movedim(vals, 0, 2).reshape(a, n, d_win * k)
    delays = torch.movedim(delays, 0, 2).reshape(a, n, d_win * k)
    return _deposit(ring, vals, delays, t0, onehot=(backend == "onehot"))
