"""Spike exchange: how spikes travel between engine shards.

Port of ``repro.core.exchange`` for the single host. The window core
(:mod:`repro_torch.core.schedule`) calls two hooks:

* ``cycle(ring, spikes, t, net, gids, inter_now=...)`` -- the per-cycle
  short-range pathway, and under the conventional schedule the long-range
  one too (``inter_now=True``);
* ``window_end(ring, block, t0, net, gids, blocked=...)`` -- the
  structure-aware schedule's lumped window-end long-range pathway.

Both return ``(ring', overflow_delta, shipped_bytes_delta)``. Only
:class:`LocalExchange` is ported; it ships nothing and, with the dense
backends it serves, drops nothing, so both deltas are 0. The mesh exchanges,
adaptive packet ladders and the overlapped window-end split are still to be
ported (see ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.core import delivery as delivery_lib
from repro_torch.core.connectivity import Network

__all__ = ["EXCHANGES", "Exchange", "LocalExchange"]

EXCHANGES = ("local", "dense", "routed")


class Exchange:
    """Interface; see the module docstring."""

    name = "abstract"

    def cycle(self, ring, spikes, t, net, gids, *, inter_now: bool):
        raise NotImplementedError

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        raise NotImplementedError


class LocalExchange(Exchange):
    """Single-host identity exchange: delivery without any wire."""

    name = "local"

    def __init__(self, net: Network, cfg):
        del net
        self.backend = cfg.backend

    def cycle(self, ring, spikes, t, net, gids, *, inter_now: bool):
        del gids
        sf = spikes.float()
        ring = delivery_lib.deliver_intra(ring, sf, net, t, backend=self.backend)
        if inter_now:
            ring = delivery_lib.deliver_inter(
                ring, sf.reshape(-1), net, t, backend=self.backend)
        return ring, 0, 0.0

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        del gids
        if net.k_inter == 0:
            return ring, 0, 0.0
        d_win = block.shape[0]
        flat = block.reshape(d_win, -1).float()
        if blocked:
            ring = delivery_lib.deliver_inter_block(
                ring, flat, net, t0, backend=self.backend)
        else:
            for s in range(d_win):
                ring = delivery_lib.deliver_inter(
                    ring, flat[s], net, t0 + s, backend=self.backend)
        return ring, 0, 0.0
