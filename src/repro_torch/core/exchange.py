"""Spike exchange: how spikes travel between engine shards.

Port of ``repro.core.exchange`` for the single host. The window core
(:mod:`repro_torch.core.schedule`) calls two hooks:

* ``cycle(ring, spikes, t, net, gids, inter_now=...)`` -- the per-cycle
  short-range pathway, and under the conventional schedule the long-range
  one too (``inter_now=True``);
* ``window_end(ring, block, t0, net, gids, blocked=...)`` -- the
  structure-aware schedule's lumped window-end long-range pathway.

Both return ``(ring', overflow_delta, shipped_bytes_delta)``. The overflow
delta counts the spikes a fixed-size event packet dropped: a device scalar
on the event backend (reading it would wait for the device every cycle), 0
on the dense backends. The overlapped pipeline splits ``window_end`` into
``start_window_end`` (all accounting; returns an :class:`InflightWindow`)
and ``finish_window_end`` (the receive scatter, run at the top of the next
window or by a drain).

Only :class:`LocalExchange` is ported; it ships nothing, so the shipped
bytes are 0. The mesh exchanges are still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import delivery as delivery_lib
from repro_torch.core.connectivity import Network
from repro_torch.kernels import ops as kops

__all__ = ["EXCHANGES", "Exchange", "InflightWindow", "LocalExchange"]

EXCHANGES = ("local", "dense", "routed")


class InflightWindow(NamedTuple):
    """A window's lumped long-range payload, started but not yet scattered.

    ``wire`` is the window's ``[D, N]`` f32 spike block, or None for an empty
    in-flight window (what a pipeline starts from and returns to after a
    drain): the host knows it is empty, so finishing it launches nothing.
    ``t0`` is the window's start step, the scatter's time base.
    """

    wire: torch.Tensor | None
    t0: int


class Exchange:
    """Interface; see the module docstring."""

    name = "abstract"
    adaptive = False

    def cycle(self, ring, spikes, t, net, gids, *, inter_now: bool):
        raise NotImplementedError

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        raise NotImplementedError

    def start_window_end(self, block, t0, net, gids, *, blocked: bool):
        """Assemble window ``[t0, t0+D)``'s long-range payload; returns
        ``(InflightWindow, overflow_delta, shipped_bytes_delta)``."""
        raise NotImplementedError

    def finish_window_end(self, ring, inflight, net, gids, *, blocked: bool):
        """Scatter an in-flight window's payload into ``ring``; returns it."""
        raise NotImplementedError

    def init_inflight(self, net: Network) -> InflightWindow:
        """An empty in-flight window (scatters nothing)."""
        raise NotImplementedError


class LocalExchange(Exchange):
    """Single-host identity exchange: delivery without any wire, with the
    event backend's per-area / whole-network packet bounds and their
    overflow accounting.

    Under ``adaptive_exchange`` the event packets are sized by the bucket
    ladders instead: the smallest rung that covers the counted need, read on
    the host (one device sync per packet), with the hard population cap on
    top, so nothing is ever dropped.
    """

    name = "local"

    def __init__(self, net: Network, cfg):
        self.backend = cfg.backend
        self.adaptive = cfg.adaptive_exchange
        self.s_max_area, self.s_max_all = delivery_lib.event_bounds(
            net, headroom=cfg.s_max_headroom, floor=cfg.s_max_floor,
            burst_factor=cfg.s_max_burst)
        a, n_pad = net.alive.shape
        self.ladder_area = delivery_lib.bucket_ladder(cfg.s_max_floor, n_pad)
        self.ladder_all = delivery_lib.bucket_ladder(cfg.s_max_floor, a * n_pad)

    @property
    def _ladders(self) -> bool:
        return self.backend == "event" and self.adaptive

    def _overflow(self, spikes, net, inter_now: bool):
        """Spikes dropped by the event path's static packet bounds."""
        if self.backend != "event" or self.adaptive:
            return 0
        per_area = spikes.sum(dim=-1, dtype=torch.int32)  # [A]
        over = 0
        if net.k_intra > 0:
            over = torch.clamp(per_area - self.s_max_area, min=0).sum(dtype=torch.int32)
        if inter_now and net.k_inter > 0:
            over = over + torch.clamp(per_area.sum(dtype=torch.int32) - self.s_max_all, min=0)
        return over

    def _window_overflow(self, block):
        """Per-cycle spill of a window's lumped packets (static event path)."""
        if self.backend != "event" or self.adaptive:
            return 0
        counts = block.reshape(block.shape[0], -1).sum(dim=-1, dtype=torch.int32)
        return torch.clamp(counts - self.s_max_all, min=0).sum(dtype=torch.int32)

    def cycle(self, ring, spikes, t, net, gids, *, inter_now: bool):
        del gids
        sf = spikes.float()
        if self._ladders:
            per_area = spikes.sum(dim=-1, dtype=torch.int32)
            ring = kops.ladder_switch(
                self.ladder_area, per_area.max(),
                lambda b, r: delivery_lib.deliver_intra(
                    r, sf, net, t, backend=self.backend, s_max=b),
                ring)
            if inter_now:
                ring = kops.ladder_switch(
                    self.ladder_all, per_area.sum(),
                    lambda b, r: delivery_lib.deliver_inter(
                        r, sf.reshape(-1), net, t, backend=self.backend, s_max=b),
                    ring)
            return ring, 0, 0.0
        ring = delivery_lib.deliver_intra(
            ring, sf, net, t, backend=self.backend, s_max=self.s_max_area)
        if inter_now:
            ring = delivery_lib.deliver_inter(
                ring, sf.reshape(-1), net, t, backend=self.backend, s_max=self.s_max_all)
        return ring, self._overflow(spikes, net, inter_now), 0.0

    def _deliver_window(self, ring, flat, t0, net, *, blocked: bool):
        """The lumped long-range delivery of a ``[D, N]`` f32 block."""
        s_max = self.s_max_all
        if self._ladders:
            counts = (flat > 0).sum(dim=-1, dtype=torch.int32)
            s_max = kops.ladder_rung(self.ladder_all, counts.max())
        if blocked:
            return delivery_lib.deliver_inter_block(
                ring, flat, net, t0, backend=self.backend, s_max=s_max)
        for s in range(flat.shape[0]):
            ring = delivery_lib.deliver_inter(
                ring, flat[s], net, t0 + s, backend=self.backend, s_max=s_max)
        return ring

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        del gids
        if net.k_inter == 0:
            return ring, 0, 0.0
        flat = block.reshape(block.shape[0], -1).float()
        ring = self._deliver_window(ring, flat, t0, net, blocked=blocked)
        return ring, self._window_overflow(block), 0.0

    # -- overlapped pipeline split ------------------------------------------

    def start_window_end(self, block, t0, net, gids, *, blocked: bool):
        del gids, blocked
        if net.k_inter == 0:
            return InflightWindow(wire=None, t0=t0), 0, 0.0
        flat = block.reshape(block.shape[0], -1).float()
        return InflightWindow(wire=flat, t0=t0), self._window_overflow(block), 0.0

    def finish_window_end(self, ring, inflight, net, gids, *, blocked: bool):
        del gids
        if net.k_inter == 0 or inflight.wire is None:
            return ring
        return self._deliver_window(ring, inflight.wire, inflight.t0, net, blocked=blocked)

    def init_inflight(self, net: Network) -> InflightWindow:
        del net
        return InflightWindow(wire=None, t0=0)
