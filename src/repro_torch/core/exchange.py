"""Spike exchange: how spikes travel between engine shards.

Port of ``repro.core.exchange``. The window core
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

Two implementations:

* :class:`LocalExchange` -- the single host: no wire, 0 bytes shipped;
* :class:`DenseMeshExchange` -- the mesh collectives of the distributed
  engine (:mod:`repro_torch.core.dist_engine`): bit-packed spike vectors
  (:mod:`repro_torch.core.comm`) for the dense backends, compacted id
  packets for the event backend. Each rank runs the hooks on its own shard;
  the collectives make every rank receive what the JAX package's
  ``shard_map`` bodies receive.

The connectivity-routed exchange (``'routed'``) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import comm
from repro_torch.core import delivery as delivery_lib
from repro_torch.core.connectivity import Network
from repro_torch.core.schedule import CONVENTIONAL
from repro_torch.kernels import ops as kops

__all__ = ["EXCHANGES", "Exchange", "InflightWindow", "LocalExchange", "DenseMeshExchange",
           "ReceiveTables", "dense_wire_bytes"]

EXCHANGES = ("local", "dense", "routed")

_I32_BYTES = 4


class InflightWindow(NamedTuple):
    """A window's lumped long-range payload, started but not yet scattered.

    ``wire`` is the window's payload -- the ``[D, N]`` f32 spike block on a
    single host, the received id packets or gathered spike block on a mesh
    -- or None for an empty in-flight window (what a pipeline starts from
    and returns to after a drain): the host knows it is empty, so finishing
    it launches nothing.
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
        return InflightWindow(wire=None, t0=0)

    def wire_bytes(self, net: Network) -> dict:
        """Static mesh-total bytes received per window, by pathway."""
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

    def wire_bytes(self, net: Network) -> dict:
        return dict(exchange=self.name, local_bytes=0, global_bytes=0,
                    total_bytes=0, adaptive=self.adaptive)


class ReceiveTables(NamedTuple):
    """One pathway's receive tables on a rank of the mesh: for each source
    row (a packet id), its synapses onto this rank's neurons, targets as
    rows of the rank's flattened ring, ascending with the ``-1`` padding
    last (the event kernel's order). Built by the distributed engine from
    the rank's cut of the network; the JAX package maps targets to ring rows
    in the scatter (``tgt_map``) instead, with the same adds."""

    tgt: torch.Tensor  # [rows, K] int32
    w: torch.Tensor    # [rows, K] f32
    d: torch.Tensor    # [rows, K] int8/int32


class DenseMeshExchange(Exchange):
    """The mesh-wide collectives of the distributed engine, run by each rank
    on its own shard (the JAX package's ``shard_map`` bodies).

    Structure-aware placement: every cycle the local pathway completes each
    area over the subgroup axis (packed spike vectors on the dense backends,
    per-area id packets on ``event``); at the window's end the global
    pathway gathers the window's ``[D, ...]`` block over all ranks.
    Conventional placement: one gather over all ranks every cycle feeds both
    pathways.

    ``net`` gives the global shapes and the packet bounds (its ``alive`` and
    ``rate_hz`` are the whole network's); the hooks get the rank's view.
    ``recv_intra`` / ``recv_inter`` are the rank's :class:`ReceiveTables`
    (event backend). Overflow deltas are this rank's own spills; the engine
    sums them over the ranks once a window. Shipped bytes are mesh totals,
    the same on every rank (the adaptive rung is agreed by ``count_max``).
    """

    name = "dense"

    def __init__(self, net: Network, cfg, mesh, *, recv_intra: ReceiveTables | None = None,
                 recv_inter: ReceiveTables | None = None):
        self.backend = cfg.backend
        self.schedule = cfg.schedule
        self.mesh = mesh
        self.area_axes = tuple(mesh.axis_names[:-1])
        self.subgroup = mesh.axis_names[-1]
        self.all_axes = tuple(mesh.axis_names)
        self.n_dev = mesh.size
        self.gsz = mesh.shape[self.subgroup]
        self.n_groups = self.n_dev // self.gsz
        self.headroom = cfg.s_max_headroom
        self.floor = cfg.s_max_floor
        self.adaptive = cfg.adaptive_exchange
        self.recv_intra, self.recv_inter = recv_intra, recv_inter
        if self.backend == "event":
            self.s_max_loc, self.s_max_dev = _mesh_bounds(
                net, n_groups=self.n_groups, gsz=self.gsz,
                headroom=cfg.s_max_headroom, floor=cfg.s_max_floor)
        else:
            self.s_max_loc = self.s_max_dev = 0
        # Adaptive ladders, topped by the hard population bound of each
        # packet's scope: a lane's window of one area, a rank's whole shard.
        A, n_pad = net.n_areas, net.n_pad
        self.n_areas, self.n_pad = A, n_pad
        if self.schedule == CONVENTIONAL:
            n_loc = n_pad // self.n_dev if n_pad % self.n_dev == 0 else n_pad
            self.ladder_loc = None
            self.ladder_dev = delivery_lib.bucket_ladder(cfg.s_max_floor, A * n_loc)
            self.a_loc = A
        else:
            self.a_loc, n_loc = A // self.n_groups, n_pad // self.gsz
            self.ladder_loc = delivery_lib.bucket_ladder(cfg.s_max_floor, n_loc)
            self.ladder_dev = delivery_lib.bucket_ladder(cfg.s_max_floor, self.a_loc * n_loc)
        self.n_loc = n_loc
        # Static shipped bytes per hook, from the accounting the engine
        # reports (dense_wire_bytes): both totals carry a factor D.
        wb = dense_wire_bytes(net, backend=self.backend, schedule=self.schedule,
                              n_groups=self.n_groups, gsz=self.gsz,
                              headroom=self.headroom, floor=self.floor)
        d_win = max(net.delay_ratio, 1)
        if self.schedule == CONVENTIONAL:
            self._cycle_wire, self._window_wire = float(wb["global_bytes"] // d_win), 0.0
        else:
            self._cycle_wire = float(wb["local_bytes"] // d_win)
            self._window_wire = float(wb["global_bytes"])
        # The local pathway's within-area ids of this lane's neurons, and
        # each own area's first row in the flattened intra receive table.
        dev = mesh.device
        lane = mesh.axis_index(self.subgroup)
        self._lane_ids = lane * n_loc + torch.arange(n_loc, dtype=torch.int32, device=dev)
        self._area_base = torch.arange(self.a_loc, dtype=torch.int32, device=dev)[:, None] * n_pad

    def _count_max(self, count) -> int:
        return comm.count_max(count, self.mesh, self.all_axes)

    def _adaptive_bytes(self, per_rung: int, rung: int) -> float:
        return float(per_rung * _I32_BYTES) * rung + comm.count_wire_bytes(1, self.n_dev)

    # -- hooks --------------------------------------------------------------

    def cycle(self, ring, spikes, t, net, gids, *, inter_now: bool):
        if self.schedule == CONVENTIONAL:
            return self._cycle_conventional(ring, spikes, t, net, gids)
        assert not inter_now, "structure-aware lumps the global pathway"
        a_loc, n_loc = spikes.shape
        over, shipped = 0, self._cycle_wire
        if self.backend == "event" and net.k_intra > 0:
            # Local pathway, sparse wire: per-area id packets of this lane's
            # fired neurons, gathered over the subgroup, scattered through
            # the rank's intra receive table (one launch for all areas).
            def local_pathway(s_max, ring):
                packets, counts = kops.compact_ids_block(
                    spikes, self._lane_ids, size=s_max, fill_id=self.n_pad)
                wire = comm.all_gather(packets, self.mesh, self.subgroup, dim=1)
                ids = torch.where(wire < self.n_pad, wire + self._area_base,
                                  a_loc * self.n_pad).view(1, -1)
                kops.event_deliver_block(ring.view(a_loc * n_loc, ring.shape[-1]), ids,
                                         *self.recv_intra, t)
                return ring, counts

            if self.adaptive:
                need = self._count_max(spikes.sum(dim=-1, dtype=torch.int32).max())
                rung = kops.ladder_rung(self.ladder_loc, need)
                ring, _ = local_pathway(rung, ring)
                shipped = self._adaptive_bytes(self.n_dev * a_loc * (self.gsz - 1), rung)
            else:
                ring, counts = local_pathway(self.s_max_loc, ring)
                over = torch.clamp(counts - self.s_max_loc, min=0).sum(dtype=torch.int32)
        elif self.backend != "event":
            area_spikes = comm.gather_area(spikes.to(torch.int8), self.mesh,
                                           subgroup_axis=self.subgroup)
            ring = delivery_lib.deliver_intra(ring, area_spikes.float(), net, t,
                                              backend=self.backend)
        if net.k_intra == 0:
            shipped = 0.0
        return ring, over, shipped

    def _cycle_conventional(self, ring, spikes, t, net, gids):
        """One gather over all ranks feeds both pathways (round-robin cut)."""
        A, n_pad = self.n_areas, self.n_pad
        over, shipped = 0, self._cycle_wire
        if self.backend == "event":
            def exchange_cycle(s_max, ring):
                packet, count = delivery_lib.compact_fired(spikes, gids, s_max=s_max,
                                                           invalid=A * n_pad)
                wire = comm.all_gather(packet, self.mesh, self.all_axes, dim=0).view(1, -1)
                # Global ids index both receive tables' rows directly.
                flat = ring.view(-1, ring.shape[-1])
                if net.k_intra > 0:
                    kops.event_deliver_block(flat, wire, *self.recv_intra, t)
                if net.k_inter > 0:
                    kops.event_deliver_block(flat, wire, *self.recv_inter, t)
                return ring, count

            if self.adaptive:
                need = self._count_max(spikes.sum(dtype=torch.int32))
                rung = kops.ladder_rung(self.ladder_dev, need)
                ring, _ = exchange_cycle(rung, ring)
                shipped = self._adaptive_bytes(self.n_dev * (self.n_dev - 1), rung)
            else:
                ring, count = exchange_cycle(self.s_max_dev, ring)
                over = torch.clamp(count - self.s_max_dev, min=0)
        else:
            full = comm.gather_full(spikes.to(torch.int8), self.mesh, self.all_axes).float()
            ring = delivery_lib.deliver_intra(ring, full, net, t, backend=self.backend)
            ring = delivery_lib.deliver_inter(ring, full.reshape(-1), net, t,
                                              backend=self.backend)
        return ring, over, shipped

    def _ids_packets(self, block, gids, s_max):
        """The window's per-cycle id packets, gathered over all ranks:
        ``([D, n_dev * s_max] int32, this rank's counts [D])``."""
        packets, counts = delivery_lib.compact_fired_block(
            block, gids, s_max=s_max, invalid=self.n_areas * self.n_pad)
        return comm.all_gather(packets, self.mesh, self.all_axes, dim=1), counts

    def _receive(self, ring, wire, t0, net, *, blocked: bool):
        """Scatter a window's received payload into the rank's ring."""
        d_win = wire.shape[0]
        if self.backend == "event":
            flat = ring.view(-1, ring.shape[-1])
            if blocked:
                kops.event_deliver_block(flat, wire, *self.recv_inter, t0)
            else:
                for s in range(d_win):
                    kops.event_deliver_ids(flat, wire[s], *self.recv_inter, t0 + s)
            return ring
        gflat = wire.float().reshape(d_win, -1)
        if blocked:
            return delivery_lib.deliver_inter_block(ring, gflat, net, t0, backend=self.backend)
        for s in range(d_win):
            ring = delivery_lib.deliver_inter(ring, gflat[s], net, t0 + s, backend=self.backend)
        return ring

    def _start(self, block, gids):
        """The window-end collectives: ``(payload, overflow, shipped)``."""
        shipped = self._window_wire
        if self.backend != "event":
            gblock = comm.gather_global(block.to(torch.int8), self.mesh,
                                        area_axes=self.area_axes, subgroup_axis=self.subgroup)
            return gblock, 0, shipped
        d_win = block.shape[0]
        if self.adaptive:
            # Phase 1: the window's largest per-cycle count over the mesh;
            # phase 2: every cycle ships a rung-sized packet.
            need = self._count_max(block.reshape(d_win, -1).sum(dim=-1, dtype=torch.int32).max())
            rung = kops.ladder_rung(self.ladder_dev, need)
            wire, _ = self._ids_packets(block, gids, rung)
            return wire, 0, self._adaptive_bytes(self.n_dev * d_win * (self.n_dev - 1), rung)
        wire, counts = self._ids_packets(block, gids, self.s_max_dev)
        return wire, torch.clamp(counts - self.s_max_dev, min=0).sum(dtype=torch.int32), shipped

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        if net.k_inter == 0:
            return ring, 0, 0.0
        wire, over, shipped = self._start(block, gids)
        return self._receive(ring, wire, t0, net, blocked=blocked), over, shipped

    # -- overlapped pipeline split ------------------------------------------

    def start_window_end(self, block, t0, net, gids, *, blocked: bool):
        del blocked
        if net.k_inter == 0:
            return InflightWindow(wire=None, t0=t0), 0, 0.0
        wire, over, shipped = self._start(block, gids)
        return InflightWindow(wire=wire, t0=t0), over, shipped

    def finish_window_end(self, ring, inflight, net, gids, *, blocked: bool):
        del gids
        if net.k_inter == 0 or inflight.wire is None:
            return ring
        return self._receive(ring, inflight.wire, inflight.t0, net, blocked=blocked)

    def wire_bytes(self, net: Network) -> dict:
        rep = dense_wire_bytes(net, backend=self.backend, schedule=self.schedule,
                               n_groups=self.n_groups, gsz=self.gsz,
                               headroom=self.headroom, floor=self.floor)
        rep["adaptive_on"] = self.adaptive
        return rep


# ---------------------------------------------------------------------------
# Static wire accounting (mesh-total bytes received per window)
# ---------------------------------------------------------------------------


def _mesh_bounds(net: Network, *, n_groups, gsz, headroom, floor):
    """Per-rank event packet bounds ``(s_max_loc, s_max_dev)``: shares of the
    single-host bounds, floored."""
    s_max_area, s_max_all = delivery_lib.event_bounds(net, headroom=headroom, floor=floor)
    s_max_loc = max(floor, -(-s_max_area // gsz))
    s_max_dev = max(floor, -(-s_max_all // (n_groups * gsz)))
    return s_max_loc, s_max_dev


def dense_wire_bytes(
    net: Network, *, backend: str, schedule: str,
    n_groups: int, gsz: int, headroom: float = 8.0, floor: int = 16,
) -> dict:
    """Mesh-total received bytes per window of :class:`DenseMeshExchange`
    with static packets (the JAX package's accounting)."""
    n_dev = n_groups * gsz
    d_win = net.delay_ratio
    A, n_pad = net.n_areas, net.n_pad
    s_max_loc, s_max_dev = _mesh_bounds(net, n_groups=n_groups, gsz=gsz,
                                        headroom=headroom, floor=floor)
    if schedule == CONVENTIONAL:
        n_loc = n_pad // n_dev
        if backend == "event":
            glob = n_dev * d_win * (n_dev - 1) * s_max_dev * _I32_BYTES
        else:
            glob = n_dev * d_win * A * (n_dev - 1) * -(-n_loc // 8)
        return dict(exchange="dense", schedule=schedule, backend=backend,
                    local_bytes=0, global_bytes=glob, total_bytes=glob)
    a_loc, n_loc = A // n_groups, n_pad // gsz
    per = -(-n_loc // 8)  # packed bytes of one rank's shard of one area
    if net.k_intra == 0:
        local = 0
    elif backend == "event":
        local = n_dev * d_win * a_loc * (gsz - 1) * s_max_loc * _I32_BYTES
    else:
        local = n_dev * d_win * a_loc * (gsz - 1) * per
    if net.k_inter == 0:
        glob = 0
    elif backend == "event":
        glob = n_dev * d_win * (n_dev - 1) * s_max_dev * _I32_BYTES
    else:
        # gather_global: the subgroup stage, then the area axes' stages.
        glob = n_dev * d_win * a_loc * per * ((gsz - 1) + (n_groups - 1) * gsz)
    return dict(exchange="dense", schedule=schedule, backend=backend,
                local_bytes=local, global_bytes=glob, total_bytes=local + glob)
