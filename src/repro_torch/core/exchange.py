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

Three implementations:

* :class:`LocalExchange` -- the single host: no wire, 0 bytes shipped;
* :class:`DenseMeshExchange` -- the mesh collectives of the distributed
  engine (:mod:`repro_torch.core.dist_engine`): bit-packed spike vectors
  (:mod:`repro_torch.core.comm`) for the dense backends, compacted id
  packets for the event backend. Each rank runs the hooks on its own shard;
  the collectives make every rank receive what the JAX package's
  ``shard_map`` bodies receive.
* :class:`RoutedExchange` -- the connectivity-routed global pathway: the
  area adjacency folded onto the device-group graph (:func:`build_routing`),
  and at each window's end id packets shipped only along group -> group
  edges that exist, one ``comm.ppermute`` rotation round per offset that
  crosses an edge, each packet compacted per destination group under a
  per-edge bound whose spill feeds ``SimState.overflow``.

The wire reports (:func:`dense_wire_bytes`, :func:`routed_wire_bytes`,
:func:`adaptive_wire_bytes`, :func:`inter_table_report`,
:func:`priced_inter_table_report`, :func:`wire_report`) are the JAX
package's static accounting: shape arithmetic on the host, no device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core import delivery as delivery_lib
from repro_torch.core.connectivity import Network
from repro_torch.core.schedule import CONVENTIONAL, STRUCTURE_AWARE
from repro_torch.kernels import ops as kops

__all__ = ["EXCHANGES", "Exchange", "InflightWindow", "LocalExchange", "DenseMeshExchange",
           "RoutedExchange", "ReceiveTables", "RouteRound", "Routing", "build_routing",
           "dense_wire_bytes", "routed_wire_bytes", "adaptive_wire_bytes",
           "inter_table_report", "priced_inter_table_report", "wire_report"]

EXCHANGES = ("local", "dense", "routed")

_I32_BYTES = 4


# ---------------------------------------------------------------------------
# Group routing tables (the connectivity-derived structure of RoutedExchange)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouteRound:
    """One ppermute rotation round of the routed global pathway."""

    offset: int                           # destination group = (g + offset) % G
    pairs: tuple[tuple[int, int], ...]    # existing edges at this offset
    s_max: int                            # per-edge packet bound (ids/cycle)


@dataclasses.dataclass(frozen=True)
class Routing:
    """Per-destination-group routing tables over the area adjacency.

    ``proj[a, h]``: does source area ``a`` project into any area of group
    ``h`` (groups own ``A / n_groups`` consecutive areas, row-major over the
    mesh's area axes). ``group_adj[g, h]``: the folded group graph.
    ``rounds`` holds only the rotation offsets that cross at least one edge.
    """

    n_groups: int
    proj: np.ndarray        # [A, G] bool
    group_adj: np.ndarray   # [G, G] bool
    rounds: tuple[RouteRound, ...]

    @property
    def n_edges(self) -> int:
        return int(self.group_adj.sum())

    @property
    def n_wire_rounds(self) -> int:
        """Rounds that move bytes (offset 0 stays in the group)."""
        return sum(1 for r in self.rounds if r.offset != 0)


def build_routing(
    adj: np.ndarray,
    n_groups: int,
    *,
    exp_area_spikes: float,
    headroom: float,
    floor: int,
    intra_tier: int | None = None,
) -> Routing:
    """Fold the ``[A, A]`` area adjacency onto ``n_groups`` device groups.

    Each edge's packet bound is ``headroom x exp_area_spikes x`` (the source
    areas projecting along it) ``+ 4 x floor``; absent edges get no packet.
    ``intra_tier`` (groups per pod) orders the rounds hierarchically: the
    group-local offset 0, then the offsets whose edges all stay inside a
    pod, then the pod-crossing ones. Ordering only: each round ships the
    same packets either way.
    """
    adj = np.asarray(adj, dtype=bool)
    a = adj.shape[0]
    if a % n_groups != 0:
        raise ValueError(f"n_areas={a} not divisible by n_groups={n_groups}")
    a_loc = a // n_groups
    proj = adj.reshape(a, n_groups, a_loc).any(axis=2)          # [A, G]
    group_adj = proj.reshape(n_groups, a_loc, n_groups).any(axis=1)
    n_src = proj.reshape(n_groups, a_loc, n_groups).sum(axis=1)  # [G, G]
    slack = 4 * max(floor, 1)
    rounds = []
    for k in range(n_groups):
        pairs = tuple((g, (g + k) % n_groups) for g in range(n_groups)
                      if group_adj[g, (g + k) % n_groups])
        if not pairs:
            continue
        s_max = max(int(headroom * exp_area_spikes * n_src[g, h]) + slack for g, h in pairs)
        rounds.append(RouteRound(offset=k, pairs=pairs, s_max=s_max))
    if intra_tier is not None and 0 < intra_tier < n_groups:
        def tier(rnd: RouteRound) -> int:
            if rnd.offset == 0:
                return 0
            if all(g // intra_tier == h // intra_tier for g, h in rnd.pairs):
                return 1
            return 2
        rounds.sort(key=lambda r: (tier(r), r.offset))
    return Routing(n_groups=n_groups, proj=proj, group_adj=group_adj, rounds=tuple(rounds))


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
                # reshape: a one-id packet gathers into a transposed view.
                ids = torch.where(wire < self.n_pad, wire + self._area_base,
                                  a_loc * self.n_pad).reshape(1, -1)
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
                wire = comm.all_gather(packet, self.mesh, self.all_axes, dim=0).reshape(1, -1)
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
        kw = dict(backend=self.backend, schedule=self.schedule, n_groups=self.n_groups,
                  gsz=self.gsz, headroom=self.headroom, floor=self.floor)
        rep = dense_wire_bytes(net, **kw)
        rep["adaptive"] = adaptive_wire_bytes(net, **kw)
        rep["adaptive_on"] = self.adaptive
        return rep


class RoutedExchange(DenseMeshExchange):
    """The connectivity-routed global pathway (see the module docstring).

    The local pathway is :class:`DenseMeshExchange`'s. At the window's end
    each rank compacts its fired ids, the subgroup completes the group's
    packet, and every rotation round re-compacts it for its destination
    group (only ids whose source area projects along the edge, bound
    ``RouteRound.s_max``), ships it by ``comm.ppermute`` along the edges
    that exist, and the arrivals scatter through the rank's inter receive
    tables (event_deliver, on every delivery backend: the routed wire is id
    packets). The static path scatters all rounds at once; the adaptive
    path sizes each packet from the gathered ``[D, A]`` count table, which
    every rank reads alike, and scatters each round on arrival.

    Each rank holds its own ``[D, L]`` in-flight wire (the reference keeps a
    leading group axis in its global in-flight state). An edge's spill is
    counted by subgroup lane 0 only: every lane of a group compacts the
    same packet.
    """

    name = "routed"

    def __init__(self, net: Network, cfg, mesh, adjacency: np.ndarray, *,
                 recv_intra: ReceiveTables | None = None,
                 recv_inter: ReceiveTables | None = None):
        if cfg.schedule != STRUCTURE_AWARE:
            raise ValueError(
                "RoutedExchange routes the structure-aware window's lumped "
                "global pathway; the conventional schedule has none")
        super().__init__(net, cfg, mesh, recv_intra=recv_intra, recv_inter=recv_inter)
        if net.k_inter > 0 and recv_inter is None:
            raise ValueError(
                "RoutedExchange ships id packets and scatters them through the "
                "rank's inter receive tables, on every delivery backend")
        # The routed global pathway ships id packets on every backend, so the
        # device bound exists for the dense ones too.
        if self.backend != "event":
            _, self.s_max_dev = _mesh_bounds(net, n_groups=self.n_groups, gsz=self.gsz,
                                             headroom=cfg.s_max_headroom,
                                             floor=cfg.s_max_floor)
        # Hierarchical round order on a multi-pod mesh: the leading area
        # axis is the pod tier.
        intra_tier = (self.n_groups // mesh.shape[self.area_axes[0]]
                      if len(self.area_axes) > 1 else None)
        self.routing = build_routing(
            adjacency, self.n_groups, exp_area_spikes=delivery_lib.expected_area_spikes(net),
            headroom=cfg.s_max_headroom, floor=cfg.s_max_floor, intra_tier=intra_tier)
        G, A, n_pad = self.n_groups, self.n_areas, self.n_pad
        a_grp = A // G
        self.invalid = A * n_pad
        # The edge ladder tops out at a whole source group's population; each
        # round's [G, A/G] mask picks the areas feeding its edges out of the
        # phase-1 count table.
        self.ladder_edge = delivery_lib.bucket_ladder(cfg.s_max_floor, a_grp * n_pad)
        proj_r = self.routing.proj.reshape(G, a_grp, G)
        self._round_masks = {
            rnd.offset: np.stack([proj_r[g, :, (g + rnd.offset) % G] for g in range(G)])
            .astype(np.int64) for rnd in self.routing.rounds}
        g = 0
        for ax in self.area_axes:
            g = g * mesh.shape[ax] + mesh.axis_index(ax)
        self.lane0 = mesh.axis_index(self.subgroup) == 0
        # Per round: which source areas (row A: the fill id) project into
        # this rank's destination group at that offset.
        proj = np.concatenate([self.routing.proj, np.zeros((1, G), bool)], axis=0)
        self._keep = {rnd.offset: torch.as_tensor(proj[:, (g + rnd.offset) % G],
                                                  device=mesh.device)
                      for rnd in self.routing.rounds}
        self._window_wire = float(routed_wire_bytes(
            net, self.routing, backend=self.backend, gsz=self.gsz,
            headroom=self.headroom, floor=self.floor)["global_bytes"])
        comm.warm_point_to_point(mesh)

    def _assemble(self, block, gids, size):
        """The group's window packet: this rank's ``[D, size]`` fired ids,
        completed over the subgroup to ``[D, gsz * size]``; and this rank's
        counts ``[D]``."""
        packets, counts = delivery_lib.compact_fired_block(block, gids, s_max=size,
                                                           invalid=self.invalid)
        return comm.all_gather(packets, self.mesh, self.subgroup, dim=1), counts

    def _edge_packet(self, rnd: RouteRound, gwire, size):
        """Round ``rnd``'s packet: the ids whose source area projects into
        the destination group, compacted to ``[D, size]`` and shipped along
        the round's edges; ``(received, this rank's kept counts [D])``. A
        rank with no inbound edge at the offset receives the fill id."""
        src_area = torch.where(gwire < self.invalid, gwire // self.n_pad, self.n_areas).long()
        pkt, cnt = kops.compact_ids_block(self._keep[rnd.offset][src_area], gwire, size=size,
                                          fill_id=self.invalid)
        if rnd.offset:
            pkt = comm.ppermute(pkt, self.mesh, self.area_axes, rnd.pairs, fill=self.invalid)
        return pkt, cnt

    def _static(self, block, gids):
        """Static packets: ``(wire [D, sum of s_max], overflow, shipped)``."""
        gwire, counts = self._assemble(block, gids, self.s_max_dev)
        over = torch.clamp(counts - self.s_max_dev, min=0).sum(dtype=torch.int32)
        received = []
        for rnd in self.routing.rounds:
            pkt, cnt = self._edge_packet(rnd, gwire, rnd.s_max)
            if self.lane0:
                over = over + torch.clamp(cnt - rnd.s_max, min=0).sum(dtype=torch.int32)
            received.append(pkt)
        return torch.cat(received, dim=1), over, self._window_wire

    def _adaptive(self, block, gids, on_round):
        """The two-phase window: the ``[D, A]`` count table and the device
        maximum (phase 1), then the group packet at its rung and every round
        at the rung its edges' exact need selects, each handed to
        ``on_round`` on arrival. Returns the shipped bytes."""
        d_win = block.shape[0]
        counts_local = block.sum(dim=-1, dtype=torch.int32)          # [D, a_loc]
        counts_all = comm.gather_counts(counts_local, self.mesh, area_axes=self.area_axes,
                                        subgroup_axis=self.subgroup)  # [D, A]
        dev_need = self._count_max(counts_local.sum(dim=-1).max())
        shipped = float(comm.count_wire_bytes(d_win * self.n_areas + 1, self.n_dev))
        rung_dev = kops.ladder_rung(self.ladder_dev, dev_need)
        gwire, _ = self._assemble(block, gids, rung_dev)
        shipped += float(self.n_dev * (self.gsz - 1) * d_win * _I32_BYTES) * rung_dev
        # Every rank holds the same table, so every rank picks the same rungs.
        # A dry run's meta table has no counts to read: every edge takes its
        # bound, the ladder's top (the size the JAX package compiles for).
        cg = (None if counts_all.is_meta else
              counts_all.cpu().numpy().astype(np.int64).reshape(d_win, self.n_groups, -1))
        for rnd in self.routing.rounds:
            if cg is None:
                rung = self.ladder_edge[-1]
            else:
                need = int((cg * self._round_masks[rnd.offset][None]).sum(axis=-1).max())
                rung = kops.ladder_rung(self.ladder_edge, need)
            pkt, _ = self._edge_packet(rnd, gwire, rung)
            on_round(pkt)
            if rnd.offset:
                shipped += float(len(rnd.pairs) * self.gsz * d_win * _I32_BYTES) * rung
        return shipped

    def _scatter(self, ring, wire, t0):
        a_loc, n_loc, r_len = ring.shape
        kops.event_deliver_block(ring.view(a_loc * n_loc, r_len), wire, *self.recv_inter, t0)
        return ring

    def window_end(self, ring, block, t0, net, gids, *, blocked: bool):
        # The routed receive is always one blocked scatter a round set; a
        # window of per-cycle scatters would add the same (1/256 grid).
        del blocked
        if net.k_inter == 0 or not self.routing.rounds:
            return ring, 0, 0.0
        ring = ring.contiguous()
        if self.adaptive:
            return ring, 0, self._adaptive(block, gids, lambda p: self._scatter(ring, p, t0))
        wire, over, shipped = self._static(block, gids)
        return self._scatter(ring, wire, t0), over, shipped

    def start_window_end(self, block, t0, net, gids, *, blocked: bool):
        del blocked
        if net.k_inter == 0 or not self.routing.rounds:
            return InflightWindow(wire=None, t0=t0), 0, 0.0
        if self.adaptive:
            received = []
            shipped = self._adaptive(block, gids, received.append)
            return InflightWindow(wire=torch.cat(received, dim=1), t0=t0), 0, shipped
        wire, over, shipped = self._static(block, gids)
        return InflightWindow(wire=wire, t0=t0), over, shipped

    def finish_window_end(self, ring, inflight, net, gids, *, blocked: bool):
        del gids, blocked
        if net.k_inter == 0 or inflight.wire is None:
            return ring
        return self._scatter(ring.contiguous(), inflight.wire, inflight.t0)

    def wire_bytes(self, net: Network) -> dict:
        rep = routed_wire_bytes(net, self.routing, backend=self.backend, gsz=self.gsz,
                                headroom=self.headroom, floor=self.floor)
        rep["adaptive"] = adaptive_wire_bytes(
            net, backend=self.backend, schedule=STRUCTURE_AWARE, n_groups=self.n_groups,
            gsz=self.gsz, headroom=self.headroom, floor=self.floor, routing=self.routing)
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


def routed_wire_bytes(
    net: Network, routing: Routing, *, backend: str,
    gsz: int, headroom: float = 8.0, floor: int = 16,
) -> dict:
    """Mesh-total received bytes per window of :class:`RoutedExchange` with
    static packets: the dense structure-aware local pathway, and for the
    global pathway the subgroup assembly plus one ``[D, s_max]`` id packet
    per existing edge per subgroup lane (offsets with no edge ship
    nothing)."""
    n_groups = routing.n_groups
    n_dev = n_groups * gsz
    d_win = net.delay_ratio
    base = dense_wire_bytes(net, backend=backend, schedule=STRUCTURE_AWARE,
                            n_groups=n_groups, gsz=gsz, headroom=headroom, floor=floor)
    _, s_max_dev = _mesh_bounds(net, n_groups=n_groups, gsz=gsz, headroom=headroom,
                                floor=floor)
    if net.k_inter == 0:
        glob = 0
    else:
        assembly = n_dev * (gsz - 1) * d_win * s_max_dev * _I32_BYTES
        edges = sum(len(r.pairs) * gsz * d_win * r.s_max * _I32_BYTES
                    for r in routing.rounds if r.offset != 0)
        glob = assembly + edges
    return dict(exchange="routed", schedule=STRUCTURE_AWARE, backend=backend,
                local_bytes=base["local_bytes"], global_bytes=glob,
                total_bytes=base["local_bytes"] + glob,
                rounds=routing.n_wire_rounds,
                dense_rounds=max(n_groups - 1, 0),
                edges=routing.n_edges)


def adaptive_wire_bytes(
    net: Network,
    *,
    backend: str,
    schedule: str = STRUCTURE_AWARE,
    n_groups: int,
    gsz: int,
    headroom: float = 8.0,
    floor: int = 16,
    routing: Routing | None = None,
) -> dict:
    """The adaptive two-phase exchange's byte model (the JAX package's).

    Per window: ``counts_bytes`` (the phase-1 count collectives),
    ``payload_bytes_expected`` (phase-2 packets at the rung an
    expectation-sized window lands on, :func:`~repro_torch.core.delivery.
    expected_bucket`), ``payload_bytes_worst`` (every ladder at its top
    rung), ``saved_bytes`` (the expected window's saving against the static
    packets). ``applies=False`` marks a wire with no id packets to size
    (the dense exchange's bit-packed backends): the numbers restate the
    static case."""
    n_dev = n_groups * gsz
    d_win = net.delay_ratio
    A, n_pad = net.n_areas, net.n_pad
    exp_area = delivery_lib.expected_area_spikes(net)
    if routing is not None:
        static = routed_wire_bytes(net, routing, backend=backend, gsz=gsz,
                                   headroom=headroom, floor=floor)
    else:
        static = dense_wire_bytes(net, backend=backend, schedule=schedule, n_groups=n_groups,
                                  gsz=gsz, headroom=headroom, floor=floor)
    out = dict(
        exchange=static["exchange"], backend=backend, applies=False,
        static_total_bytes=static["total_bytes"], counts_bytes=0,
        payload_bytes_expected=static["total_bytes"],
        payload_bytes_worst=static["total_bytes"],
        total_bytes_expected=static["total_bytes"],
        saved_bytes=0, buckets={},
    )
    if routing is None and backend != "event":
        return out  # the bit-packed dense wire: nothing to size
    out["applies"] = True
    buckets: dict = {}
    counts = payload_exp = payload_worst = 0
    if schedule == CONVENTIONAL:
        n_loc = n_pad // n_dev
        ladder = delivery_lib.bucket_ladder(floor, A * n_loc)
        b = delivery_lib.expected_bucket(ladder, exp_area * A / n_dev)
        buckets["device"] = b
        counts = d_win * comm.count_wire_bytes(1, n_dev)
        payload_exp = n_dev * d_win * (n_dev - 1) * b * _I32_BYTES
        payload_worst = n_dev * d_win * (n_dev - 1) * ladder[-1] * _I32_BYTES
    else:
        a_loc, n_loc = A // n_groups, n_pad // gsz
        if net.k_intra > 0 and backend == "event":
            ladder_loc = delivery_lib.bucket_ladder(floor, n_loc)
            bl = delivery_lib.expected_bucket(ladder_loc, exp_area / gsz)
            buckets["local"] = bl
            counts += d_win * comm.count_wire_bytes(1, n_dev)
            payload_exp += n_dev * d_win * a_loc * (gsz - 1) * bl * _I32_BYTES
            payload_worst += n_dev * d_win * a_loc * (gsz - 1) * ladder_loc[-1] * _I32_BYTES
        else:
            # The dense local pathway stays bit-packed: its static bytes.
            payload_exp += static["local_bytes"]
            payload_worst += static["local_bytes"]
        if net.k_inter > 0:
            ladder_dev = delivery_lib.bucket_ladder(floor, a_loc * n_loc)
            bd = delivery_lib.expected_bucket(ladder_dev, exp_area * A / n_dev)
            if routing is None:
                buckets["device"] = bd
                counts += comm.count_wire_bytes(1, n_dev)
                payload_exp += n_dev * d_win * (n_dev - 1) * bd * _I32_BYTES
                payload_worst += n_dev * d_win * (n_dev - 1) * ladder_dev[-1] * _I32_BYTES
            else:
                G = routing.n_groups
                buckets["assembly"] = bd
                counts += comm.count_wire_bytes(d_win * A + 1, n_dev)
                payload_exp += n_dev * (gsz - 1) * d_win * bd * _I32_BYTES
                payload_worst += n_dev * (gsz - 1) * d_win * ladder_dev[-1] * _I32_BYTES
                ladder_edge = delivery_lib.bucket_ladder(floor, a_loc * n_pad)
                proj_r = routing.proj.reshape(G, A // G, G)
                round_buckets = {}
                for rnd in routing.rounds:
                    if rnd.offset == 0:
                        continue
                    n_src = max(int(proj_r[g, :, h].sum()) for g, h in rnd.pairs)
                    br = delivery_lib.expected_bucket(ladder_edge, exp_area * n_src)
                    round_buckets[rnd.offset] = br
                    payload_exp += len(rnd.pairs) * gsz * d_win * br * _I32_BYTES
                    payload_worst += (len(rnd.pairs) * gsz * d_win * ladder_edge[-1]
                                      * _I32_BYTES)
                buckets["rounds"] = round_buckets
    out.update(
        counts_bytes=counts,
        payload_bytes_expected=payload_exp,
        payload_bytes_worst=payload_worst,
        total_bytes_expected=counts + payload_exp,
        saved_bytes=static["total_bytes"] - (counts + payload_exp),
        buckets=buckets,
    )
    return out


def inter_table_report(
    net: Network,
    *,
    n_groups: int,
    gsz: int,
    schedule: str = STRUCTURE_AWARE,
    headroom: float = 8.0,
    floor: int = 16,
    routing: Routing | None = None,
    subgroup: int = 1,
) -> dict:
    """Per-rank inter receive-table bytes and receive-side scatter work,
    replicated against sharded (the JAX package's accounting).

    ``table_bytes.replicated`` prices every rank holding the whole
    ``[A * n_pad, K_out]`` outgoing tables; ``table_bytes.sharded`` one
    rank's inbound slice (:func:`~repro_torch.core.connectivity.
    shard_inter_tables`; its shard count from the table's rank, or from
    ``subgroup`` when the network holds no slices, then priced at the width
    bound). ``receive`` counts synapse touches per rank per window of the
    event receive scatter (ids scattered x table width)."""
    from repro_torch.core import connectivity as connectivity_lib

    n_dev = n_groups * gsz
    d_win = net.delay_ratio
    rows = net.n_areas * net.n_pad
    n_shards = n_groups if schedule == STRUCTURE_AWARE else n_dev
    k_e = net.k_inter
    syn_b = net.bytes_per_synapse()
    if net.tgt_inter is not None:
        k_rep = net.tgt_inter.shape[-1]
    else:
        k_rep = connectivity_lib._outgoing_k_bound(k_e)
    if net.tgt_inter_in is not None:
        k_sh = net.tgt_inter_in.shape[-1]
        # [S, rows, K] -> S shards; [S, gsz, rows, K] -> S * gsz slices.
        n_shards = int(np.prod(tuple(net.tgt_inter_in.shape[:-2])))
    else:
        n_shards = n_shards * max(subgroup, 1)
        k_sh = connectivity_lib._inbound_k_bound(k_e, n_shards)
    bytes_rep = rows * k_rep * syn_b
    bytes_sh = rows * k_sh * syn_b
    _, s_max_dev = _mesh_bounds(net, n_groups=n_groups, gsz=gsz, headroom=headroom,
                                floor=floor)
    ids = {"dense": d_win * n_dev * s_max_dev}
    if routing is not None:
        ids["routed"] = d_win * sum(r.s_max for r in routing.rounds)
    receive = {name: dict(ids_per_window=n, syn_touches_replicated=n * k_rep,
                          syn_touches_sharded=n * k_sh)
               for name, n in ids.items()}
    return dict(
        rows=rows,
        n_shards=n_shards,
        k_out_replicated=k_rep,
        k_in_sharded=k_sh,
        table_bytes=dict(
            replicated=bytes_rep,
            sharded=bytes_sh,
            reduction=bytes_rep / bytes_sh if bytes_sh else float("inf"),
        ),
        receive=receive,
    )


def priced_inter_table_report(
    net: Network,
    *,
    n_groups: int,
    gsz: int,
    schedule: str = STRUCTURE_AWARE,
    headroom: float = 8.0,
    floor: int = 16,
    routing: Routing | None = None,
    subgroup: int = 1,
) -> dict:
    """:func:`inter_table_report` with both layouts priced from one network:
    a network holding only the replicated outgoing tables gets its sharded
    slices cut (:func:`~repro_torch.core.connectivity.shard_inter_tables`)
    and keeps its replicated ones, so the report never falls back to the
    width bound's slack for either side. A shape-only network (meta
    tensors) has nothing to cut: it must carry its inbound slices
    (``network_sds(inter_shards=...)``), as the dry run gives it."""
    if net.k_inter > 0 and net.tgt_inter_in is None and net.device.type == "meta":
        raise ValueError(
            "priced_inter_table_report: a shape-only (meta) network has no tables to "
            "cut; build it with network_sds(inter_shards=...) so it carries the "
            "inbound slices")
    if net.k_inter > 0 and net.tgt_inter is not None and net.tgt_inter_in is None:
        from repro_torch.core import connectivity as connectivity_lib

        n_shards = n_groups if schedule == STRUCTURE_AWARE else n_groups * gsz
        mode = "group" if schedule == STRUCTURE_AWARE else "window"
        sharded = connectivity_lib.shard_inter_tables(
            net, n_shards, mode=mode, subgroup=subgroup if mode == "group" else 1)
        net = dataclasses.replace(sharded, tgt_inter=net.tgt_inter, wout_inter=net.wout_inter,
                                  dout_inter=net.dout_inter)
    return inter_table_report(net, n_groups=n_groups, gsz=gsz, schedule=schedule,
                              headroom=headroom, floor=floor, routing=routing,
                              subgroup=subgroup)


def wire_report(
    net: Network,
    adjacency: np.ndarray,
    *,
    backend: str,
    n_groups: int,
    gsz: int,
    headroom: float = 8.0,
    floor: int = 16,
) -> dict:
    """Dense against routed wire volume for a hypothetical ``n_groups x gsz``
    mesh (no ranks needed): each entry's static worst case, with the
    adaptive two-phase model under ``["adaptive"]``."""
    routing = build_routing(adjacency, n_groups,
                            exp_area_spikes=delivery_lib.expected_area_spikes(net),
                            headroom=headroom, floor=floor)
    kw = dict(backend=backend, schedule=STRUCTURE_AWARE, n_groups=n_groups, gsz=gsz,
              headroom=headroom, floor=floor)
    dense = dense_wire_bytes(net, **kw)
    dense["adaptive"] = adaptive_wire_bytes(net, **kw)
    routed = routed_wire_bytes(net, routing, backend=backend, gsz=gsz, headroom=headroom,
                               floor=floor)
    routed["adaptive"] = adaptive_wire_bytes(net, routing=routing, **kw)
    return dict(dense=dense, routed=routed)
