"""Distributed engine: the shared window core on a process mesh.

Port of ``repro.core.dist_engine``. The JAX package wraps the window body in
``shard_map`` over a device mesh; here every rank of a
:class:`~repro_torch.core.mesh.ProcessMesh` runs the same window body on its
own shard, and the exchange's collectives (:mod:`repro_torch.core.comm`)
carry the spikes between ranks. Placement:

* **structure-aware**: the areas are cut over the mesh's area axes (all but
  the last) and each area's ``n_pad`` neurons over the last axis, the
  intra-area subgroup. Every cycle only the subgroup communicates (local
  pathway); every D-th cycle the window's ``[D, ...]`` block crosses all
  ranks (global pathway).
* **conventional**: every rank holds an ``n_pad / size`` neuron window of
  every area, and the whole spike vector crosses all ranks every cycle.

The global pathway is the ``'dense'`` exchange's mesh-wide gathers
(:class:`~repro_torch.core.exchange.DenseMeshExchange`, the default) or the
``'routed'`` exchange's packet rounds along the area graph's group edges
(:class:`~repro_torch.core.exchange.RoutedExchange`, structure-aware only).

A rank's view of the network (:func:`shard_network`, or the host-free
:func:`build_network_sharded`) holds the tables the JAX package's
``shard_map`` gives that device. On the ``event`` backend (and for the
routed exchange's global pathway on every backend) the engine turns the
view's outgoing and inbound tables into receive tables whose targets are
the rank's ring rows (ascending, ``-1`` last, as the event kernel needs
them; rows of the replicated layouts, which also hold other ranks' targets,
are compacted), and drops the tables it no longer reads.

The engine's state and blocks are the rank's shards; ``gather_state`` and
``gather_block`` assemble the whole network's (every rank gets them), as
reading a sharded ``jax.Array`` whole does. Every rank must call the same
engine functions in the same order: they run collectives.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core import connectivity as connectivity_lib
from repro_torch.core import exchange as exchange_lib
from repro_torch.core import neuron as neuron_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.areas import MultiAreaSpec
from repro_torch.core.connectivity import Network
from repro_torch.core.engine import (
    CONVENTIONAL,
    STRUCTURE_AWARE,
    Engine,
    EngineConfig,
    SimState,
    make_fused_lif_update,
    resolve_params,
)
from repro_torch.core.exchange import ReceiveTables
from repro_torch.device import resolve_device

__all__ = [
    "make_dist_engine",
    "build_network_sharded",
    "shard_network",
    "shard_state",
    "shape_network",
]


def _area_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names[:-1])


def _subgroup_axis(mesh) -> str:
    return mesh.axis_names[-1]


@dataclasses.dataclass(frozen=True)
class _Cut:
    """This rank's block of the ``[A, n_pad]`` neuron grid: areas ``[aoff,
    aoff + a_loc)``, neurons ``[noff, noff + n_loc)`` of each; ``shard`` and
    ``lane`` index its inbound inter slice."""

    aoff: int
    a_loc: int
    noff: int
    n_loc: int
    shard: int
    lane: int


def _cut(mesh, schedule: str, n_areas: int, n_pad: int) -> _Cut:
    if schedule == STRUCTURE_AWARE:
        g = 0
        for ax in _area_axes(mesh):
            g = g * mesh.shape[ax] + mesh.axis_index(ax)
        n_groups = mesh.size // mesh.shape[_subgroup_axis(mesh)]
        lane = mesh.axis_index(_subgroup_axis(mesh))
        a_loc, n_loc = n_areas // n_groups, n_pad // mesh.shape[_subgroup_axis(mesh)]
        return _Cut(g * a_loc, a_loc, lane * n_loc, n_loc, g, lane)
    n_loc = n_pad // mesh.size
    return _Cut(0, n_areas, mesh.rank * n_loc, n_loc, mesh.rank, 0)


def _block(x: torch.Tensor, c: _Cut, dim: int = 0) -> torch.Tensor:
    """The rank's ``[a_loc, n_loc, ...]`` block of ``x``'s ``[A, n_pad]``
    dims ``dim, dim + 1``, contiguous."""
    idx = (slice(None),) * dim + (slice(c.aoff, c.aoff + c.a_loc), slice(c.noff, c.noff + c.n_loc))
    return x[idx].contiguous()


def _validate(net: Network, mesh, schedule: str) -> None:
    A, n_pad = net.n_areas, net.n_pad
    if schedule == STRUCTURE_AWARE:
        n_groups = math.prod(mesh.shape[a] for a in _area_axes(mesh))
        gsz = mesh.shape[_subgroup_axis(mesh)]
        if A % n_groups != 0:
            raise ValueError(f"n_areas={A} not divisible by area shards={n_groups} "
                             f"(mesh {dict(mesh.shape)})")
        if n_pad % gsz != 0:
            raise ValueError(f"padded area size {n_pad} not divisible by subgroup {gsz}")
    elif n_pad % mesh.size != 0:
        raise ValueError(f"padded area size {n_pad} not divisible by {mesh.size} devices")


def shard_network(net: Network, mesh, schedule: str) -> Network:
    """This rank's view of the global ``net``: the cut the JAX package's
    ``network_pspecs`` describes, with the shapes ``shard_map`` gives a
    device (a cut axis keeps its length-1 slice).

    Neuron state and incoming tables: the rank's ``[a_loc, n_loc, ...]``
    block. Outgoing intra tables: the rank's areas, whole (structure-aware)
    or every area (conventional); lane-cut ``[gsz, A, n_pad, K]`` tables
    give ``[1, a_loc, n_pad, K]``. Replicated outgoing inter tables: whole.
    Inbound inter tables: the rank's ``[1(, 1), rows, K_in]`` slice.
    Zero-row stand-ins stay as they are. Tensors stay on ``net``'s device.
    """
    _validate(net, mesh, schedule)
    c = _cut(mesh, schedule, net.n_areas, net.n_pad)
    sa = schedule == STRUCTURE_AWARE
    arrays = {f: _block(getattr(net, f), c) for f in ("alive", "rate_hz")}
    for f in connectivity_lib._TABLES[2:]:
        x = getattr(net, f)
        arrays[f] = x if x.shape[0] == 0 else _block(x, c)
    areas = slice(c.aoff, c.aoff + c.a_loc)
    if net.tgt_intra is not None:
        for f in ("tgt_intra", "wout_intra", "dout_intra"):
            x = getattr(net, f)
            if x.dim() == 4:
                arrays[f] = x[c.lane:c.lane + 1, areas] if sa else x
            else:
                arrays[f] = x[areas] if sa else x
    if net.tgt_inter_in is not None:
        for f in connectivity_lib.INBOUND_TABLES:
            x = getattr(net, f)
            arrays[f] = (x[c.shard:c.shard + 1, c.lane:c.lane + 1] if x.dim() == 4
                         else x[c.shard:c.shard + 1])
    return dataclasses.replace(net, **arrays)


def _draw_rows(spec, seed, rows: torch.Tensor, pathway: str, k: int, d_dtype, size_multiple,
               chunk_rows=connectivity_lib.CHUNK_ROWS):
    """Incoming ``(src, w, d) [R, k]`` of the given global target rows, drawn
    in row chunks straight into the tables."""
    dev = rows.device
    out = (torch.empty((rows.numel(), k), dtype=torch.int32, device=dev),
           torch.empty((rows.numel(), k), dtype=torch.float32, device=dev),
           torch.empty((rows.numel(), k), dtype=d_dtype, device=dev))
    for r0 in range(0, rows.numel(), chunk_rows):
        part = connectivity_lib.draw_pathway_rows(
            spec, seed, rows[r0:r0 + chunk_rows], pathway=pathway, size_multiple=size_multiple)
        for dst, x in zip(out, part):
            dst[r0:r0 + chunk_rows] = x
    return out


def _shared_plan(mesh, spec, seed, n_shards, *, subgroup, size_multiple):
    """The host-free build's plan: rank 0 takes it from the plan cache
    (:func:`~repro_torch.core.connectivity.cached_sharded_build_plan`: its
    memo, the file under ``$REPRO_PLAN_CACHE`` when that is set, else a
    counting pass, which it then publishes there) and broadcasts it (the
    plan is counts only), so no other rank waits on the file system."""
    kw = dict(mode="group", subgroup=subgroup, size_multiple=size_multiple, device=mesh.device)
    box = [connectivity_lib.cached_sharded_build_plan(spec, seed, n_shards, **kw)
           if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def build_network_sharded(
    spec: MultiAreaSpec,
    mesh,
    config: EngineConfig,
    *,
    seed: int = 12,
    size_multiple: int = 1,
) -> Network:
    """Host-free construction: this rank's view, drawn straight from the rules.

    Bitwise :func:`shard_network` of the global network cut for the event
    path (``slice_intra_tables`` and ``shard_inter_tables``), but no rank
    draws more than its own rows: rank 0 computes the
    :func:`~repro_torch.core.connectivity.sharded_build_plan` (the global
    widths, delay windows and area adjacency, from counts only) on its
    device and broadcasts it, then every rank draws its incoming intra
    block, its lane-cut (or group) outgoing intra tables and its inbound
    inter slice on ``mesh.device``. The dense incoming inter tensors become
    zero-row stand-ins (the event path never reads them). Structure-aware
    ``event`` only, as in the JAX package.
    """
    return _build_view(spec, mesh, config, seed=seed, size_multiple=size_multiple,
                       incoming=True)


def shape_network(spec: MultiAreaSpec, *, device, size_multiple: int = 1) -> Network:
    """The global network's masks and static fields with zero-row tables:
    what the run loop reads of a network (its shapes, the resume hash, the
    reshard plan's area sizes) when every rank built its tables host-free
    and no rank holds the global network."""
    dev = resolve_device(device)
    n_pad = spec.padded_area_size(size_multiple)
    alive, rate = connectivity_lib.area_masks(spec, n_pad, dev)
    d_i = connectivity_lib._delay_dtype(spec.steps_intra_max)
    d_e = connectivity_lib._delay_dtype(spec.steps_inter_max)
    empty = {f: torch.zeros((0, 0, k), dtype=dt, device=dev)
             for f, k, dt in (("src_intra", spec.k_intra, torch.int32),
                              ("w_intra", spec.k_intra, torch.float32),
                              ("delay_intra", spec.k_intra, d_i),
                              ("src_inter", spec.k_inter, torch.int32),
                              ("w_inter", spec.k_inter, torch.float32),
                              ("delay_inter", spec.k_inter, d_e))}
    return Network(alive=alive, rate_hz=rate, n_pad=n_pad, n_areas=spec.n_areas,
                   ring_len=spec.ring_len, delay_ratio=spec.delay_ratio, dt_ms=spec.dt_ms,
                   **empty)


def _build_view(spec, mesh, config, *, seed, size_multiple, incoming: bool) -> Network:
    """:func:`build_network_sharded`; without ``incoming`` the incoming
    intra tables are zero-row stand-ins too (the engine's build: its event
    path reads only the outgoing ones)."""
    cfg = config
    if cfg.schedule != STRUCTURE_AWARE:
        raise ValueError("build_network_sharded targets the structure-aware placement")
    if cfg.backend != "event":
        raise ValueError("build_network_sharded builds the event-path tables")
    dev = mesh.device
    n_groups = math.prod(mesh.shape[a] for a in _area_axes(mesh))
    gsz = mesh.shape[_subgroup_axis(mesh)]
    A = spec.n_areas
    n_pad = spec.padded_area_size(size_multiple)
    if A % n_groups != 0:
        raise ValueError(f"n_areas={A} not divisible by area shards={n_groups} "
                         f"(mesh {dict(mesh.shape)})")
    if n_pad % gsz != 0:
        raise ValueError(f"padded area size {n_pad} not divisible by subgroup {gsz}")
    sub = gsz if (cfg.subgroup_inter_tables and gsz > 1) else 1
    K_i, K_e = spec.k_intra, spec.k_inter
    plan = _shared_plan(mesh, spec, seed, n_groups, subgroup=sub, size_multiple=size_multiple)
    c = _cut(mesh, STRUCTURE_AWARE, A, n_pad)
    alive, rate = connectivity_lib.area_masks(spec, n_pad, dev)
    areas = np.arange(c.aoff, c.aoff + c.a_loc)

    rows = (torch.arange(c.aoff, c.aoff + c.a_loc, device=dev)[:, None] * n_pad
            + torch.arange(c.noff, c.noff + c.n_loc, device=dev)[None, :]).reshape(-1)
    d_i = connectivity_lib._delay_dtype(spec.steps_intra_max)
    d_e = connectivity_lib._delay_dtype(spec.steps_inter_max)
    if incoming:
        src_i, w_i, dl_i = (x.view(c.a_loc, c.n_loc, K_i) for x in _draw_rows(
            spec, seed, rows, "intra", K_i, d_i, size_multiple))
    else:
        src_i, w_i, dl_i = (torch.zeros((0, 0, K_i), dtype=dt, device=dev)
                            for dt in (torch.int32, torch.float32, d_i))
    if sub > 1:
        out = connectivity_lib.build_lane_intra_tables(spec, seed, areas, c.lane, plan=plan,
                                                       device=dev)
        out = tuple(x[None] for x in out)
    else:
        out = connectivity_lib.build_group_intra_tables(spec, seed, areas, plan=plan, device=dev)
    inter = {}
    if K_e > 0:
        tables = connectivity_lib.build_shard_tables(spec, seed, c.shard, plan=plan,
                                                     lane=c.lane if sub > 1 else 0, device=dev)
        lead = (1, 1) if sub > 1 else (1,)
        inter = dict(zip(connectivity_lib.INBOUND_TABLES,
                         (x.view(*lead, *x.shape) for x in tables)),
                     inter_shard_mode="group")
    return Network(
        alive=_block(alive, c), rate_hz=_block(rate, c),
        src_intra=src_i, w_intra=w_i, delay_intra=dl_i,
        src_inter=torch.zeros((0, 0, K_e), dtype=torch.int32, device=dev),
        w_inter=torch.zeros((0, 0, K_e), dtype=torch.float32, device=dev),
        delay_inter=torch.zeros((0, 0, K_e), dtype=d_e, device=dev),
        tgt_intra=out[0], wout_intra=out[1], dout_intra=out[2],
        n_pad=n_pad, n_areas=A, ring_len=spec.ring_len, delay_ratio=spec.delay_ratio,
        dt_ms=spec.dt_ms, steps_lo_intra=plan.steps_lo_intra, r_span_intra=plan.r_span_intra,
        steps_lo_inter=plan.steps_lo_inter, r_span_inter=plan.r_span_inter,
        area_adj=plan.area_adj, **inter)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 32-byte aligned (the event kernel reads 8
    entries at once), copied only where it is not (a meta tensor has no
    address: never)."""
    x = x.contiguous()
    return x if x.is_meta or x.data_ptr() % 32 == 0 else x.clone()


def _receive_tables(tgt, w, d, c: _Cut, n_pad: int, *, intra: bool,
                    inplace: bool = False) -> ReceiveTables:
    """A pathway's receive tables from the rank's ``[rows, K]`` cut: targets
    mapped to rows of the rank's flattened ``[a_loc * n_loc]`` ring, the
    synapses onto other ranks' neurons dropped, rows compacted so they
    still ascend with the ``-1`` padding last.

    Intra rows are the rank's areas' sources (structure-aware) or every
    area's (conventional), targets within the row's area; inter targets are
    global ids. The mapping keeps the order of a row's targets. With
    ``inplace`` the targets are mapped in ``tgt`` itself (a table the
    engine owns), so no second copy is made.

    On ``meta`` tables (a dry run) nothing can be read, so nothing is
    compacted: the inbound slices hold only the rank's targets and keep
    their width as they would; a replicated layout keeps its full width, an
    upper bound on the compacted one.
    """
    chunk = connectivity_lib.CHUNK_ROWS

    def local(r0, r1, t):
        t = t.long()
        if intra:
            al = (torch.arange(r0, r1, device=t.device) // n_pad)[:, None]
            il = t - c.noff
            keep = (t >= 0) & (il >= 0) & (il < c.n_loc)
        else:
            al = torch.div(t, n_pad, rounding_mode="floor") - c.aoff
            il = torch.remainder(t, n_pad) - c.noff
            keep = (t >= 0) & (al >= 0) & (al < c.a_loc) & (il >= 0) & (il < c.n_loc)
        return torch.where(keep, al * c.n_loc + il, -1).to(torch.int32), keep

    mapped = tgt if inplace else torch.empty_like(tgt)
    foreign = False
    for r0 in range(0, tgt.shape[0], chunk):
        r1 = min(tgt.shape[0], r0 + chunk)
        chunk_map, keep = local(r0, r1, tgt[r0:r1])
        if not tgt.is_meta:
            foreign = foreign or bool(((tgt[r0:r1] >= 0) & ~keep).any())
        mapped[r0:r1] = chunk_map
    if foreign:
        # A replicated layout: this rank's synapses move to the front of
        # each row, in their order, and the table narrows to the widest row.
        mapped, w, d, widest = connectivity_lib._compact(
            mapped, w, d, lambda r0, r1, t: t >= 0, chunk_rows=chunk)
        mapped, w, d = (x[:, :widest] for x in (mapped, w, d))
    return ReceiveTables(_aligned(mapped), _aligned(w), _aligned(d))


def _make_exchange(net: Network, mesh, cfg: EngineConfig, **tables):
    name = cfg.exchange or "dense"
    if name == "local":
        raise ValueError(
            "exchange='local' is the single-host identity; the distributed "
            "engine needs 'dense' or 'routed'")
    if name == "routed":
        return exchange_lib.RoutedExchange(net, cfg, mesh, connectivity_lib.area_adjacency(net),
                                           **tables)
    return exchange_lib.DenseMeshExchange(net, cfg, mesh, **tables)


def _inter_cut(net: Network, mesh, cfg: EngineConfig):
    """``(n_shards, gsz, mode, sub)`` of the inbound inter tables the mesh
    and schedule ask for."""
    if cfg.schedule == STRUCTURE_AWARE:
        n_shards = math.prod(mesh.shape[a] for a in _area_axes(mesh))
        gsz = mesh.shape[_subgroup_axis(mesh)]
        sub = gsz if cfg.subgroup_inter_tables else 1
        return n_shards, gsz, "group", sub
    return mesh.size, 1, "window", 1


def _check_prebuilt(net: Network, mesh, cfg: EngineConfig) -> None:
    """Refuse pre-cut tables that do not match the mesh (as the JAX engine)."""
    receives = cfg.backend == "event" or cfg.exchange == "routed"
    if receives and net.k_inter > 0 and net.tgt_inter_in is not None:
        n_shards, gsz, mode, _ = _inter_cut(net, mesh, cfg)
        four = net.tgt_inter_in.dim() == 4
        got_sub = net.tgt_inter_in.shape[1] if four else 1
        want_sub = gsz if four else 1
        if (net.tgt_inter_in.shape[0] != n_shards or got_sub != want_sub
                or net.inter_shard_mode != mode):
            raise ValueError(
                f"sharded inter tables ({net.tgt_inter_in.shape[0]} "
                f"{net.inter_shard_mode!r} shards x {got_sub} lanes) do not match the "
                f"mesh ({n_shards} {mode!r} shards x {want_sub} lanes)")
    if net.tgt_intra is not None and net.tgt_intra.dim() == 4:
        gsz = mesh.shape[_subgroup_axis(mesh)]
        if cfg.schedule != STRUCTURE_AWARE:
            raise ValueError(
                "subgroup-sliced intra tables need the structure-aware "
                "schedule (the conventional cut is already per-device)")
        if net.tgt_intra.shape[0] != gsz:
            raise ValueError(
                f"subgroup-sliced intra tables ({net.tgt_intra.shape[0]} "
                f"lanes) do not match the mesh subgroup ({gsz})")


def _event_tables(net: Network, view: Network, mesh, cfg: EngineConfig, c: _Cut,
                  *, owned: bool = False, intra_too: bool = True):
    """The rank's ``(recv_intra, recv_inter)`` receive tables (``recv_intra``
    only with ``intra_too``). ``net`` is the global network (None after a
    host-free build), ``view`` the rank's; ``owned``: the view's tables are
    the engine's own, mapped in place."""
    intra = inter = None
    if intra_too and view.k_intra > 0:
        x = [getattr(view, f) for f in ("tgt_intra", "wout_intra", "dout_intra")]
        if x[0].dim() == 4:
            x = [t[0] for t in x]
        intra = _receive_tables(*(t.reshape(-1, t.shape[-1]) for t in x), c, view.n_pad,
                                intra=True, inplace=owned)
    if view.k_inter > 0:
        n_rows = view.n_areas * view.n_pad
        fresh = False
        if view.tgt_inter_in is not None:
            x = [getattr(view, f).reshape(n_rows, -1) for f in connectivity_lib.INBOUND_TABLES]
        elif cfg.shard_inter_tables:
            # Only this rank's slice is inverted, from its own incoming rows.
            n_shards, _, mode, sub = _inter_cut(net, mesh, cfg)
            x = connectivity_lib.inbound_slice(net, n_shards, c.shard, mode=mode,
                                               subgroup=sub, lane=c.lane if sub > 1 else 0)
            fresh = True
        elif view.tgt_inter is not None:
            x = [getattr(view, f).reshape(n_rows, -1)
                 for f in ("tgt_inter", "wout_inter", "dout_inter")]
        else:
            raise ValueError("shard_inter_tables=False receives through the replicated "
                             "outgoing inter tables: build_network(outgoing=True) required")
        inter = _receive_tables(*x, c, view.n_pad, intra=False, inplace=owned or fresh)
    return intra, inter


def _per_neuron(x, dtype, c: _Cut, dev) -> torch.Tensor:
    """A seed / stimulus leaf: a scalar broadcast, or the rank's block of a
    global ``[A, n_pad]`` array; a seed keeps its uint32 value."""
    x = np.asarray(x)
    if dtype == torch.int64:
        x = x.astype(np.uint32).astype(np.int64)
    t = torch.as_tensor(x, dtype=dtype)
    if t.dim() == 0:
        return t.to(dev).expand(c.a_loc, c.n_loc).contiguous()
    return _block(t, c).to(dev)


def _gather_grid(x: torch.Tensor, mesh, schedule: str, dim: int = 0) -> torch.Tensor:
    """The whole ``[A, n_pad]`` grid (dims ``dim, dim + 1``) of every rank's
    block ``x``, on every rank."""
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    label = "gather_grid"  # counted apart from the exchange's gathers
    if schedule == STRUCTURE_AWARE:
        x = comm.all_gather(x, mesh, _subgroup_axis(mesh), dim=dim + 1, count_as=label)
        for ax in reversed(_area_axes(mesh)):
            x = comm.all_gather(x, mesh, ax, dim=dim, count_as=label)
    else:
        x = comm.all_gather(x, mesh, tuple(mesh.axis_names), dim=dim + 1, count_as=label)
    return x.bool() if is_bool else x


def shard_state(state: SimState, mesh, schedule: str) -> SimState:
    """This rank's block of a global ``SimState`` (host or device leaves,
    e.g. a restored checkpoint), on ``mesh.device``."""
    dev = mesh.device
    A, n_pad = state.spike_count.shape[:2]
    c = _cut(mesh, schedule, A, n_pad)

    def cut(x):
        return None if x is None else _block(torch.as_tensor(np.asarray(x)), c).to(dev)

    neuron = dataclasses.replace(state.neuron, **{
        f.name: cut(getattr(state.neuron, f.name)) for f in dataclasses.fields(state.neuron)})
    overflow = state.overflow
    if isinstance(overflow, (torch.Tensor, np.ndarray, np.generic)):
        overflow = torch.as_tensor(np.asarray(overflow), dtype=torch.int32).to(dev)
    return SimState(neuron=neuron, ring=cut(state.ring), t=int(state.t),
                    spike_count=cut(state.spike_count), overflow=overflow,
                    shipped_bytes=float(state.shipped_bytes),
                    seed=cut(state.seed), stim=cut(state.stim))


def _make_dist_engine(
    net: Network | None,
    spec: MultiAreaSpec,
    mesh,
    config: EngineConfig = EngineConfig(),
    *,
    build_seed: int = 12,
    gids: torch.Tensor | None = None,
    trial_leaves: bool = False,
) -> Engine:
    """Build this rank's distributed engine on ``mesh``.

    ``net`` is the global network on ``mesh.device`` (every rank passes the
    same one); ``net=None`` needs ``config.sharded_build`` and builds the
    rank's view host-free (:func:`build_network_sharded`, seeded by
    ``build_seed``). ``gids`` overrides the global id table. With
    ``trial_leaves`` the state always carries per-neuron ``seed`` / ``stim``
    leaves (defaulting to ``config.seed`` and 1).
    """
    cfg = config
    cfg.check(distributed=True)
    backend = cfg.backend
    dev = mesh.device
    if net is None:
        if not cfg.sharded_build:
            raise ValueError(
                "net=None needs config.sharded_build=True (otherwise pass "
                "a build_network(...) network)")
        view = _build_view(spec, mesh, cfg, seed=build_seed, size_multiple=1, incoming=False)
        glob = dataclasses.replace(view, **dict(zip(
            ("alive", "rate_hz"), connectivity_lib.area_masks(spec, view.n_pad, dev))))
    else:
        if net.device.type != dev.type or (dev.index is not None and net.device != dev):
            raise ValueError(f"net lives on {net.device}, but this rank runs on {dev}")
        _validate(net, mesh, cfg.schedule)
        if backend == "event" and net.tgt_intra is None:
            raise ValueError("event delivery needs build_network(outgoing=True)")
        _check_prebuilt(net, mesh, cfg)
        glob = net
        view = shard_network(net, mesh, cfg.schedule)
    A, n_pad = view.n_areas, view.n_pad
    c = _cut(mesh, cfg.schedule, A, n_pad)
    tables = {}
    if backend == "event" or cfg.exchange == "routed":
        # The routed global pathway ships id packets on every backend, so it
        # needs the inter receive tables; the dense backends' local pathway
        # keeps reading the incoming intra tables.
        tables = dict(zip(("recv_intra", "recv_inter"), _event_tables(
            net, view, mesh, cfg, c, owned=net is None, intra_too=backend == "event")))
        # The receive tables replace the outgoing and inbound tables; the
        # event path reads no incoming table either, so those become
        # zero-row stand-ins (k_intra / k_inter read their last axis).
        drop = {f: None for f in connectivity_lib.OUTGOING_TABLES + connectivity_lib.INBOUND_TABLES}
        if backend == "event":
            drop.update({f: torch.zeros((0, 0, getattr(view, f).shape[-1]),
                                        dtype=getattr(view, f).dtype, device=dev)
                         for f in connectivity_lib._TABLES[2:]})
        view = dataclasses.replace(view, **drop)
    exchange = _make_exchange(glob, mesh, cfg, **tables)
    wire_bytes = exchange.wire_bytes(glob)
    del glob, net
    R = view.ring_len
    all_axes = tuple(mesh.axis_names)
    lif_params, _ = resolve_params(view, spec, cfg)
    fused_lif = make_fused_lif_update(lif_params) if cfg.fused else None
    update_fn = schedule_lib.make_update_fn(cfg, spec, view.dt_ms, lif_params, fused_lif)
    window_body = schedule_lib.make_window_fn(cfg, exchange, update_fn)
    gids_global = (torch.arange(A * n_pad, dtype=torch.int32).view(A, n_pad)
                   if gids is None else torch.as_tensor(gids))
    gids_local = _block(gids_global, c).to(dev)
    counts_overflow = schedule_lib.counts_overflow(cfg)

    def reduce_overflow(before: SimState, after: SimState) -> SimState:
        """The window's spills summed over the ranks (every rank the same)."""
        if not counts_overflow:
            return after
        delta = torch.as_tensor(after.overflow - before.overflow, dtype=torch.int32, device=dev)
        total = comm.all_reduce(delta, mesh, all_axes, op="sum")
        return dataclasses.replace(after, overflow=before.overflow + total)

    overlap = drain = init_inflight = None
    if cfg.overlap_exchange:
        overlap_body, drain_body = schedule_lib.make_overlap_window_fn(cfg, exchange, update_fn)

        def overlap(state: SimState, inflight):
            st, inflight, block = overlap_body(state, inflight, view, gids_local)
            return reduce_overflow(state, st), inflight, block

        def drain(state: SimState, inflight) -> SimState:
            return drain_body(state, inflight, view, gids_local)

        def init_inflight():
            return exchange.init_inflight(view)

        def window(state: SimState):
            st, inflight, block = overlap(state, init_inflight())
            return drain(st, inflight), block
    else:
        def window(state: SimState):
            st, block = window_body(state, view, gids_local)
            return reduce_overflow(state, st), block

    def init(seed=None, stim=None) -> SimState:
        if seed is not None or stim is not None:
            if not trial_leaves:
                raise ValueError(
                    "per-trial seed/stim need make_simulation(..., "
                    "trial_leaves=True) -- the shard_map state specs are "
                    "sized at engine build")
            if cfg.neuron_model != "lif":
                raise ValueError(
                    "per-trial seed/stim drive the LIF Poisson input; "
                    "ignore_and_fire has no seed or input dependence")
        if cfg.neuron_model == "lif":
            nstate = neuron_lib.lif_init((c.a_loc, c.n_loc), dev)
        else:
            nstate = neuron_lib.ignore_and_fire_init(view.alive, view.rate_hz, view.dt_ms,
                                                     gids_local)
        leaves = {}
        if trial_leaves:
            leaves = dict(seed=_per_neuron(cfg.seed if seed is None else seed, torch.int64, c, dev),
                          stim=_per_neuron(1.0 if stim is None else stim, torch.float32, c, dev))
        return SimState(
            neuron=nstate,
            ring=torch.zeros((c.a_loc, c.n_loc, R), dtype=torch.float32, device=dev),
            t=0,
            spike_count=torch.zeros((c.a_loc, c.n_loc), dtype=torch.int32, device=dev),
            **leaves)

    def run(state: SimState, n_windows: int):
        """n windows; returns the whole network's spikes per window [n]
        int32 (one sum over the ranks for the run)."""
        totals = []
        inflight = init_inflight() if overlap is not None else None
        for _ in range(n_windows):
            if overlap is not None:
                state, inflight, block = overlap(state, inflight)
            else:
                state, block = window(state)
            totals.append(block.sum(dtype=torch.int32))
        if overlap is not None:
            state = drain(state, inflight)
        if not totals:
            return state, torch.zeros(0, dtype=torch.int32, device=dev)
        return state, comm.all_reduce(torch.stack(totals), mesh, all_axes, op="sum")

    def gather_block(block: torch.Tensor) -> torch.Tensor:
        """The whole network's ``[D, A, n_pad]`` block from every rank's."""
        return _gather_grid(block, mesh, cfg.schedule, dim=1)

    def gather_state(state: SimState) -> SimState:
        """The whole network's state from every rank's (on every rank)."""
        def whole(x):
            return None if x is None else _gather_grid(x, mesh, cfg.schedule)

        neuron = dataclasses.replace(state.neuron, **{
            f.name: whole(getattr(state.neuron, f.name))
            for f in dataclasses.fields(state.neuron)})
        return dataclasses.replace(
            state, neuron=neuron, ring=whole(state.ring),
            spike_count=whole(state.spike_count), seed=whole(state.seed),
            stim=whole(state.stim))

    return Engine(init=init, window=window, run=run, config=cfg,
                  delay_ratio=view.delay_ratio, window_overlap=overlap, drain=drain,
                  init_inflight=init_inflight, wire_bytes=wire_bytes,
                  shard_state=lambda st: shard_state(st, mesh, cfg.schedule),
                  gather_state=gather_state, gather_block=gather_block, mesh=mesh)


def make_dist_engine(
    net: Network | None,
    spec: MultiAreaSpec,
    mesh,
    config: EngineConfig = EngineConfig(),
    *,
    build_seed: int = 12,
    gids: torch.Tensor | None = None,
    trial_leaves: bool = False,
) -> Engine:
    """Deprecated alias for :func:`repro_torch.core.make_simulation` with a
    mesh: the same engine."""
    import warnings

    warnings.warn(
        "make_dist_engine is deprecated; use repro_torch.core.make_simulation"
        "(spec, config, net=net, mesh=mesh) -- it builds the identical "
        "distributed engine when a mesh is given",
        DeprecationWarning, stacklevel=2)
    return _make_dist_engine(net, spec, mesh, config, build_seed=build_seed, gids=gids,
                             trial_leaves=trial_leaves)
