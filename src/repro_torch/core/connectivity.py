"""Network instantiation: fixed-indegree connectivity with tiered delays.

Port of ``repro.core.connectivity``. The tables
are rectangular tensors, split into the paper's short- and long-range tiers:

* intra-area synapses of area ``a``: ``src_intra[a, n, k]`` (index *within*
  the area), ``w_intra[a, n, k]``, ``delay_intra[a, n, k]`` (steps);
* inter-area synapses: ``src_inter[a, n, k]`` holds *global* source ids
  (``area * n_pad + index``), with delays ``>= D`` steps.

Every synapse attribute is a counter-based pure function of ``(seed,
pathway, global target row, k)``, bitwise equal to the JAX package's draws.
:func:`build_network` evaluates those functions on the device in row chunks
and writes straight into preallocated tables: the paper's per-area size has
~3e9 synapses, and a host build would need tens of GB per temporary array.

The event backend reads the *outgoing* (source -> targets) tables,
``build_network(outgoing=True)``: the incoming tables inverted by a counting
sort over target-row chunks (:func:`_invert_adjacency`), in the order of the
JAX package's stable argsort.

The distributed engine reads per-rank cuts of these tables:
:func:`shard_inter_tables` re-cuts the inter tables into *inbound* slices
(each shard keeps the synapses whose targets it owns) and
:func:`slice_intra_tables` cuts the outgoing intra tables over the
subgroup's neuron windows. The host-free build (:func:`sharded_build_plan`,
:func:`build_shard_tables`, :func:`build_group_intra_tables`,
:func:`build_lane_intra_tables`) draws one shard's tables straight from the
counter-based rules, bitwise equal to cutting the global network.
:func:`cached_sharded_build_plan` computes that plan once per key (an
in-memory memo, and a JSON file under ``$REPRO_PLAN_CACHE`` that other
ranks read). :func:`area_adjacency` gives the realised area graph the
routed exchange routes over.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from fractions import Fraction

import numpy as np
import torch

from repro_torch.core.areas import MultiAreaSpec
from repro_torch.core.partition import shard_pathway_rows
from repro_torch.device import resolve_device

__all__ = [
    "Network",
    "build_network",
    "add_outgoing_tables",
    "network_from_numpy",
    "check_outgoing_order",
    "draw_pathway_rows",
    "shard_inter_tables",
    "slice_intra_tables",
    "ShardedBuildPlan",
    "sharded_build_plan",
    "build_shard_tables",
    "build_group_intra_tables",
    "build_lane_intra_tables",
    "area_adjacency",
    "network_sds",
    "construction_cost_model",
    "plan_cache_key",
    "cached_sharded_build_plan",
    "tile_gids",
    "tile_network",
]

_TABLES = ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra",
           "src_inter", "w_inter", "delay_inter")
OUTGOING_TABLES = ("tgt_intra", "wout_intra", "dout_intra",
                   "tgt_inter", "wout_inter", "dout_inter")
INBOUND_TABLES = ("tgt_inter_in", "wout_inter_in", "dout_inter_in")
# Table rows a build or check step handles at once on the device.
CHUNK_ROWS = 8192


@dataclasses.dataclass(frozen=True)
class Network:
    """Instantiated multi-area network: ``A`` areas, ``n_pad`` padded neurons
    per area, ``K_i``/``K_e`` intra-/inter-area in-degrees."""

    alive: torch.Tensor        # [A, n_pad] bool, False = ghost neuron
    rate_hz: torch.Tensor      # [A, n_pad] f32, per-neuron target rate (Hz)
    src_intra: torch.Tensor    # [A, n_pad, K_i] int32, index within the area
    w_intra: torch.Tensor      # [A, n_pad, K_i] f32
    delay_intra: torch.Tensor  # [A, n_pad, K_i] int8/int32, steps
    src_inter: torch.Tensor    # [A, n_pad, K_e] int32, global source id
    w_inter: torch.Tensor      # [A, n_pad, K_e] f32
    delay_inter: torch.Tensor  # [A, n_pad, K_e] int8/int32, steps >= D

    # Optional outgoing tables (the event backend), from
    # build_network(outgoing=True): per source neuron its targets, padded
    # with target -1 / weight 0 / delay 1 to the widest source.
    tgt_intra: torch.Tensor | None = None   # [A, n_pad, K_out_i] target index in the area
    wout_intra: torch.Tensor | None = None  # [A, n_pad, K_out_i] f32
    dout_intra: torch.Tensor | None = None  # [A, n_pad, K_out_i] int8/int32
    tgt_inter: torch.Tensor | None = None   # [A, n_pad, K_out_e] global target id
    wout_inter: torch.Tensor | None = None  # [A, n_pad, K_out_e] f32
    dout_inter: torch.Tensor | None = None  # [A, n_pad, K_out_e] int8/int32
    # Optional *inbound* inter tables (:func:`shard_inter_tables`): shard s
    # of the leading axis holds, for every source row (global id order),
    # only the synapses whose target lies in shard s, targets as global ids,
    # padded with -1 / 0 / 1. With a subgroup the slices are cut once more
    # over the lanes' neuron windows: [S, gsz, A * n_pad, K_in].
    tgt_inter_in: torch.Tensor | None = None   # [S(, gsz), A * n_pad, K_in] int32
    wout_inter_in: torch.Tensor | None = None  # [S(, gsz), A * n_pad, K_in] f32
    dout_inter_in: torch.Tensor | None = None  # [S(, gsz), A * n_pad, K_in] int8/int32

    n_pad: int = 0
    n_areas: int = 0
    ring_len: int = 0
    delay_ratio: int = 1
    dt_ms: float = 0.1
    # Per-pathway delay windows of the actual draws: every intra delay lies
    # in [steps_lo_intra, steps_lo_intra + r_span_intra), likewise inter.
    # Delay-resolved delivery (the pallas backend) reduces only over these
    # windows. r_span == 0 means "no synapses".
    steps_lo_intra: int = 1
    r_span_intra: int = 0
    steps_lo_inter: int = 1
    r_span_inter: int = 0
    # How the *_inter_in tables cut their targets: '' (none), 'group' (shard
    # = area group, the structure-aware placement) or 'window' (shard =
    # neuron window of every area, the conventional placement).
    inter_shard_mode: str = ""
    # The realised area -> area adjacency as nested 0/1 tuples, set by the
    # host-free build (whose dense inter tensors are zero-row stand-ins);
    # None where the tables themselves hold it.
    area_adj: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.alive.device

    @property
    def k_intra(self) -> int:
        return self.src_intra.shape[-1]

    @property
    def k_inter(self) -> int:
        return self.src_inter.shape[-1]

    @property
    def live_window(self) -> int:
        """Width W of the superstep's live window buffer: slots [0, D) are the
        window's inputs, and intra deposits reach at most D - 1 + the largest
        intra delay, so every within-window slot index is wrap-free."""
        if self.k_intra == 0:
            return self.delay_ratio
        return self.delay_ratio + self.steps_lo_intra + self.r_span_intra - 1

    @property
    def n_total_padded(self) -> int:
        return self.n_areas * self.n_pad

    def bytes_per_synapse(self) -> int:
        return 8 + self.delay_inter.element_size()

    def synapse_count(self) -> int:
        return int(self.alive.sum()) * (self.k_intra + self.k_inter)


def network_from_numpy(arrays: dict, *, device, **static) -> Network:
    """A :class:`Network` on ``device`` from numpy tables and static fields.

    ``arrays`` maps each table name (``alive``, ``rate_hz``, ``src_intra``,
    ...) to an array, as ``np.asarray`` of the JAX package's ``Network``
    leaves gives them; ``static`` holds the static fields (``n_pad``,
    ``ring_len``, ``steps_lo_intra``, ...). The outgoing and inbound tables
    (``tgt_intra``, ``tgt_inter_in``, ...) are carried where ``arrays``
    holds them (not None).
    """
    dev = torch.device(device)
    names = _TABLES + tuple(k for k in OUTGOING_TABLES + INBOUND_TABLES
                            if arrays.get(k) is not None)
    tables = {k: torch.from_numpy(np.array(arrays[k])).to(dev) for k in names}
    net = Network(**tables, **static)
    check_outgoing_order(net)
    return net


def check_outgoing_order(net: Network) -> None:
    """Raise ``ValueError`` unless every outgoing row of ``net`` ascends as
    unsigned 32-bit values: real targets in ascending order, the ``-1``
    padding only at the end. The event kernel relies on that order
    (``kernels/event_deliver``); :func:`add_outgoing_tables` gives it by
    construction, as the JAX package's stable argsort does. A check, in row
    chunks: nothing is sorted."""
    for name in ("tgt_intra", "tgt_inter", "tgt_inter_in"):
        tgt = getattr(net, name)
        if tgt is None or tgt.shape[-1] < 2:
            continue
        rows = tgt.reshape(-1, tgt.shape[-1])
        for r0 in range(0, rows.shape[0], CHUNK_ROWS):
            key = rows[r0:r0 + CHUNK_ROWS].long() & 0xFFFFFFFF  # -1 as the largest
            bad = (key[:, 1:] < key[:, :-1]).any(dim=1)
            if bool(bad.any()):
                row = r0 + int(bad.nonzero()[0, 0])
                raise ValueError(
                    f"{name}: outgoing row {row} does not ascend with its -1 padding at "
                    f"the end (the event kernel needs that order): "
                    f"{rows[row, :8].tolist()}...")


# ---------------------------------------------------------------------------
# Counter-based draws (a port of the JAX package's `_np_mix32` / `_counter_*`
# / `_intra_rows` / `_inter_rows`). uint32 arithmetic runs in int64 masked to
# 32 bits; Box-Muller in float64; rounding is half-to-even like np.round.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_TAG_SRC_INTRA = 1
_TAG_SRC_AREA = 2
_TAG_SRC_IDX = 3
_TAG_W_INTRA = 4
_TAG_W_INTER = 5
_TAG_D_INTRA_U1 = 6
_TAG_D_INTRA_U2 = 7
_TAG_D_INTER_U1 = 8
_TAG_D_INTER_U2 = 9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + 0x9E3779B9) & _M32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & _M32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def _counter_hash(seed: int, tag: int, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hash (as int64) of (seed, tag, flat synapse index)."""
    s0 = (int(seed) + int(tag) * 0x85EBCA6B) & _M32
    lo, hi = idx & _M32, idx >> 32
    return _mix32(_mix32((_mix32((lo + s0) & _M32) + hi) & _M32))


def _counter_uniform(seed: int, tag: int, idx: torch.Tensor) -> torch.Tensor:
    """Uniform draw strictly inside (0, 1), float64."""
    return (_counter_hash(seed, tag, idx).double() + 0.5) * (2.0 ** -32)


def _flat_idx(rows: torch.Tensor, k: int) -> torch.Tensor:
    return rows[:, None] * k + torch.arange(k, device=rows.device)[None, :]


def _delay_dtype(hi_steps: int) -> torch.dtype:
    """int8 whenever the pathway's step cutoff fits in 127, else int32."""
    return torch.int8 if hi_steps <= 127 else torch.int32


def _quantize_weights(w: torch.Tensor, grid: float = 1.0 / 256.0) -> torch.Tensor:
    """Snap weights onto the exactly representable 1/256 grid."""
    return torch.round(w / grid) * grid


def _counter_weights(spec, seed, tag, idx, src_idx, sizes_of_src):
    """80/20 excitatory/inhibitory by source index, on the 1/256 grid."""
    exc = src_idx < torch.clamp((spec.exc_fraction * sizes_of_src.double()).long(), min=1)
    u = _counter_uniform(seed, tag, idx)
    mag = _quantize_weights((0.5 + u) * spec.w_exc).float()
    return torch.where(exc, mag, mag * -float(np.float32(spec.g)))


def _counter_delays(seed, tag_u1, tag_u2, idx, mean_ms, std_ms, lo, hi, dt_ms):
    """Gaussian delays on the dt grid with [lo, hi] cutoffs (Box-Muller)."""
    u1 = _counter_uniform(seed, tag_u1, idx)
    u2 = _counter_uniform(seed, tag_u2, idx)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
    d = (mean_ms + std_ms * z) / dt_ms
    return torch.clamp(torch.round(d), lo, hi).to(_delay_dtype(hi))


def _intra_rows(spec, seed, rows, n_pad, sizes, *, weights: bool = True):
    """(src, w, delay) intra tables ``[R, K_i]`` for global target rows
    (``w`` None without ``weights``)."""
    idx = _flat_idx(rows, spec.k_intra)
    sz = sizes[rows // n_pad][:, None]
    src = _counter_hash(seed, _TAG_SRC_INTRA, idx) % sz
    w = _counter_weights(spec, seed, _TAG_W_INTRA, idx, src, sz) if weights else None
    d = _counter_delays(seed, _TAG_D_INTRA_U1, _TAG_D_INTRA_U2, idx,
                        spec.delay_intra_mean_ms, spec.delay_intra_std_ms,
                        1, spec.steps_intra_max, spec.dt_ms)
    return src.int(), w, d


def _allowed_source_areas(spec: MultiAreaSpec):
    """``(allowed[A, max_deg], n_allowed[A])`` int64 numpy arrays: row ``a``
    lists the areas allowed to project into ``a``."""
    adj = spec.adjacency_matrix()
    n_allowed = adj.sum(axis=0).astype(np.int64)
    allowed = np.zeros((spec.n_areas, max(int(n_allowed.max(initial=0)), 1)), np.int64)
    for a in range(spec.n_areas):
        srcs = np.flatnonzero(adj[:, a])
        allowed[a, : len(srcs)] = srcs
    return allowed, n_allowed


def _inter_rows(spec, seed, rows, n_pad, sizes, allowed, n_allowed, *, weights: bool = True):
    """(src, w, delay) inter tables ``[R, K_e]`` for global target rows
    (``w`` None without ``weights``)."""
    idx = _flat_idx(rows, spec.k_inter)
    a_of = rows // n_pad
    pick = _counter_hash(seed, _TAG_SRC_AREA, idx) % n_allowed[a_of][:, None]
    src_area = torch.gather(allowed[a_of], 1, pick)
    src_idx = _counter_hash(seed, _TAG_SRC_IDX, idx) % sizes[src_area]
    w = (_counter_weights(spec, seed, _TAG_W_INTER, idx, src_idx, sizes[src_area])
         if weights else None)
    d = _counter_delays(seed, _TAG_D_INTER_U1, _TAG_D_INTER_U2, idx,
                        spec.delay_inter_mean_ms, spec.delay_inter_std_ms,
                        spec.steps_inter_min, spec.steps_inter_max, spec.dt_ms)
    return (src_area * n_pad + src_idx).int(), w, d


def draw_pathway_rows(
    spec: MultiAreaSpec,
    seed: int,
    rows: torch.Tensor,
    *,
    pathway: str,
    size_multiple: int = 1,
):
    """Counter-based ``(src, w, delay)`` draws ``[R, K]`` for the given global
    target rows (int64, on the device the draws should run on): for any subset
    of ``arange(A * n_pad)``, equal to the same rows of :func:`build_network`'s
    tables. ``pathway`` is ``'intra'`` or ``'inter'``."""
    n_pad = spec.padded_area_size(size_multiple)
    dev = rows.device
    sizes = torch.as_tensor(spec.area_sizes(), dtype=torch.int64, device=dev)
    rows = rows.long()
    if pathway == "intra":
        return _intra_rows(spec, seed, rows, n_pad, sizes)
    if pathway == "inter":
        allowed, n_allowed = (torch.as_tensor(x, device=dev)
                              for x in _allowed_source_areas(spec))
        return _inter_rows(spec, seed, rows, n_pad, sizes, allowed, n_allowed)
    raise ValueError(f"unknown pathway {pathway!r} ('intra' | 'inter')")


def _outgoing_k_bound(k: int) -> int:
    """Deterministic upper estimate of the outgoing row width ``K_out``.

    The real ``K_out`` is the largest in-edge count over source neurons,
    concentrated around the in-degree ``k`` with Poisson fluctuations:
    mean + ~6 sigma (+ slack for tiny ``k``).
    """
    if k <= 0:
        return 0
    return int(k + math.ceil(6.0 * math.sqrt(k)) + 8)


def _source_counts(src: torch.Tensor, n_src: int, chunk_rows: int) -> torch.Tensor:
    """Entries per source id of an incoming ``[N_tgt, K]`` table (int64)."""
    counts = torch.zeros(n_src, dtype=torch.int64, device=src.device)
    for r0 in range(0, src.shape[0], chunk_rows):
        counts += torch.bincount(src[r0:r0 + chunk_rows].reshape(-1).long(),
                                 minlength=n_src)
    return counts


def _invert_chunks(tgt, wout, dout, chunks, *, checked: bool = False) -> None:
    """Fill the outgoing rows ``tgt/wout/dout [n_src, K_out]`` (preallocated
    with their padding) from incoming tables given as consecutive target-row
    chunks ``(src [R, K], w, d, tgt_ids [R])``.

    The JAX package sorts all entries by source with one stable argsort, so
    each source's targets come in (target row, k) order. This is a counting
    sort over the chunks in the same order: a per-source cursor, and within
    a chunk each entry's rank among the chunk's entries of its source (a
    stable sort of the chunk), so an entry lands at ``cursor[src] + rank``.
    ``checked`` (for a width fixed beforehand, as a build plan fixes it)
    raises if a source has more entries than ``K_out`` holds; it reads one
    count a chunk on the host.
    """
    n_src, k_out = tgt.shape
    if k_out == 0:
        return
    cursor = None
    tgt_f, wout_f, dout_f = tgt.view(-1), wout.view(-1), dout.view(-1)
    for src, w, d, tgt_ids in chunks:
        k = src.shape[1]
        if k == 0:
            continue
        flat = src.reshape(-1).long()
        counts = torch.bincount(flat, minlength=n_src)
        cursor = torch.zeros_like(counts) if cursor is None else cursor
        if checked and int((cursor + counts).max()) > k_out:
            raise AssertionError(f"a source has more than the table's {k_out} entries")
        key, perm = torch.sort(flat, stable=True)
        rank = (torch.arange(key.numel(), device=key.device)
                - torch.searchsorted(key, key, side="left"))
        dst = key * k_out + cursor[key] + rank
        tgt_f[dst] = tgt_ids[perm // k].to(torch.int32)
        wout_f[dst] = w.reshape(-1)[perm]
        dout_f[dst] = d.reshape(-1)[perm]
        cursor += counts


def _invert_adjacency(tgt, wout, dout, src, w, d, *, chunk_rows: int, tgt_ids=None) -> None:
    """:func:`_invert_chunks` over the incoming tables ``src/w/d [N_tgt, K]``
    in chunks of ``chunk_rows`` target rows. Target ids are the row indices,
    or ``tgt_ids [N_tgt]`` (the rows of a shard's cut)."""
    n_tgt, k = src.shape
    if k == 0 or tgt.shape[1] == 0:
        return
    if tgt_ids is None:
        tgt_ids = torch.arange(n_tgt, device=src.device)

    def chunks():
        for r0 in range(0, n_tgt, chunk_rows):
            r1 = min(n_tgt, r0 + chunk_rows)
            yield src[r0:r1], w[r0:r1], d[r0:r1], tgt_ids[r0:r1]

    _invert_chunks(tgt, wout, dout, chunks())


def _outgoing(src, w, d, n_src: int, chunk_rows: int):
    """Outgoing ``(tgt, wout, dout)`` of one or more incoming tables
    ``src/w/d [G, N_tgt, K]`` over the source ids ``[0, n_src)``, each
    ``[G, n_src, K_out]`` with ``K_out`` the widest source of all ``G``."""
    counts = [_source_counts(s, n_src, chunk_rows) for s in src]
    k_out = max(int(c.max()) if c.numel() else 0 for c in counts)
    shape = (src.shape[0], n_src, k_out)
    tgt = torch.full(shape, -1, dtype=torch.int32, device=src.device)
    wout = torch.zeros(shape, dtype=torch.float32, device=src.device)
    # The incoming delay dtype is kept: int8 tables stay int8.
    dout = torch.ones(shape, dtype=d.dtype, device=src.device)
    for g in range(src.shape[0]):
        _invert_adjacency(tgt[g], wout[g], dout[g], src[g], w[g], d[g],
                          chunk_rows=chunk_rows)
    return tgt, wout, dout


def add_outgoing_tables(net: Network, outgoing: bool | str = True, *,
                        chunk_rows: int = CHUNK_ROWS) -> Network:
    """``net`` with its outgoing tables, built on ``net``'s device.

    ``outgoing=True`` inverts both pathways, ``"intra"`` the intra tier
    only. Intra tables are inverted per area (sources and targets are
    indices within the area) and padded to the widest area; inter tables
    over the global id space. Bitwise equal to the JAX package's
    ``build_network(..., outgoing=...)`` tables, ``K_out`` included.
    """
    if outgoing not in (True, "intra"):
        raise ValueError(f"outgoing={outgoing!r} (expected True or 'intra')")
    A, n_pad = net.n_areas, net.n_pad
    chunk = max(1, int(chunk_rows))
    out = dict(zip(("tgt_intra", "wout_intra", "dout_intra"), _outgoing(
        net.src_intra, net.w_intra, net.delay_intra, n_pad, chunk)))
    if net.k_inter > 0 and outgoing != "intra":
        flat = lambda x: x.reshape(1, A * n_pad, net.k_inter)  # noqa: E731
        tables = _outgoing(flat(net.src_inter), flat(net.w_inter),
                           flat(net.delay_inter), A * n_pad, chunk)
        out.update(zip(("tgt_inter", "wout_inter", "dout_inter"),
                       (x.view(A, n_pad, -1) for x in tables)))
    return dataclasses.replace(net, **out)


def area_masks(spec: MultiAreaSpec, n_pad: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The network's ``(alive [A, n_pad] bool, rate_hz [A, n_pad] f32)`` on
    ``device``: live neurons first in each area, ghosts at rate 0."""
    alive = torch.arange(n_pad)[None, :] < torch.as_tensor(spec.area_sizes())[:, None]
    rate = torch.where(
        alive, torch.as_tensor(spec.area_rates(), dtype=torch.float32)[:, None], 0.0)
    return alive.to(device), rate.to(device)


def build_network(
    spec: MultiAreaSpec,
    *,
    seed: int = 12,
    size_multiple: int = 1,
    outgoing: bool = False,
    device=None,
    chunk_rows: int = CHUNK_ROWS,
) -> Network:
    """Instantiate the connectivity tables for ``spec`` on ``device``.

    Bitwise equal to the JAX package's ``build_network(spec, seed=seed,
    size_multiple=size_multiple, outgoing=outgoing)``. ``device`` defaults
    to ``"cuda"`` and raises when no GPU is present; pass ``device="cpu"``
    to build on the host. Rows are drawn ``chunk_rows`` at a time straight
    into the tables. ``outgoing`` (``True`` or ``"intra"``) adds the
    outgoing tables the event backend reads (:func:`add_outgoing_tables`).
    """
    if outgoing not in (False, True, "intra"):
        raise ValueError(f"outgoing={outgoing!r} (expected bool or 'intra')")
    dev = resolve_device(device)
    A = spec.n_areas
    n_pad = spec.padded_area_size(size_multiple)
    sizes_np = spec.area_sizes()
    n_rows = A * n_pad
    K_i, K_e = spec.k_intra, spec.k_inter

    alive, rate = area_masks(spec, n_pad, dev)

    sizes = torch.as_tensor(sizes_np, dtype=torch.int64, device=dev)
    allowed, n_allowed = (torch.as_tensor(x, device=dev)
                          for x in _allowed_source_areas(spec))
    dt_i, dt_e = _delay_dtype(spec.steps_intra_max), _delay_dtype(spec.steps_inter_max)
    src_intra = torch.empty((n_rows, K_i), dtype=torch.int32, device=dev)
    w_intra = torch.empty((n_rows, K_i), dtype=torch.float32, device=dev)
    delay_intra = torch.empty((n_rows, K_i), dtype=dt_i, device=dev)
    src_inter = torch.empty((n_rows, K_e), dtype=torch.int32, device=dev)
    w_inter = torch.empty((n_rows, K_e), dtype=torch.float32, device=dev)
    delay_inter = torch.empty((n_rows, K_e), dtype=dt_e, device=dev)

    chunk = max(1, int(chunk_rows))
    for r0 in range(0, n_rows, chunk):
        r1 = min(n_rows, r0 + chunk)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        if K_i > 0:
            s_, w_, d_ = _intra_rows(spec, seed, rows, n_pad, sizes)
            src_intra[r0:r1], w_intra[r0:r1], delay_intra[r0:r1] = s_, w_, d_
        if K_e > 0:
            s_, w_, d_ = _inter_rows(spec, seed, rows, n_pad, sizes, allowed, n_allowed)
            src_inter[r0:r1], w_inter[r0:r1], delay_inter[r0:r1] = s_, w_, d_

    def window(d: torch.Tensor, lo_default: int) -> tuple[int, int]:
        """The tightest [lo, lo + span) covering a pathway's delay draws."""
        if d.numel() == 0:
            return lo_default, 0
        lo, hi = int(d.min()), int(d.max())
        return lo, hi - lo + 1

    lo_i, span_i = window(delay_intra, 1)
    lo_e, span_e = window(delay_inter, spec.delay_ratio)
    net = Network(
        alive=alive,
        rate_hz=rate,
        src_intra=src_intra.view(A, n_pad, K_i),
        w_intra=w_intra.view(A, n_pad, K_i),
        delay_intra=delay_intra.view(A, n_pad, K_i),
        src_inter=src_inter.view(A, n_pad, K_e),
        w_inter=w_inter.view(A, n_pad, K_e),
        delay_inter=delay_inter.view(A, n_pad, K_e),
        n_pad=n_pad,
        n_areas=A,
        ring_len=spec.ring_len,
        delay_ratio=spec.delay_ratio,
        dt_ms=spec.dt_ms,
        steps_lo_intra=lo_i,
        r_span_intra=span_i,
        steps_lo_inter=lo_e,
        r_span_inter=span_e,
    )
    return add_outgoing_tables(net, outgoing, chunk_rows=chunk) if outgoing else net


# ---------------------------------------------------------------------------
# Per-shard cuts: the distributed engine's receive tables
# ---------------------------------------------------------------------------


def _inbound_k_bound(k: int, n_shards: int) -> int:
    """Deterministic upper estimate of one shard's inbound row width: a
    source's ``k`` outgoing synapses spread over ``n_shards`` shards, mean +
    ~6 sigma + 16."""
    if k <= 0 or n_shards <= 0:
        return 0
    k_s = -(-k // n_shards)
    return int(k_s + math.ceil(6.0 * math.sqrt(k_s)) + 16)


def _drawn_k_bound(spec: MultiAreaSpec, pathway: str, windows, rows, slack: int) -> int:
    """Width bound of a table that keeps, per source neuron, its synapses
    onto one window's targets: ``rows`` target rows of each area of one of
    ``windows`` (tuples of areas), the widest window and source area taken.

    The draws fix the expectation. Every target row of area ``b``, ghost
    rows too, draws ``K`` sources: an intra one uniformly in ``b``, an inter
    one from an allowed area picked uniformly and then uniformly within it.
    So a neuron of area ``a`` expects ``rows x K / n_a`` synapses from each
    area of the window (intra: only ``a``; inter: times ``adj[a, b] /
    n_allowed[b]``). The bound is the largest expectation, rounded up, + 6
    sigma + ``slack``. The reference's bounds (:func:`_outgoing_k_bound`,
    :func:`_inbound_k_bound`) assume ``K / S`` instead: they agree where
    every source's synapses spread evenly (equal areas without ghost rows;
    the window cut) and fall short where they do not (a few areas a group;
    the MAM's areas of unequal size).
    """
    k = spec.k_intra if pathway == "intra" else spec.k_inter
    if k <= 0:
        return 0
    sizes = spec.area_sizes()
    adj = spec.adjacency_matrix()
    n_allowed = adj.sum(axis=0)

    def share(a: int, b: int) -> Fraction:
        if pathway == "intra":
            return Fraction(int(a == b))
        return Fraction(int(adj[a, b]), int(n_allowed[b])) if adj[a, b] else Fraction(0)

    mean = max(sum((share(a, b) for b in window), Fraction(0)) * Fraction(rows) * k
               / int(sizes[a]) for a in range(spec.n_areas) for window in windows)
    k_s = math.ceil(mean)
    return int(k_s + math.ceil(6.0 * math.sqrt(k_s)) + slack)


def network_sds(
    spec: MultiAreaSpec,
    *,
    size_multiple: int = 1,
    outgoing: bool = False,
    inter_shards: int = 0,
    inter_shard_mode: str = "group",
    subgroup: int = 1,
) -> Network:
    """A shape-only stand-in for :func:`build_network`: a :class:`Network`
    whose tensors live on the ``meta`` device (nothing is allocated).

    The JAX package's ``network_sds`` (its ``ShapeDtypeStruct`` leaves),
    field for field, dtype for dtype and shape for shape but the widths, so
    the dry run can price the production MAM (~25 G synapses) on any host.
    ``outgoing=True`` adds the outgoing tables; ``inter_shards > 0``
    carries the ``[S, A * n_pad, K_in]`` inbound inter tables of
    :func:`shard_inter_tables` instead of the replicated ones; ``subgroup >
    1`` cuts them once more over the lanes, ``[S, subgroup, A * n_pad,
    K_in]``, and the outgoing intra tables likewise, ``[subgroup, A, n_pad,
    K_lane]`` (:func:`slice_intra_tables`). The instantiated widths are
    data-dependent; the stand-ins take the bound of the draws
    (:func:`_drawn_k_bound`), which the reference's bounds undercut where a
    source's synapses do not spread evenly. The delay windows are the
    spec's tier cutoffs, a superset of any instantiated window.
    """
    A = spec.n_areas
    n_pad = spec.padded_area_size(size_multiple)
    K_i, K_e = spec.k_intra, spec.k_inter
    dt_i = _delay_dtype(spec.steps_intra_max)
    dt_e = _delay_dtype(spec.steps_inter_max)

    def s(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def trio(names, shape, d_dtype):
        """Targets or sources (int32), weights (f32) and delays of one table."""
        return dict(zip(names, (s(shape, torch.int32), s(shape, torch.float32),
                                s(shape, d_dtype))))

    every = (tuple(range(A)),)
    out: dict = {}
    if outgoing:
        if subgroup > 1:
            k_li = _drawn_k_bound(spec, "intra", every, Fraction(n_pad, subgroup), 16)
            shape = (subgroup, A, n_pad, k_li)
        else:
            shape = (A, n_pad, _drawn_k_bound(spec, "intra", every, n_pad, 8))
        out.update(trio(OUTGOING_TABLES[:3], shape, dt_i))
        if K_e > 0 and inter_shards > 0:
            if subgroup > 1 and inter_shard_mode != "group":
                raise ValueError(
                    "subgroup slicing applies to the 'group' mode only "
                    "(the 'window' mode is already per-device)")
            if inter_shard_mode == "group":
                # A shard owns A / S whole areas; a lane, a window of each.
                a_loc = A // inter_shards
                windows = tuple(tuple(range(g * a_loc, (g + 1) * a_loc))
                                for g in range(inter_shards))
                rows = Fraction(n_pad, max(subgroup, 1))
            else:  # a shard owns an n_pad / S window of every area
                windows, rows = every, Fraction(n_pad, inter_shards)
            k_ie = _drawn_k_bound(spec, "inter", windows, rows, 16)
            lead = (inter_shards, subgroup) if subgroup > 1 else (inter_shards,)
            out.update(trio(INBOUND_TABLES, (*lead, A * n_pad, k_ie), dt_e))
            out["inter_shard_mode"] = inter_shard_mode
        elif K_e > 0:
            k_oe = _drawn_k_bound(spec, "inter", every, n_pad, 8)
            out.update(trio(OUTGOING_TABLES[3:], (A, n_pad, k_oe), dt_e))
    return Network(
        alive=s((A, n_pad), torch.bool),
        rate_hz=s((A, n_pad), torch.float32),
        **trio(_TABLES[2:5], (A, n_pad, K_i), dt_i),
        **trio(_TABLES[5:], (A, n_pad, K_e), dt_e),
        n_pad=n_pad,
        n_areas=A,
        ring_len=spec.ring_len,
        delay_ratio=spec.delay_ratio,
        dt_ms=spec.dt_ms,
        steps_lo_intra=1,
        r_span_intra=spec.steps_intra_max if K_i > 0 else 0,
        steps_lo_inter=spec.steps_inter_min,
        r_span_inter=(spec.steps_inter_max - spec.steps_inter_min + 1) if K_e > 0 else 0,
        **out,
    )


def _inbound_target_rows(
    mode: str, shard: int, n_shards: int, n_areas: int, n_pad: int,
    subgroup: int = 1, lane: int = 0,
) -> np.ndarray:
    """Global row ids of the targets shard ``shard`` (lane ``lane``) owns:
    :func:`repro_torch.core.partition.shard_pathway_rows`."""
    return shard_pathway_rows(mode, shard, n_shards, n_areas, n_pad,
                              subgroup=subgroup, lane=lane)


def _inverted(src, w, d, n_src: int, tgt_ids, *, chunk_rows: int = CHUNK_ROWS):
    """Outgoing ``(tgt, w, d) [n_src, K_out]`` of the incoming ``[R, K]``
    rows whose targets are ``tgt_ids [R]``; ``K_out`` is the widest source."""
    counts = _source_counts(src, n_src, chunk_rows)
    k_out = int(counts.max()) if counts.numel() else 0
    tgt = torch.full((n_src, k_out), -1, dtype=torch.int32, device=src.device)
    wout = torch.zeros((n_src, k_out), dtype=torch.float32, device=src.device)
    dout = torch.ones((n_src, k_out), dtype=d.dtype, device=src.device)
    _invert_adjacency(tgt, wout, dout, src, w, d, chunk_rows=chunk_rows, tgt_ids=tgt_ids)
    return tgt, wout, dout


def _check_cut(mode: str, n_areas: int, n_pad: int, n_shards: int, subgroup: int) -> None:
    if mode not in ("group", "window"):
        raise ValueError(f"unknown inter_shard_mode {mode!r}")
    if subgroup > 1 and mode != "group":
        raise ValueError(
            "subgroup slicing applies to the 'group' mode only (the "
            "'window' mode is already per-device)")
    if mode == "group" and n_areas % n_shards != 0:
        raise ValueError(f"n_areas={n_areas} not divisible by {n_shards} shards")
    if mode == "window" and n_pad % n_shards != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by {n_shards} shards")
    if subgroup > 1 and n_pad % subgroup != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by subgroup={subgroup}")


def inbound_slice(
    net: Network, n_shards: int, shard: int, *, mode: str = "group",
    subgroup: int = 1, lane: int = 0, chunk_rows: int = CHUNK_ROWS,
):
    """One shard's (lane's) inbound inter table ``(tgt, w, d) [A * n_pad,
    K]``: slice ``[shard]`` (``[shard, lane]``) of :func:`shard_inter_tables`
    at its own width, inverted from the incoming rows the shard owns."""
    A, n_pad, K_e = net.n_areas, net.n_pad, net.k_inter
    rows = torch.as_tensor(
        _inbound_target_rows(mode, shard, n_shards, A, n_pad, subgroup, lane),
        device=net.device)

    def own(x):
        return x.reshape(A * n_pad, K_e)[rows]

    return _inverted(own(net.src_inter), own(net.w_inter), own(net.delay_inter),
                     A * n_pad, rows, chunk_rows=chunk_rows)


def shard_inter_tables(
    net: Network, n_shards: int, *, mode: str = "group", subgroup: int = 1,
    chunk_rows: int = CHUNK_ROWS,
) -> Network:
    """Re-cut the inter tables into per-shard inbound slices.

    ``tgt_inter_in[s]`` holds, for every source row, only the synapses whose
    target lives in shard ``s`` (``'group'``: shards own ``A / S``
    consecutive areas; ``'window'``: shards own an ``n_pad / S`` neuron
    window of every area), targets as global ids, padded with -1 / 0 / 1 to
    the widest slice: a ``[S, A * n_pad, K_in]`` stack. With ``subgroup >
    1`` (``'group'`` only) each slice is cut once more over the lanes'
    ``n_pad / subgroup`` windows, ``[S, subgroup, A * n_pad, K_in]``. Built
    from the incoming tensors; the replicated outgoing inter tables are
    dropped. Bitwise the JAX package's ``shard_inter_tables``.
    """
    _check_cut(mode, net.n_areas, net.n_pad, n_shards, max(subgroup, 1))
    if net.k_inter == 0:
        return dataclasses.replace(net, inter_shard_mode=mode)
    sub = max(subgroup, 1)
    parts = [inbound_slice(net, n_shards, shard, mode=mode, subgroup=sub, lane=lane,
                           chunk_rows=chunk_rows)
             for shard in range(n_shards) for lane in range(sub)]
    k_in = max(p[0].shape[1] for p in parts)
    lead = (n_shards, sub) if sub > 1 else (n_shards,)

    def stack(j, fill):
        out = torch.stack([torch.nn.functional.pad(p[j], (0, k_in - p[j].shape[1]), value=fill)
                           for p in parts])
        return out.view(*lead, net.n_areas * net.n_pad, k_in)

    return dataclasses.replace(
        net, tgt_inter_in=stack(0, -1), wout_inter_in=stack(1, 0.0),
        dout_inter_in=stack(2, 1), inter_shard_mode=mode,
        tgt_inter=None, wout_inter=None, dout_inter=None)


def _compact(tgt, w, d, keep_fn, *, chunk_rows: int = CHUNK_ROWS):
    """``(tgt, w, d, widest)``: each row with the entries ``keep_fn(r0, r1,
    tgt[r0:r1])`` keeps moved to its front in their order (a stable
    compaction), the rest padding -1 / 0 / 1; same width. ``widest`` is the
    most entries a row keeps."""
    out_t = torch.full_like(tgt, -1)
    out_w = torch.zeros_like(w)
    out_d = torch.ones_like(d)
    cols = torch.arange(tgt.shape[1], device=tgt.device)[None, :]
    widest = 0
    for r0 in range(0, tgt.shape[0], chunk_rows):
        r1 = min(tgt.shape[0], r0 + chunk_rows)
        keep = keep_fn(r0, r1, tgt[r0:r1])
        order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
        cnt = keep.sum(dim=1, keepdim=True)
        valid = cols < cnt
        out_t[r0:r1] = torch.where(valid, tgt[r0:r1].gather(1, order), -1)
        out_w[r0:r1] = torch.where(valid, w[r0:r1].gather(1, order), 0.0)
        out_d[r0:r1] = torch.where(valid, d[r0:r1].gather(1, order), 1).to(d.dtype)
        if cnt.numel():
            widest = max(widest, int(cnt.max()))
    return out_t, out_w, out_d, widest


def slice_intra_tables(net: Network, subgroup: int) -> Network:
    """Cut the outgoing intra tables over the subgroup's neuron windows:
    lane ``l`` keeps, per source row, only the synapses whose within-area
    target lies in its ``n_pad / subgroup`` window, in their order, as a
    ``[subgroup, A, n_pad, K_lane]`` stack. Bitwise the JAX package's
    ``slice_intra_tables``."""
    if subgroup <= 1 or net.tgt_intra is None:
        return net
    if net.tgt_intra.dim() == 4:
        raise ValueError("outgoing intra tables are already subgroup-sliced")
    A, n_pad = net.n_areas, net.n_pad
    if n_pad % subgroup != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by subgroup={subgroup}")
    flat = [x.reshape(A * n_pad, -1) for x in (net.tgt_intra, net.wout_intra, net.dout_intra)]
    n_loc = n_pad // subgroup
    lanes = []
    for lane in range(subgroup):
        lo = lane * n_loc
        lanes.append(_compact(*flat, lambda r0, r1, t, lo=lo: (t >= lo) & (t < lo + n_loc)))
    k_lane = max(ln[3] for ln in lanes)

    def stack(j):
        return torch.stack([ln[j][:, :k_lane] for ln in lanes]).view(subgroup, A, n_pad, k_lane)

    return dataclasses.replace(net, tgt_intra=stack(0), wout_intra=stack(1), dout_intra=stack(2))


# ---------------------------------------------------------------------------
# Host-free sharded construction. Every synapse is a pure function of (seed,
# pathway, global target row, k), so a shard can draw exactly its own rows
# and invert them, bitwise equal to cutting the global network. The only
# global facts a shard needs are the padded widths and the delay windows,
# which a counting pass over the draws fixes (sharded_build_plan).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBuildPlan:
    """The global layout facts of a host-free build, from counts of the
    draws only: the widths every shard's (lane's) tables are padded to, the
    realised delay windows and the realised area adjacency. Field for field
    the JAX package's plan."""

    n_shards: int
    subgroup: int
    mode: str            # 'group' | 'window' (see shard_pathway_rows)
    size_multiple: int
    n_pad: int
    k_in: int            # inbound inter slice width
    k_out_intra: int     # outgoing intra width (subgroup == 1 layout)
    k_lane_intra: int    # lane-cut outgoing intra width (subgroup > 1)
    steps_lo_intra: int
    r_span_intra: int
    steps_lo_inter: int
    r_span_inter: int
    area_adj: tuple      # realised area -> area adjacency, nested 0/1 tuples


def _plan_row_chunks(rows: torch.Tensor, chunk_rows: int):
    for i in range(0, rows.numel(), max(1, chunk_rows)):
        yield rows[i:i + chunk_rows]


class _Window:
    """Running min / max of a pathway's delay draws, on the device."""

    def __init__(self):
        self.lo = self.hi = None

    def add(self, d):
        lo, hi = d.min(), d.max()
        self.lo = lo if self.lo is None else torch.minimum(self.lo, lo)
        self.hi = hi if self.hi is None else torch.maximum(self.hi, hi)

    def span(self, lo_default: int) -> tuple[int, int]:
        if self.lo is None:
            return lo_default, 0
        lo = int(self.lo)
        return lo, int(self.hi) - lo + 1


def sharded_build_plan(
    spec: MultiAreaSpec,
    seed: int,
    n_shards: int,
    *,
    mode: str = "group",
    subgroup: int = 1,
    size_multiple: int = 1,
    device=None,
    chunk_rows: int = CHUNK_ROWS,
) -> ShardedBuildPlan:
    """Pass 1 of the host-free build: one counting pass over the draws, in
    row chunks on ``device`` (default ``"cuda"``), that fixes what the
    global build's padding and metadata would (the JAX package's
    ``sharded_build_plan``, bitwise)."""
    dev = resolve_device(device)
    A = spec.n_areas
    n_pad = spec.padded_area_size(size_multiple)
    K_i, K_e = spec.k_intra, spec.k_inter
    sub = max(subgroup, 1)
    _check_cut(mode, A, n_pad, n_shards, sub)
    sizes = torch.as_tensor(spec.area_sizes(), dtype=torch.int64, device=dev)

    k_out_intra = k_lane_intra = 0
    win_i = _Window()
    n_loc = n_pad // sub
    if K_i > 0:
        for a in range(A):
            counts = torch.zeros(n_pad, dtype=torch.int64, device=dev)
            lane_counts = torch.zeros(n_pad * sub, dtype=torch.int64, device=dev)
            area_rows = torch.arange(a * n_pad, (a + 1) * n_pad, dtype=torch.int64, device=dev)
            for rows in _plan_row_chunks(area_rows, chunk_rows):
                src, _, d = _intra_rows(spec, seed, rows, n_pad, sizes, weights=False)
                win_i.add(d)
                counts += torch.bincount(src.reshape(-1).long(), minlength=n_pad)
                if sub > 1:
                    key = src.long() * sub + ((rows % n_pad) // n_loc)[:, None]
                    lane_counts += torch.bincount(key.reshape(-1), minlength=n_pad * sub)
            k_out_intra = max(k_out_intra, int(counts.max()))
            if sub > 1:
                k_lane_intra = max(k_lane_intra, int(lane_counts.max()))

    k_in = 0
    win_e = _Window()
    adj = torch.zeros(A * A, dtype=torch.bool, device=dev)
    if K_e > 0:
        allowed, n_allowed = (torch.as_tensor(x, device=dev)
                              for x in _allowed_source_areas(spec))
        for shard in range(n_shards):
            for lane in range(sub):
                counts = torch.zeros(A * n_pad, dtype=torch.int64, device=dev)
                own = torch.as_tensor(
                    _inbound_target_rows(mode, shard, n_shards, A, n_pad, sub, lane), device=dev)
                for rows in _plan_row_chunks(own, chunk_rows):
                    src, _, d = _inter_rows(spec, seed, rows, n_pad, sizes, allowed,
                                            n_allowed, weights=False)
                    win_e.add(d)
                    counts += torch.bincount(src.reshape(-1).long(), minlength=A * n_pad)
                    adj[(src.long() // n_pad) * A + (rows // n_pad)[:, None]] = True
                k_in = max(k_in, int(counts.max()))

    lo_i, span_i = win_i.span(1)
    lo_e, span_e = win_e.span(spec.delay_ratio)
    adj_np = adj.view(A, A).cpu().numpy()
    return ShardedBuildPlan(
        n_shards=n_shards, subgroup=sub, mode=mode, size_multiple=size_multiple,
        n_pad=n_pad, k_in=k_in, k_out_intra=k_out_intra, k_lane_intra=k_lane_intra,
        steps_lo_intra=lo_i, r_span_intra=span_i, steps_lo_inter=lo_e, r_span_inter=span_e,
        area_adj=tuple(tuple(int(v) for v in row) for row in adj_np))


def _empty_tables(rows: int, k: int, d_dtype, dev):
    return (torch.full((rows, k), -1, dtype=torch.int32, device=dev),
            torch.zeros((rows, k), dtype=torch.float32, device=dev),
            torch.ones((rows, k), dtype=d_dtype, device=dev))


def build_shard_tables(
    spec: MultiAreaSpec,
    seed: int,
    shard: int,
    *,
    plan: ShardedBuildPlan,
    lane: int = 0,
    device=None,
    chunk_rows: int = CHUNK_ROWS,
):
    """Pass 2, inter pathway: one shard's (lane's) inbound inter slice
    ``(tgt, w, d) [A * n_pad, plan.k_in]`` on ``device``, drawn and inverted
    from the shard's own rows in chunks: bitwise slice ``[shard]``
    (``[shard, lane]``) of :func:`shard_inter_tables` on the global network.
    """
    dev = resolve_device(device)
    A, n_pad, K_e = spec.n_areas, plan.n_pad, spec.k_inter
    out = _empty_tables(A * n_pad, plan.k_in if K_e else 0,
                        _delay_dtype(spec.steps_inter_max), dev)
    if K_e == 0:
        return out
    rows = torch.as_tensor(_inbound_target_rows(
        plan.mode, shard, plan.n_shards, A, n_pad, plan.subgroup, lane), device=dev)
    sizes = torch.as_tensor(spec.area_sizes(), dtype=torch.int64, device=dev)
    allowed, n_allowed = (torch.as_tensor(x, device=dev) for x in _allowed_source_areas(spec))

    def chunks():
        for r in _plan_row_chunks(rows, chunk_rows):
            yield (*_inter_rows(spec, seed, r, n_pad, sizes, allowed, n_allowed), r)

    _invert_chunks(*out, chunks(), checked=True)
    return out


def _intra_tables(spec, seed, areas, lo: int, n_rows: int, k: int, plan, dev, chunk_rows):
    """Outgoing intra tables ``[len(areas), n_pad, k]`` of the target rows
    ``[lo, lo + n_rows)`` of each area (targets: indices within the area)."""
    n_pad = plan.n_pad
    areas = np.asarray(areas, dtype=np.int64)
    sizes = torch.as_tensor(spec.area_sizes(), dtype=torch.int64, device=dev)
    out = _empty_tables(len(areas) * n_pad, k if spec.k_intra else 0,
                        _delay_dtype(spec.steps_intra_max), dev)
    tgt_ids = torch.arange(lo, lo + n_rows, dtype=torch.int64, device=dev)
    for i, a in enumerate(areas):
        if spec.k_intra:
            def chunks(a=int(a)):
                for t in _plan_row_chunks(tgt_ids, chunk_rows):
                    yield (*_intra_rows(spec, seed, a * n_pad + t, n_pad, sizes), t)

            _invert_chunks(*(x[i * n_pad:(i + 1) * n_pad] for x in out), chunks(), checked=True)
    return tuple(x.view(len(areas), n_pad, x.shape[-1]) for x in out)


def build_group_intra_tables(
    spec: MultiAreaSpec, seed: int, areas, *, plan: ShardedBuildPlan, device=None,
    chunk_rows: int = CHUNK_ROWS,
):
    """Pass 2, intra pathway (no subgroup cut): the outgoing intra tables of
    ``areas``, ``[len(areas), n_pad, plan.k_out_intra]``, bitwise those rows
    of ``build_network(..., outgoing=True)``."""
    return _intra_tables(spec, seed, areas, 0, plan.n_pad, plan.k_out_intra, plan,
                         resolve_device(device), chunk_rows)


def build_lane_intra_tables(
    spec: MultiAreaSpec, seed: int, areas, lane: int, *, plan: ShardedBuildPlan,
    device=None, chunk_rows: int = CHUNK_ROWS,
):
    """Pass 2, intra pathway (subgroup cut): lane ``lane``'s cut of the
    outgoing intra tables of ``areas``, ``[len(areas), n_pad,
    plan.k_lane_intra]``, bitwise ``slice_intra_tables(...)[lane, areas]``.
    The lane's cut keeps the synapses onto its window's targets in (target,
    k) order, which is the inversion of the window's own incoming rows, so
    only those rows are drawn."""
    n_loc = plan.n_pad // plan.subgroup
    return _intra_tables(spec, seed, areas, lane * n_loc, n_loc, plan.k_lane_intra, plan,
                         resolve_device(device), chunk_rows)


def construction_cost_model(
    spec: MultiAreaSpec,
    *,
    n_shards: int,
    subgroup: int = 1,
    size_multiple: int = 1,
) -> dict:
    """Modelled peak bytes of constructing the network, host build against
    sharded build: the JAX package's byte arithmetic, unchanged (nothing is
    allocated).

    * **host build** (``build_network(outgoing=True)`` +
      ``shard_inter_tables`` + ``slice_intra_tables``): the global incoming
      tables, the outgoing intra inversion, all S x subgroup inbound inter
      slices plus the stack's copy, and the lane intra cuts likewise.
    * **sharded build** (plan + per-shard builders): one (shard, lane)'s own
      draws and inversion temporaries, the planning pass's global counts,
      and that shard's output slice.

    It prices the reference's host build. This package's builds run on the
    device in row chunks (:data:`CHUNK_ROWS`) and stack no slice copies, so
    their measured peaks differ from it. Widths are the reference's bounds
    (:func:`_outgoing_k_bound`, :func:`_inbound_k_bound`), which fall short
    of the draws on unequal areas (:func:`_drawn_k_bound`).
    """
    A = spec.n_areas
    n_pad = spec.padded_area_size(size_multiple)
    K_i, K_e = spec.k_intra, spec.k_inter
    sub = max(subgroup, 1)
    n_rows = A * n_pad
    by_i = 8 + _delay_dtype(spec.steps_intra_max).itemsize
    by_e = 8 + _delay_dtype(spec.steps_inter_max).itemsize

    k_oi = _outgoing_k_bound(K_i)
    k_ie = _inbound_k_bound(K_e, n_shards * sub)
    k_li = _inbound_k_bound(K_i, sub) if sub > 1 else k_oi

    incoming = n_rows * (K_i * by_i + K_e * by_e)
    outgoing_intra = n_rows * k_oi * by_i
    inbound_slices = n_shards * sub * n_rows * k_ie * by_e
    lane_intra = sub * n_rows * k_li * by_i if sub > 1 else 0
    # Slices accumulate, then the stack copies them once more (x2 transient).
    host_peak = incoming + outgoing_intra + 2 * inbound_slices + 2 * lane_intra

    rows_loc = n_rows // (n_shards * sub) if spec.k_inter else 0
    # One shard's draws (src int32 + w f32 + d) + inversion temporaries
    # (int64 flat order/sort/repeat ~ 3 x 8 B per synapse) + the planning
    # pass's global counts array + the single output slice.
    shard_draws = rows_loc * K_e * (by_e + 24)
    shard_intra = n_pad * K_i * (by_i + 24)
    shard_out = n_rows * k_ie * by_e + n_pad * max(k_li, k_oi) * by_i
    counts_arr = n_rows * 8
    shard_peak = max(shard_draws, shard_intra) + shard_out + counts_arr

    return dict(
        n_shards=n_shards,
        subgroup=sub,
        build_bytes_host_modelled=int(host_peak),
        build_bytes_shard_modelled=int(shard_peak),
        host_incoming_bytes=int(incoming),
        host_inbound_slice_bytes=int(inbound_slices),
        reduction=float(host_peak) / float(max(shard_peak, 1)),
    )


def area_adjacency(net: Network, spec: MultiAreaSpec | None = None) -> np.ndarray:
    """The realised area -> area adjacency: ``adj[src, tgt]`` iff any neuron
    of target area ``tgt`` (live or ghost: ghosts receive deposits too, so
    the routed exchange must ship to them for bitwise rings) draws a source
    from area ``src``.

    After a host-free build the plan's adjacency rides on the network
    (``net.area_adj``); otherwise it is read from the global ``src_inter``
    tables, area by area in row chunks on their device. A shape-only
    network (:func:`network_sds`, meta tensors: nothing to read) gets the
    spec's adjacency (``MultiAreaSpec.adjacency_matrix``, all-to-all by
    default; without a spec, every pair of distinct areas): a superset of
    any instantiation, so routing over it ships some empty packets but never
    drops a synapse.
    """
    A = net.n_areas
    if net.k_inter == 0:
        return np.zeros((A, A), dtype=bool)
    if net.area_adj is not None:
        return np.asarray(net.area_adj, dtype=bool)
    src = net.src_inter
    if src.device.type == "meta":
        return ~np.eye(A, dtype=bool) if spec is None else spec.adjacency_matrix()
    if tuple(src.shape[:2]) != (A, net.n_pad):
        raise ValueError(
            f"area_adjacency reads the global src_inter tables, not a "
            f"{tuple(src.shape)} cut (pass the global network)")
    adj = torch.zeros(A * A, dtype=torch.bool, device=src.device)
    rows = src.reshape(A * net.n_pad, -1)
    for r0 in range(0, rows.shape[0], CHUNK_ROWS):
        part = rows[r0:r0 + CHUNK_ROWS].long()
        tgt = (torch.arange(r0, r0 + part.shape[0], device=src.device) // net.n_pad)[:, None]
        adj[(part // net.n_pad) * A + tgt] = True
    return adj.view(A, A).cpu().numpy()


# ---------------------------------------------------------------------------
# The plan cache. The planning pass is deterministic in (spec, seed, shard
# layout) but sweeps every synapse draw; the keyed cache computes it once
# and shares it: an in-memory memo for repeat builds in one process, an
# atomic JSON file for the other ranks (the plan is counts only, so JSON
# round-trips it exactly).
# ---------------------------------------------------------------------------

_PLAN_MEMO: dict = {}

# Seconds a rank that does not compute waits for the computing rank's file.
_PLAN_CACHE_WAIT_S = 600.0


def plan_cache_key(
    spec: MultiAreaSpec,
    seed: int,
    n_shards: int,
    *,
    mode: str = "group",
    subgroup: int = 1,
    size_multiple: int = 1,
) -> str:
    """Content digest keying one planning pass (spec, draw and layout): the
    JAX package's key for the same arguments."""
    payload = json.dumps(
        {
            "spec": dataclasses.asdict(spec),
            "seed": int(seed),
            "n_shards": int(n_shards),
            "mode": mode,
            "subgroup": int(subgroup),
            "size_multiple": int(size_multiple),
        },
        sort_keys=True,
        default=repr,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _plan_to_json(plan: ShardedBuildPlan) -> dict:
    return dataclasses.asdict(plan)


def _plan_from_json(d: dict) -> ShardedBuildPlan:
    d = dict(d)
    d["area_adj"] = tuple(tuple(int(v) for v in row) for row in d["area_adj"])
    return ShardedBuildPlan(**d)


def _world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def cached_sharded_build_plan(
    spec: MultiAreaSpec,
    seed: int,
    n_shards: int,
    *,
    mode: str = "group",
    subgroup: int = 1,
    size_multiple: int = 1,
    cache_dir: str | None = None,
    process_index: int | None = None,
    wait_s: float = _PLAN_CACHE_WAIT_S,
    device=None,
) -> ShardedBuildPlan:
    """:func:`sharded_build_plan`, computed once per key instead of per call.

    Resolution order: the in-memory memo, then the ``cache_dir`` JSON file,
    then the counting pass on ``device``. ``cache_dir`` defaults to
    ``$REPRO_PLAN_CACHE``; with it set in a multi-rank run, rank 0 computes
    and atomically publishes the plan while every other rank polls for the
    file instead of repeating the pass (``process_index`` defaults to the
    rank, 0 without a process group). Without a cache directory every
    caller computes its own. The distributed engine calls it on rank 0
    alone and broadcasts the plan, with or without a cache directory.
    """
    key = plan_cache_key(spec, seed, n_shards, mode=mode, subgroup=subgroup,
                         size_multiple=size_multiple)
    if key in _PLAN_MEMO:
        return _PLAN_MEMO[key]
    if cache_dir is None:
        cache_dir = os.environ.get("REPRO_PLAN_CACHE") or None
    path = os.path.join(cache_dir, f"plan_{key}.json") if cache_dir else None

    def read() -> ShardedBuildPlan | None:
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return _plan_from_json(json.load(f))

    plan = read()
    if plan is None:
        rank, world = _world()
        if process_index is None:
            process_index = rank
        if path is not None and world > 1 and process_index != 0:
            # Rank 0 computes; wait for its publish.
            deadline = time.monotonic() + wait_s
            while plan is None and time.monotonic() < deadline:
                time.sleep(0.2)
                plan = read()
            if plan is None:
                raise TimeoutError(
                    f"process {process_index} waited {wait_s:.0f}s for {path} (is "
                    f"process 0 running with the same REPRO_PLAN_CACHE?)")
        else:
            plan = sharded_build_plan(spec, seed, n_shards, mode=mode, subgroup=subgroup,
                                      size_multiple=size_multiple, device=device)
            if path is not None:
                # Atomic publish: readers only ever see a complete file.
                os.makedirs(cache_dir, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(_plan_to_json(plan), f)
                os.replace(tmp, path)
    _PLAN_MEMO[key] = plan
    return plan


def tile_gids(n_areas: int, n_pad: int, copies: int, *, device=None) -> torch.Tensor:
    """The folded batch's gid table: the single-trial ids, tiled per copy.

    ``[copies * n_areas, n_pad]`` int32 on ``device`` (default ``"cuda"``),
    every copy repeating ``arange(n_areas * n_pad)``. Fed to the engine's
    ``gids`` override, it makes each block of a :func:`tile_network`
    super-network draw the single-trial counter drive bit for bit; trials
    differ by their ``seed`` state leaf, not by the gid table.
    """
    one = torch.arange(n_areas * n_pad, dtype=torch.int32,
                       device=resolve_device(device)).view(n_areas, n_pad)
    return one.repeat(copies, 1)


def tile_network(net: Network, copies: int) -> Network:
    """``copies`` disjoint replicas of ``net`` as one block-diagonal network.

    The serving layer's folded trial batching: the area axis is tiled
    ``B = copies`` times (``[A, n_pad, ...]`` -> ``[B * A, n_pad, ...]``)
    and every global neuron id is offset by ``b * A * n_pad`` in copy
    ``b``, so no synapse crosses a copy boundary. Within-area indices
    (``src_intra``, ``tgt_intra``) are copy-local already and tile
    unchanged. Each block then reproduces the single-trial trajectory bit
    for bit: weights live on the 1/256 grid and each copy's scatter order
    is the single-trial order.

    The offsets respect the tables' sentinels: the outgoing ``tgt_inter``
    pads with ``-1``, which stays ``-1`` (a shifted sentinel would be a
    valid id in another copy), so the tiled rows still ascend with ``-1``
    last (:func:`check_outgoing_order`); the incoming ``src_inter`` has no
    sentinels and is offset everywhere. A realised area adjacency
    (``area_adj``) is tiled block-diagonally; sharded inbound tables are
    refused, as the reference refuses them. Tables are written copy by copy
    on ``net``'s device, so the fold needs no temporary beyond one copy of
    one table.
    """
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    if copies == 1:
        return net
    if net.tgt_inter_in is not None:
        raise ValueError(
            "tile_network needs the unsharded network (sharded inbound "
            "inter tables slice a device layout, not a network axis); "
            "tile first, then shard_inter_tables")
    A, n_pad = net.alive.shape
    B = copies
    block = A * n_pad
    if B * block > torch.iinfo(torch.int32).max:
        raise ValueError(
            f"{B} copies x {block} padded neurons overflows the int32 "
            "global-id space")

    def rep(x):
        return x.repeat(B, *(1,) * (x.dim() - 1))

    def rep_global(x, sentinel: bool):
        out = torch.empty((B * A, *x.shape[1:]), dtype=x.dtype, device=x.device)
        for b in range(B):
            dst = out[b * A:(b + 1) * A]
            if sentinel:
                torch.where(x < 0, x, x + b * block, out=dst)
            else:
                torch.add(x, b * block, out=dst)
        return out

    arrays = {name: rep(getattr(net, name)) for name in _TABLES if name != "src_inter"}
    arrays["src_inter"] = (rep_global(net.src_inter, sentinel=False)
                           if net.src_inter.numel() else rep(net.src_inter))
    for name in OUTGOING_TABLES:
        x = getattr(net, name)
        if x is not None:
            arrays[name] = rep_global(x, sentinel=True) if name == "tgt_inter" else rep(x)
    area_adj = None
    if net.area_adj is not None:
        big = np.kron(np.eye(B, dtype=np.int64), np.asarray(net.area_adj, dtype=np.int64))
        area_adj = tuple(tuple(int(x) for x in row) for row in big)
    return dataclasses.replace(net, n_areas=B * A, area_adj=area_adj, **arrays)
