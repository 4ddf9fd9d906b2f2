"""Network instantiation: fixed-indegree connectivity with tiered delays.

Port of ``repro.core.connectivity`` (single-host incoming tables). The tables
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
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.areas import MultiAreaSpec
from repro_torch.device import resolve_device

__all__ = [
    "Network",
    "build_network",
    "add_outgoing_tables",
    "network_from_numpy",
    "check_outgoing_order",
    "draw_pathway_rows",
]

_TABLES = ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra",
           "src_inter", "w_inter", "delay_inter")
OUTGOING_TABLES = ("tgt_intra", "wout_intra", "dout_intra",
                   "tgt_inter", "wout_inter", "dout_inter")
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
    ``ring_len``, ``steps_lo_intra``, ...). The outgoing tables
    (``tgt_intra``, ...) are carried where ``arrays`` holds them (not None).
    Other keys in ``arrays`` (tables this port does not hold yet) are
    ignored.
    """
    dev = torch.device(device)
    names = _TABLES + tuple(k for k in OUTGOING_TABLES if arrays.get(k) is not None)
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
    for name in ("tgt_intra", "tgt_inter"):
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


def _intra_rows(spec, seed, rows, n_pad, sizes):
    """(src, w, delay) intra tables ``[R, K_i]`` for global target rows."""
    idx = _flat_idx(rows, spec.k_intra)
    sz = sizes[rows // n_pad][:, None]
    src = _counter_hash(seed, _TAG_SRC_INTRA, idx) % sz
    w = _counter_weights(spec, seed, _TAG_W_INTRA, idx, src, sz)
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


def _inter_rows(spec, seed, rows, n_pad, sizes, allowed, n_allowed):
    """(src, w, delay) inter tables ``[R, K_e]`` for global target rows."""
    idx = _flat_idx(rows, spec.k_inter)
    a_of = rows // n_pad
    pick = _counter_hash(seed, _TAG_SRC_AREA, idx) % n_allowed[a_of][:, None]
    src_area = torch.gather(allowed[a_of], 1, pick)
    src_idx = _counter_hash(seed, _TAG_SRC_IDX, idx) % sizes[src_area]
    w = _counter_weights(spec, seed, _TAG_W_INTER, idx, src_idx, sizes[src_area])
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


def _invert_adjacency(tgt, wout, dout, src, w, d, *, chunk_rows: int) -> None:
    """Fill the outgoing rows ``tgt/wout/dout [n_src, K_out]`` (preallocated
    with their padding) from the incoming ``src/w/d [N_tgt, K]``.

    The JAX package sorts all ``N_tgt x K`` entries by source with one
    stable argsort, so each source's targets come in (target row, k) order.
    This is a counting sort over target-row chunks in the same order: a
    per-source cursor, and within a chunk each entry's rank among the
    chunk's entries of its source (a stable sort of the chunk), so an entry
    lands at ``cursor[src] + rank``. Temporaries are a few chunk-sized
    int64 arrays, never the whole table.
    """
    n_tgt, k = src.shape
    n_src, k_out = tgt.shape
    if k == 0 or k_out == 0:
        return
    cursor = torch.zeros(n_src, dtype=torch.int64, device=src.device)
    tgt_f, wout_f, dout_f = tgt.view(-1), wout.view(-1), dout.view(-1)
    for r0 in range(0, n_tgt, chunk_rows):
        r1 = min(n_tgt, r0 + chunk_rows)
        flat = src[r0:r1].reshape(-1).long()
        key, perm = torch.sort(flat, stable=True)
        rank = (torch.arange(key.numel(), device=key.device)
                - torch.searchsorted(key, key, side="left"))
        dst = key * k_out + cursor[key] + rank
        tgt_f[dst] = (r0 + perm // k).to(torch.int32)
        wout_f[dst] = w[r0:r1].reshape(-1)[perm]
        dout_f[dst] = d[r0:r1].reshape(-1)[perm]
        cursor += torch.bincount(flat, minlength=n_src)


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

    alive = torch.arange(n_pad)[None, :] < torch.as_tensor(sizes_np)[:, None]
    rate = torch.where(
        alive, torch.as_tensor(spec.area_rates(), dtype=torch.float32)[:, None], 0.0)

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
        alive=alive.to(dev),
        rate_hz=rate.to(dev),
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
