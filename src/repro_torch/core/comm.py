"""Spike-exchange collectives over a :class:`~repro_torch.core.mesh.ProcessMesh`.

Port of ``repro.core.comm``. The paper's separate pathways (§4.1.2) map onto
the mesh's axes:

* the **local pathway** runs every cycle over the subgroup axis only, the
  ranks that share an area (``gather_area``);
* the **global pathway** runs every D-th cycle and carries the window's
  ``[D, ...]`` block over all ranks (``gather_global``); the conventional
  schedule instead gathers every cycle's spikes over all ranks
  (``gather_full``).

Spikes travel as one bit per neuron per cycle on the dense wire
(``pack_bits``, bit for bit the JAX package's format). The JAX functions run
inside ``shard_map`` and name mesh axes; these take the mesh and its axis
names and call ``torch.distributed`` on the axis's process group. Every rank
must call the same collectives in the same order.

**The wire** is chosen from each group's backend:

* ``gloo`` (host memory, the only backend when ranks share one card): a
  device tensor is copied into a pinned host buffer that this module owns,
  gathered there, and copied back. The copy to the host waits for the
  device, so every staged collective is a synchronisation point.
* ``nccl`` (one card per rank): device tensors go as they are.

:func:`ppermute` (the routed exchange's rotation rounds) has no collective
in ``torch.distributed``: it is built from point-to-point sends and
receives on the world group, all posted in one ``batch_isend_irecv``, so
no blocking send waits on a partner that is itself sending.

``calls`` counts collectives by ``(op, axes)`` and, while ``times`` is a
list, each collective appends ``(op, axes, seconds)`` with the host time it
spent inside ``torch.distributed`` (waiting for the other ranks included).
``received`` counts, by the same keys, the bytes this rank took in from the
other ranks: ``n - 1`` times the payload of a gather or a reduction over
``n`` ranks, and one payload from each partner of a ``ppermute``. Summed
over the ranks, the ``all_gather`` and ``ppermute`` bytes of a window are
what the exchange's wire accounting (``exchange.dense_wire_bytes``,
``routed_wire_bytes``) predicts for its static packets. Whole-state gathers
(counted as ``"gather_grid"``, the engine's ``gather_state`` / ``gather_block``)
are kept apart from the exchange's own gathers.

**Priced, not run.** Over a :class:`~repro_torch.core.mesh.MeshLayout`
(the dry run's rank-free mesh) the tensors are on the ``meta`` device:
:func:`all_gather`, :func:`all_reduce`, :func:`sum_in_order`,
:func:`reduce_scatter_in_order`, :func:`broadcast` and :func:`ppermute`
then call no process group, count ``calls`` and ``received`` by the same
rules as on a world, and return meta tensors of the shapes a world would
give; :func:`count_max` returns its reduced count as a meta tensor, which
has no value: the ladder it sizes takes its top rung. So a dry run of one
rank's step, serving call or simulation window on meta tensors counts
what that rank would take in.

**Sharded parameters** (FSDP, :mod:`~repro_torch.models.fsdp`) are
gathered one unit at a time (``all_gather``); the gradients of the split
leaves are summed over the batch axes by :func:`reduce_scatter_in_order`
each microbatch, each rank taking in only the blocks it owns (a leaf a
rank holds whole, by :func:`sum_in_order` once a step), and the clip's
norm gathers each split leaf's f32 shard once (``"norm_gather"``).
:data:`gathered` holds the parameter bytes the gather point holds
gathered now and their peak since :func:`reset_stats`.

**Collectives that carry gradients** split a training step's compute
over an axis (Megatron's operators; :class:`~repro_torch.models.layers.TPSplit`
calls them). ``torch.distributed`` calls carry no autograd, so each is a
``torch.autograd.Function`` whose backward runs the collective its
forward's transpose needs, counted under its own name:

* :func:`enter_split`: the identity; the backward sums the gradient over
  the axis (``"split_grad_sum"``): a replicated input to rank-specific work;
* :func:`sum_partials`: the sum of the ranks' partial results
  (``"partial_sum"``); the backward is the identity;
* :func:`gather_split`: a tiled gather along a dimension
  (``"split_gather"``); the backward takes the rank's own slice;
* :func:`own_slice`: the rank's own slice along a dimension; the backward
  gathers (``"slice_grad_gather"``);
* :func:`max_over`: a max over the axis that carries no gradient
  (``"split_max"``);
* :func:`~repro_torch.train.pipeline.pipeline_apply` (GPipe over ``pipe``):
  its backward sends each step's input cotangent to the stage before by a
  :func:`ppermute` of the reverse pairs (``"ppermute_grad"``), and
  :func:`broadcast` s the microbatches' gradient from stage 0
  (``"broadcast_grad"``); its output's broadcast transposes to the last
  stage's own cotangent, with no collective.

Every sum adds the ranks' values in f32 in rank order onto an f32 zero, as
:func:`sum_in_order` does, and casts to the input's dtype: every rank of
the axis gets bitwise the same value, so work done alike on every rank
(norms, the router) stays bitwise alike. An extent of 1 is the identity
with no collective. On meta tensors (a dry run over a
:class:`~repro_torch.core.mesh.MeshLayout`) they are priced as the other
collectives are, the backward's too.

Under ``nccl`` every rank of the world must take part in the first
point-to-point call, which sets up the communicator, while a ``ppermute``
round leaves out the ranks with no partner at its offset: call
:func:`warm_point_to_point` once on every rank before the first round.
"""

from __future__ import annotations

import collections
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "pack_bits",
    "unpack_bits",
    "all_gather",
    "gather_blocks",
    "all_reduce",
    "sum_in_order",
    "reduce_scatter_in_order",
    "broadcast",
    "enter_split",
    "sum_partials",
    "gather_split",
    "own_slice",
    "max_over",
    "gather_area",
    "gather_global",
    "gather_full",
    "ppermute",
    "wire_received",
    "warm_point_to_point",
    "exchange_bytes",
    "count_max",
    "gather_counts",
    "count_wire_bytes",
    "calls",
    "received",
    "times",
    "gathered",
    "gathered_add",
    "reset_stats",
]

calls: collections.Counter = collections.Counter()
received: collections.Counter = collections.Counter()
times: list | None = None
# Bytes of the parameters the FSDP gather point holds gathered on this rank
# now ("live") and their most since the last reset_stats ("peak").
gathered: dict = {"live": 0, "peak": 0}
# Pinned host buffers for the gloo wire, by (role, shape, dtype).
_pinned: dict = {}


def reset_stats(*, timed: bool = False) -> None:
    """Zero ``calls`` and ``received`` and restart ``gathered``'s peak from
    what is alive; start recording ``times`` when ``timed``, else stop."""
    global times
    calls.clear()
    received.clear()
    gathered["peak"] = gathered["live"]
    times = [] if timed else None


def gathered_add(nbytes: int) -> None:
    """``nbytes`` more (or, negative, fewer) gathered parameter bytes alive
    on this rank (:class:`~repro_torch.models.fsdp.FSDP` counts what it
    returns until it is freed)."""
    gathered["live"] += nbytes
    gathered["peak"] = max(gathered["peak"], gathered["live"])


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` 0/1 int8 -> ``[..., ceil(n/8)]`` uint8, bit ``i`` of byte
    ``j`` holding element ``8 j + i`` (the JAX package's wire format)."""
    n = x.shape[-1]
    pad = (-n) % 8
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    b = x.reshape(*x.shape[:-1], (n + pad) // 8, 8).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bits(p: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., n/8]`` uint8 -> ``[..., n]`` int8."""
    shifts = torch.arange(8, dtype=torch.int32, device=p.device)
    bits = (p.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 8)[..., :n].to(torch.int8)


def _key(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` crosses ``group`` through pinned host buffers."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return x.is_cuda
    if backend == "nccl":
        return False
    raise ValueError(f"no wire for process-group backend {backend!r} (gloo or nccl)")


def _buffer(role: str, shape, dtype) -> torch.Tensor:
    key = (role, tuple(shape), dtype)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return buf


def _timed(op: str, axes, nbytes: int, fn):
    calls[(op, axes)] += 1
    received[(op, axes)] += nbytes
    if times is None:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    times.append((op, axes, time.perf_counter() - t0))
    return out


def _gather(x: torch.Tensor, mesh, axes, count_as: str = "all_gather") -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` over the group of ``axes``, in
    row-major order over ``axes``; counted under ``count_as``."""
    axes = _key(axes)
    n = mesh.extent(axes)
    x = x.contiguous()
    nbytes = (n - 1) * x.numel() * x.element_size()
    if x.is_meta:  # priced: no group
        return _timed(count_as, axes, nbytes, lambda: x.new_empty((n, *x.shape)))
    group = mesh.group(axes)
    if _staged(group, x):
        src = _buffer("in", x.shape, x.dtype)
        src.copy_(x)  # waits for the device
        out = _buffer("out", (n, *x.shape), x.dtype)
        _timed(count_as, axes, nbytes,
               lambda: dist.all_gather(list(out.unbind(0)), src, group=group))
        # The next staged collective's copy to the host waits for this copy
        # before anything is written into `out` again.
        return out.to(x.device, non_blocking=True)
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    _timed(count_as, axes, nbytes, lambda: dist.all_gather(list(out.unbind(0)), x, group=group))
    return out


def all_gather(x: torch.Tensor, mesh, axes, *, dim: int,
               count_as: str = "all_gather") -> torch.Tensor:
    """Tiled all_gather: the ranks' ``x`` concatenated along ``dim`` in
    row-major order over ``axes`` (``jax.lax.all_gather(..., tiled=True)``),
    counted under ``count_as``."""
    g = _gather(x, mesh, axes, count_as)
    n = g.shape[0]
    if dim == 0:
        return g.reshape(n * x.shape[0], *x.shape[1:])
    g = torch.movedim(g, 0, dim)
    return g.reshape(*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


def gather_blocks(x: torch.Tensor, mesh, spec: tuple, count_as: str = "all_gather"
                  ) -> torch.Tensor:
    """The whole of what this rank's block ``x`` under ``spec`` (one entry a
    leading dimension) is a block of: an :func:`all_gather` along each
    dimension whose axes have an extent above 1, counted under
    ``count_as``; ``x`` itself where there is none."""
    for d, axes in enumerate(spec):
        if axes is not None and mesh.extent(axes) > 1:
            x = all_gather(x, mesh, axes, dim=d, count_as=count_as)
    return x


def all_reduce(x: torch.Tensor, mesh, axes, *, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the group of ``axes`` (``'sum'`` or ``'max'``); a
    new tensor on ``x``'s device (``jax.lax.psum`` / ``pmax``)."""
    axes = _key(axes)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if x.is_meta:  # priced: no group
        nbytes = (mesh.extent(axes) - 1) * x.numel() * x.element_size()
        return _timed(f"all_reduce_{op}", axes, nbytes, lambda: x.detach().clone())
    group = mesh.group(axes)
    staged = _staged(group, x)
    buf = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
    nbytes = (mesh.extent(axes) - 1) * buf.numel() * buf.element_size()
    _timed(f"all_reduce_{op}", axes, nbytes,
           lambda: dist.all_reduce(buf, op=rop, group=group))
    return buf.to(x.device, non_blocking=True) if staged else buf


def sum_in_order(x: torch.Tensor, mesh, axes, count_as: str = "sum_in_order") -> torch.Tensor:
    """The f32 sum of the ranks' ``x`` over the group of ``axes``, added in
    row-major group order onto an f32 zero: bitwise a sequential f32
    accumulation of the same values, as the one-device trainer sums its
    microbatches' gradients, for any group size (a ring all-reduce adds in
    another order). It crosses as a gather of ``x`` in its own dtype (a
    bf16 gradient in 2 bytes an element), counted under ``("sum_in_order",
    axes)`` (or ``count_as``): ``n - 1`` payloads."""
    parts = _gather(x, mesh, axes, count_as)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for part in parts.unbind(0):
        acc.add_(part.float())
    return acc


def _block_at(x: torch.Tensor, spec: tuple, mesh, coords: dict) -> torch.Tensor:
    """The block of ``x`` under ``spec`` that the rank at ``coords`` owns
    (:meth:`~repro_torch.core.mesh.MeshLayout.shard` at other coordinates)."""
    index = []
    for d, e in enumerate(spec):
        if e is None:
            index.append(slice(None))
            continue
        i = 0
        for ax in _key(e):
            i = i * mesh.shape[ax] + coords[ax]
        size = x.shape[d] // mesh.extent(e)
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)]


def _all_to_all(send: torch.Tensor, mesh, axes: tuple, count_as: str) -> torch.Tensor:
    """``[n, ...]``: block ``j`` of ``send`` goes to group index ``j`` over
    ``axes``, block ``j`` of the result came from it (``n - 1`` blocks in,
    counted under ``count_as``)."""
    n = send.shape[0]
    nbytes = (n - 1) * send[0].numel() * send.element_size()
    if send.is_meta:  # priced: no group
        return _timed(count_as, axes, nbytes, lambda: torch.empty_like(send))
    group = mesh.group(axes)
    if _staged(group, send):
        src = _buffer("a2a_in", send.shape, send.dtype)
        src.copy_(send)  # waits for the device
        out = _buffer("a2a_out", send.shape, send.dtype)
        _timed(count_as, axes, nbytes, lambda: dist.all_to_all_single(out, src, group=group))
        return out.to(send.device, non_blocking=True)
    out = torch.empty_like(send)
    _timed(count_as, axes, nbytes, lambda: dist.all_to_all_single(out, send, group=group))
    return out


def reduce_scatter_in_order(x: torch.Tensor, mesh, axes, spec: tuple,
                            count_as: str = "reduce_scatter_in_order") -> torch.Tensor:
    """This rank's block of the f32 sum of the ranks' ``x`` over the group
    of ``axes``: the block of ``x`` it owns under ``spec`` (whose axes may
    be fewer than ``axes``, or others: each rank owns the block its own
    coordinates give), summed from every rank of the group in row-major
    order onto an f32 zero. Every element is bitwise the one
    :func:`sum_in_order` gives and :meth:`~repro_torch.core.mesh.MeshLayout.shard`
    cuts out, but a rank takes in only ``n - 1`` blocks, not ``n - 1``
    whole payloads: the blocks cross as one all-to-all in ``x``'s dtype,
    counted under ``count_as``. An extent of 1 is this rank's block, with
    no collective."""
    axes = _key(axes)
    n = mesh.extent(axes)
    extents = [mesh.shape[a] for a in axes]
    blocks = []
    for j in range(n):
        coords = dict(mesh.coords)
        coords.update(zip(axes, (int(c) for c in np.unravel_index(j, extents))))
        blocks.append(_block_at(x, spec, mesh, coords))
    if n == 1:
        parts = blocks
    else:
        parts = _all_to_all(torch.stack(blocks), mesh, axes, count_as).unbind(0)
    acc = torch.zeros(blocks[0].shape, dtype=torch.float32, device=x.device)
    for part in parts:
        acc.add_(part)  # in f32: the part's dtype is promoted exactly
    return acc


def broadcast(x: torch.Tensor, mesh, axes, *, src: int,
              count_as: str = "broadcast") -> torch.Tensor:
    """The ``x`` of the rank at group index ``src`` over ``axes`` (row-major)
    on every rank of the group: a new tensor on ``x``'s device, bitwise the
    source's (where the reference takes a ``psum`` of the source's value
    and zeros elsewhere); counted under ``count_as``."""
    axes = _key(axes)
    if x.is_meta:  # priced: no group
        nbytes = 0 if _group_index(mesh, axes) == src else x.numel() * x.element_size()
        return _timed(count_as, axes, nbytes, lambda: x.detach().clone())
    group = mesh.group(axes)
    staged = _staged(group, x)
    buf = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
    nbytes = 0 if _group_index(mesh, axes) == src else buf.numel() * buf.element_size()
    _timed(count_as, axes, nbytes,
           lambda: dist.broadcast(buf, src=_rank_at(mesh, axes, src), group=group))
    return buf.to(x.device, non_blocking=True) if staged else buf


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_in_order(g, ctx.mesh, ctx.axes, "split_grad_sum").to(g.dtype), None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_in_order(x, mesh, axes, "partial_sum").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.size = mesh, axes, dim, x.shape[dim]
        return all_gather(x, mesh, axes, dim=dim, count_as="split_gather")

    @staticmethod
    def backward(ctx, g):
        i = _group_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


class _OwnSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        n = mesh.extent(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of shape {tuple(x.shape)} does not divide over "
                             f"{axes} (extent {n})")
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        size = x.shape[dim] // n
        return x.narrow(dim, _group_index(mesh, axes) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.mesh, ctx.axes, dim=ctx.dim, count_as="slice_grad_gather"),
                None, None, None)


def _split_axes(mesh, axes):
    """``axes`` as a key, or None where their extent is 1 (no collective)."""
    axes = _key(axes)
    return axes if mesh.extent(axes) > 1 else None


def enter_split(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` (the same on every rank of ``axes``) as the input of work that
    differs by rank: the identity forward; the backward sums the ranks'
    partial gradients in f32, in rank order (``"split_grad_sum"``)."""
    axes = _split_axes(mesh, axes)
    return x if axes is None else _EnterSplit.apply(x, mesh, axes)


def sum_partials(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axes``, in f32 in rank
    order, in ``x``'s dtype (``"partial_sum"``); the gradient passes
    through unchanged."""
    axes = _split_axes(mesh, axes)
    return x if axes is None else _SumPartials.apply(x, mesh, axes)


def gather_split(x: torch.Tensor, mesh, axes, *, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (``"split_gather"``), for
    work done alike on every rank; the backward takes this rank's slice
    of the gradient."""
    axes = _split_axes(mesh, axes)
    return x if axes is None else _GatherSplit.apply(x, mesh, axes, dim % x.dim())


def own_slice(x: torch.Tensor, mesh, axes, *, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (the same on every rank) along ``dim``;
    the backward gathers the ranks' gradients (``"slice_grad_gather"``).
    A dimension the extent does not divide raises ``ValueError``."""
    axes = _split_axes(mesh, axes)
    return x if axes is None else _OwnSlice.apply(x, mesh, axes, dim % x.dim())


@torch.no_grad()
def max_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of the ranks' ``x`` over ``axes``, with no
    gradient (``"split_max"``)."""
    axes = _split_axes(mesh, axes)
    if axes is None:
        return x.detach()
    parts = _gather(x.detach(), mesh, axes, "split_max")
    return parts.amax(dim=0)


def gather_area(
    spikes_local: torch.Tensor, mesh, *, subgroup_axis: str = "model", packed: bool = True,
) -> torch.Tensor:
    """Local pathway: ``[A_loc, n_loc]`` int8, this rank's shard of its
    areas -> ``[A_loc, n_pad]``, the areas' whole spike vectors, gathered
    over the subgroup only (bit-packed on the wire)."""
    if not packed:
        return all_gather(spikes_local, mesh, subgroup_axis, dim=1)
    n_loc = spikes_local.shape[-1]
    wire = _gather(pack_bits(spikes_local), mesh, subgroup_axis)  # [n_sh, A_loc, per]
    out = unpack_bits(wire, n_loc)                               # [n_sh, A_loc, n_loc]
    return torch.movedim(out, 0, 1).reshape(spikes_local.shape[0], -1)


def gather_global(
    block_local: torch.Tensor, mesh, *, area_axes: Sequence[str] = ("pod", "data"),
    subgroup_axis: str = "model", packed: bool = True,
) -> torch.Tensor:
    """Global pathway: ``[D, A_loc, n_loc]`` int8 -> ``[D, A, n_pad]`` in
    global area order. First the subgroup completes each area, then the
    area axes concatenate areas, innermost axis first, so that the global
    area index is row-major over the area axes (bit-packed on the wire)."""
    if not packed:
        block = all_gather(block_local, mesh, subgroup_axis, dim=2)
        for ax in reversed(tuple(area_axes)):
            block = all_gather(block, mesh, ax, dim=1)
        return block
    n_loc = block_local.shape[-1]
    per = (n_loc + 7) // 8
    wire = all_gather(pack_bits(block_local), mesh, subgroup_axis, dim=2)
    for ax in reversed(tuple(area_axes)):
        wire = all_gather(wire, mesh, ax, dim=1)
    d, a_tot, _ = wire.shape
    out = unpack_bits(wire.reshape(d, a_tot, -1, per), n_loc)
    return out.reshape(d, a_tot, -1)


def gather_full(
    spikes_local: torch.Tensor, mesh, axes: Sequence[str], *, packed: bool = True,
) -> torch.Tensor:
    """Conventional pathway: ``[A, n_loc]`` -> ``[A, n_pad]``, one gather of
    the cycle's spike vector over ``axes`` (all of them), bit-packed."""
    if not packed:
        return all_gather(spikes_local, mesh, tuple(axes), dim=1)
    n_loc = spikes_local.shape[-1]
    wire = _gather(pack_bits(spikes_local), mesh, tuple(axes))  # [n_sh, A, per]
    out = unpack_bits(wire, n_loc)
    return torch.movedim(out, 0, 1).reshape(spikes_local.shape[0], -1)


def _group_index(mesh, axes: tuple) -> int:
    """This rank's index in the group over ``axes`` (row-major)."""
    g = 0
    for ax in axes:
        g = g * mesh.shape[ax] + mesh.axis_index(ax)
    return g


def _rank_at(mesh, axes: tuple, h: int) -> int:
    """The global rank at group index ``h`` over ``axes`` (row-major) that
    shares this rank's coordinates off ``axes``."""
    coords = dict(mesh.coords)
    coords.update(zip(axes, (int(c) for c in np.unravel_index(h, [mesh.shape[a] for a in axes]))))
    return int(np.ravel_multi_index([coords[a] for a in mesh.axis_names],
                                    [mesh.shape[a] for a in mesh.axis_names]))


def ppermute(x: torch.Tensor, mesh, axes, pairs, *, fill=0,
             count_as: str = "ppermute") -> torch.Tensor:
    """``jax.lax.ppermute`` over ``axes``: for every ``(src, dst)`` of
    ``pairs`` (group indices, row-major over ``axes``), the rank of group
    ``src`` sends its ``x`` to the rank of group ``dst`` at its own
    coordinates off ``axes``. Returns what arrived; a rank that no pair
    sends to gets ``x``'s shape filled with ``fill`` (``jax.lax.ppermute``
    gives zeros there). Counted under ``count_as``, which also names the
    pinned host buffers it stages through.

    The sends and receives go point to point on the world group, with
    global ranks, all posted in one ``batch_isend_irecv``; over gloo a
    device tensor is staged through pinned host buffers. Meta tensors are
    priced (no group; see the module docstring)."""
    axes = _key(axes)
    g = _group_index(mesh, axes)
    sends = [dst for src, dst in pairs if src == g]
    recvs = [src for src, dst in pairs if dst == g]
    if len(recvs) > 1:
        raise ValueError(f"group {g} receives from {recvs}: ppermute pairs need one source "
                         f"a destination")
    x = x.contiguous()
    inbound = sum(1 for s in recvs if s != g)
    if x.is_meta:  # priced: no group
        return _timed(count_as, axes, inbound * x.numel() * x.element_size(),
                      lambda: torch.empty_like(x))
    staged = _staged(dist.group.WORLD, x)
    if staged:
        src = _buffer(f"{count_as}_in", x.shape, x.dtype)
        src.copy_(x)  # waits for the device
        out = _buffer(f"{count_as}_out", x.shape, x.dtype)
    else:
        src, out = x, torch.empty_like(x)
    if recvs and recvs[0] == g:
        out.copy_(src)
    else:
        out.fill_(fill)
    ops = [dist.P2POp(dist.isend, src, _rank_at(mesh, axes, dst)) for dst in sends if dst != g]
    ops += [dist.P2POp(dist.irecv, out, _rank_at(mesh, axes, s)) for s in recvs if s != g]

    def run():
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()

    _timed(count_as, axes, inbound * x.numel() * x.element_size(), run)
    return out.to(x.device, non_blocking=True) if staged else out


def wire_received() -> int:
    """This rank's ``received`` bytes in the exchange's own collectives
    (``all_gather`` and ``ppermute``) since the last :func:`reset_stats`."""
    return sum(n for (op, _), n in received.items() if op in ("all_gather", "ppermute"))


def warm_point_to_point(mesh) -> None:
    """Under ``nccl``, one barrier of the whole world, so that the world's
    communicator exists before the first ``ppermute`` round that leaves a
    rank out (a no-op under gloo)."""
    if mesh.device.type != "meta" and dist.get_backend(dist.group.WORLD) == "nccl":
        dist.barrier(device_ids=[mesh.device.index])


def exchange_bytes(shape_local: tuple[int, ...], n_gather_devices: int,
                   dtype_bytes: int = 1) -> int:
    """Bytes a rank receives in one tiled all_gather (for the cost model)."""
    n_elems = 1
    for s in shape_local:
        n_elems *= s
    return n_elems * (n_gather_devices - 1) * dtype_bytes


def count_max(count, mesh, axes) -> int | torch.Tensor:
    """Phase 1 of the adaptive two-phase exchange: the maximum of every
    rank's count over ``axes``, as a host int. Every rank gets the same
    number, so every rank picks the same ladder rung and ships packets of
    one size. Reading a device count waits for the device: the protocol's
    one synchronisation. A ``meta`` count (a dry run) is priced as the
    same reduction and comes back as a 0-d meta tensor: it has no value to
    read, and the ladder functions take their top rung for it (the hard
    cap, every neuron firing)."""
    if isinstance(count, torch.Tensor) and count.is_meta:
        return all_reduce(count.to(torch.int64).reshape(1), mesh, axes, op="max")[0]
    group = mesh.group(_key(axes))
    if dist.get_backend(group) == "nccl":
        x = torch.as_tensor(count, dtype=torch.int64, device=mesh.device).reshape(1)
    else:
        x = torch.tensor([int(count)], dtype=torch.int64)
    return int(all_reduce(x, mesh, axes, op="max")[0])


def gather_counts(
    counts_local: torch.Tensor, mesh, *, area_axes: Sequence[str] = ("pod", "data"),
    subgroup_axis: str = "model",
) -> torch.Tensor:
    """The global ``[D, A]`` per-area count table from each rank's partial
    ``[D, A_loc]`` int32 counts: summed over the subgroup, then gathered
    over the area axes innermost first (the order of :func:`gather_global`)."""
    c = all_reduce(counts_local, mesh, subgroup_axis, op="sum")
    for ax in reversed(tuple(area_axes)):
        c = all_gather(c, mesh, ax, dim=1)
    return c


def count_wire_bytes(n_words: int, n_devices: int) -> int:
    """Mesh-total bytes of one phase-1 count collective: ``n_words`` int32
    words received by each of ``n_devices`` ranks."""
    return n_devices * n_words * 4
