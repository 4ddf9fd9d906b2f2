"""Fully sharded parameters on a process mesh, gathered one unit at a time.

The JAX package shards every parameter over its FSDP axes and lets GSPMD
gather each layer's weights inside the ``lax.scan`` body that reads them
(a ``jax.checkpoint`` in every production config, so the backward gathers
them again), with the f32 gradient accumulator sharded like the
parameters (ZeRO-2). :class:`FSDP` is the port's counterpart: the gather
point the model code calls (:func:`unit`, threaded through as the compute
split is) where a *unit* runs: one layer of a stack, or one leaf group
outside the stacks (the embedding, the head, a final norm, a connector).

* **Gather.** :meth:`FSDP.gather` returns a unit (a module or one leaf)
  whose leaves are gathered over every entry of their spec but the compute
  split's (``specs``: the trainer's per-leaf gather specs), as a copy of the
  module holding the gathered tensors. Called inside a layer body, which is
  what ``torch.utils.checkpoint`` wraps, the backward's recompute gathers
  the layer again and the gathered weights are never saved. Outside a
  checkpoint a saved gathered tensor (or a view of one) is saved as a
  handle and gathered again when the backward unpacks it
  (:meth:`FSDP.recording`'s saved-tensor hooks), as PyTorch's FSDP
  reshards after the forward: no unit stays gathered past its use.
* **Reduce.** The gather is a ``torch.autograd.Function``. Its backward
  takes this rank's gradient of the gathered leaf and adds, in f32, the
  slices this rank owns, summed over the batch axes in row-major rank
  order (:func:`~repro_torch.core.comm.reduce_scatter_in_order`), into the
  step's f32 accumulator (:attr:`FSDP.acc`: the rank's shard of each leaf,
  ZeRO-2, made as the backward reaches the leaf). A leaf a rank holds
  whole (no FSDP entry in its spec, or FSDP off) is summed over the
  microbatches where it is and over the batch axes once a step
  (:func:`~repro_torch.core.comm.sum_in_order`), in the same rank order.
  The backward returns no gradient for the shard, so the sum never passes
  through the parameters' dtype. Where nothing is summed (one microbatch,
  a batch extent of 1) the gradient itself is kept, in its dtype, as one
  device keeps it. A leaf gathered more than once in a
  forward (a tied embedding, zamba2's shared block) first sums its uses'
  gradients in their dtype, as autograd sums a leaf's, and is reduced
  once.
* **Measure.** Every tensor the gather point returns is counted in
  :data:`~repro_torch.core.comm.gathered` while it is alive (its bytes as a
  rank computes on them: the model shard, whole over the FSDP axes), and
  the peak since the last :func:`~repro_torch.core.comm.reset_stats` is
  what the dry run prices as a rank's ``gathered`` bytes. Real and meta
  tensors alike.

A leaf whose spec has no FSDP entry passes through (a view of the shard)
and is counted all the same: a unit is what a rank holds whole while the
unit runs. Serving calls gather under ``torch.no_grad()``: no autograd, no
accumulator.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import weakref

import torch
from torch import nn

from repro_torch.core import comm
from repro_torch.optim.tree import named_leaves

__all__ = ["FSDP", "unit"]


def unit(x, fsdp: "FSDP | None"):
    """``x`` (a unit: a module or a leaf) as it computes: gathered by
    ``fsdp``, or ``x`` itself without one (one device)."""
    return x if fsdp is None else fsdp.gather(x)


def _storage(t: torch.Tensor) -> int:
    """A key of ``t``'s storage, shared by its views (meta tensors too)."""
    return t.untyped_storage()._cdata


def _mirror(module: nn.Module, by_id: dict) -> nn.Module:
    """A shallow copy of ``module`` whose parameters are ``by_id[id(p)]``
    (tensors that carry autograd, so they sit in ``_parameters`` as
    plain tensors), its submodules copied alike."""
    c = copy.copy(module)
    c.__dict__["_parameters"] = {k: None if v is None else by_id[id(v)]
                                 for k, v in module._parameters.items()}
    c.__dict__["_modules"] = {k: None if v is None else _mirror(v, by_id)
                              for k, v in module._modules.items()}
    return c


class _Gather(torch.autograd.Function):
    """A unit's shards -> its gathered leaves; the backward reduces their
    gradients into the step's accumulator and returns none."""

    @staticmethod
    def forward(ctx, fsdp, names, *shards):
        ctx.fsdp, ctx.names = fsdp, names
        return tuple(fsdp._gather_leaf(n, x) for n, x in zip(names, shards))

    @staticmethod
    def backward(ctx, *grads):
        ctx.fsdp._reduce(ctx.names, grads)
        return (None, None) + (None,) * len(grads)


class FSDP:
    """The gather point of one call on ``mesh``: the leaves of ``params``
    (this rank's shards, a parameter module) gathered by ``specs`` (leaf
    name -> the spec to gather over, the compute split's entries unsplit).

    Training (``batch_axes`` given, a step of ``micro`` microbatches) also
    fills :attr:`acc`, each shard's gradient summed over the microbatches
    and ``batch_axes`` by the gathers' backward: f32 where anything is
    summed, else the gradient as it came. A leaf split over the FSDP axes
    is reduce-scattered each microbatch; a leaf this rank holds whole (no
    FSDP entry, or FSDP off) is summed over the microbatches where it is
    and over the batch axes once a step (``sum_in_order``), as one rank's
    full gradient costs it nothing more. :meth:`recording` wraps each
    microbatch's forward, :meth:`flush` follows its backward and
    :meth:`finish` the last one's."""

    def __init__(self, mesh, specs: dict, params: nn.Module,
                 batch_axes: tuple[str, ...] | None = None, micro: int = 1):
        self.mesh = mesh
        self.specs = specs
        self.batch_axes = batch_axes
        self.micro = micro
        named = named_leaves(params)
        self.shards = named
        self._names = {id(p): n for n, p in named.items()}
        self.acc: dict = {}
        self._counting = False
        self._uses: collections.Counter = collections.Counter()
        self._pending: dict = {}
        self._live: dict = {}  # storage key -> [name, shard, gathered?, offset, refs]

    # -- gather ---------------------------------------------------------------

    def gather(self, x):
        """``x`` (a module of shards, or one shard leaf) gathered: a copy
        of the module holding the gathered leaves, or the gathered leaf."""
        if isinstance(x, nn.Module):
            leaves = list(x.parameters())
            outs = self._apply(leaves)
            return _mirror(x, {id(p): o for p, o in zip(leaves, outs)})
        return self._apply([x])[0]

    def _apply(self, leaves: list) -> tuple:
        names = tuple(self._names[id(p)] for p in leaves)
        if torch.is_grad_enabled() and any(p.requires_grad for p in leaves):
            if self._counting:  # a use in the forward (not the backward's recompute)
                self._uses.update(names)
            outs = _Gather.apply(self, names, *leaves)
        else:
            outs = tuple(self._gather_leaf(n, x) for n, x in zip(names, leaves))
        for n, x, out in zip(names, leaves, outs):
            self._track(n, x, out)
        return outs

    def _gather_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` from this rank's shard ``x``: an all-gather along
        each dimension its spec splits (counted as ``all_gather``), or a
        view of ``x`` where it splits none."""
        out = comm.gather_blocks(x, self.mesh, self.specs[name])
        return x.view_as(x) if out is x else out

    def _track(self, name: str, shard: torch.Tensor, out: torch.Tensor) -> None:
        """Count ``out`` among the gathered bytes alive until it is freed,
        and know its storage for the saved-tensor hooks."""
        key = _storage(out)
        rec = self._live.get(key)
        if rec is None:
            rec = self._live[key] = [name, shard, key != _storage(shard), out.storage_offset(), 0]
        rec[4] += 1
        nbytes = out.numel() * out.element_size()
        comm.gathered_add(nbytes)
        weakref.finalize(out, self._untrack, key, nbytes)

    def _untrack(self, key: int, nbytes: int) -> None:
        comm.gathered_add(-nbytes)
        rec = self._live.get(key)
        if rec is not None:
            rec[4] -= 1
            if rec[4] == 0:
                del self._live[key]

    # -- the saved-tensor hooks ----------------------------------------------

    def _pack(self, t: torch.Tensor):
        rec = self._live.get(_storage(t))
        if rec is None:
            return t
        name, shard, gathered, offset, _ = rec
        return name, shard, gathered, tuple(t.shape), t.stride(), t.storage_offset() - offset

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        name, shard, gathered, shape, stride, rel = packed
        base = shard.detach()
        if gathered:
            with torch.no_grad():
                base = self._gather_leaf(name, base)
            nbytes = base.numel() * base.element_size()
            comm.gathered_add(nbytes)
            weakref.finalize(base, comm.gathered_add, -nbytes)
        return base.as_strided(shape, stride, base.storage_offset() + rel)

    @contextlib.contextmanager
    def recording(self):
        """One microbatch's forward: counts each leaf's uses, and saves a
        gathered tensor an op keeps for the backward as a handle that
        gathers it again."""
        self._counting = True
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                yield
        finally:
            self._counting = False

    # -- reduce ---------------------------------------------------------------

    def _reduce(self, names: tuple, grads: tuple) -> None:
        """The backward of one use of ``names``: each leaf's gradient is
        added to its uses' so far; the last use's sum is reduced."""
        for n, g in zip(names, grads):
            self._uses[n] -= 1
            self._pending[n] = g if n not in self._pending else self._pending[n] + g
            if self._uses[n] == 0:
                self._reduce_leaf(n, self._pending.pop(n))

    def _split(self, name: str) -> bool:
        """Whether this rank holds a block of leaf ``name``, not all of it."""
        return any(e is not None and self.mesh.extent(e) > 1 for e in self.specs[name])

    def _reduce_leaf(self, name: str, g: torch.Tensor) -> None:
        """Leaf ``name``'s gradient ``g`` (of the gathered leaf) into the
        accumulator: a split leaf's block summed over the batch axes now (a
        fresh f32 sum onto a zero), else this rank's own block of ``g``,
        added onto an f32 zero where microbatches are summed."""
        acc = self.acc.get(name)
        if self._split(name) and self.mesh.extent(self.batch_axes) > 1:
            part = comm.reduce_scatter_in_order(g, self.mesh, self.batch_axes,
                                                self.specs[name])
        else:
            part = self.mesh.shard(g, self.specs[name], name)
            if acc is None and self.micro > 1:  # an f32 zero to add to, as one device's
                acc = self.acc[name] = torch.zeros(part.shape, dtype=torch.float32,
                                                   device=part.device)
        if acc is None:
            self.acc[name] = part
        else:
            acc.add_(part)

    def finish(self) -> dict:
        """After the last microbatch: each leaf this rank holds whole summed
        over the batch axes (f32, in rank order), a zero for a leaf that
        took no part in the loss; the accumulator by leaf name, in the
        leaves' order."""
        summed = self.micro * self.mesh.extent(self.batch_axes) > 1
        for n, p in self.shards.items():
            if n not in self.acc:
                self.acc[n] = torch.zeros(p.shape, dtype=torch.float32 if summed else p.dtype,
                                          device=p.device)
            elif not self._split(n) and self.mesh.extent(self.batch_axes) > 1:
                self.acc[n] = comm.sum_in_order(self.acc[n], self.mesh, self.batch_axes)
        self.acc = {n: self.acc[n] for n in self.shards}
        return self.acc

    def flush(self) -> None:
        """After a microbatch's backward: reduce a leaf some of whose uses
        took no part in the loss (its other uses' sum, in the order they
        came), and refuse a shard that took a gradient past the gather
        point."""
        for n in list(self._pending):
            self._reduce_leaf(n, self._pending.pop(n))
        self._uses.clear()
        direct = [n for n, p in self.shards.items() if p.grad is not None]
        if direct:
            raise RuntimeError(f"parameter shards used without the gather point: {direct[:4]}")

    def grad_squares(self) -> list[torch.Tensor]:
        """After :meth:`finish`, each leaf's sum of squares of its whole
        accumulated gradient
        (whole over the FSDP axes): the leaf's f32 shard gathered (counted
        as ``norm_gather``), summed and freed before the next leaf's."""
        out = []
        for n, g in self.acc.items():
            g = comm.gather_blocks(g, self.mesh, self.specs[n], "norm_gather")
            out.append(torch.sum(torch.square(g.float())))
            del g
        return out
