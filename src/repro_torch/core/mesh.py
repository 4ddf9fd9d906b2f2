"""A mesh of processes: the counterpart of a ``jax.sharding.Mesh``.

The JAX package runs its distributed engine under ``shard_map`` over a device
mesh such as ``(data, model)`` or ``(pod, data, model)``. The port runs one
``torch.distributed`` process per mesh position instead: rank ``r`` sits at
the row-major coordinates of the mesh shape, the order ``jax.make_mesh``
gives, so the last axis (the intra-area subgroup) varies fastest.

:class:`ProcessMesh` wraps an initialised default process group. It makes
one process group per subset of the mesh's axes (the ranks that differ
only along those axes: the spike exchange takes single axes, the trainer
``("pod", "data")`` or every axis but ``pod``) and uses the default group
for collectives over all axes. Every rank creates every group, in one
fixed order, once, at construction: ``dist.new_group`` is collective over
the whole world.

The port never starts processes itself: the caller (a launcher, a test, the
smoke script) spawns the ranks and calls ``init_process_group`` with the
address, world size and rank.

:class:`MeshLayout` is the same positions with no ranks behind them (one
rank's coordinates, its tensors on the ``meta`` device): the dry run cuts
shapes by it, and :mod:`~repro_torch.core.comm` prices a collective over
it instead of running one.
"""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["MeshLayout", "ProcessMesh"]


class MeshLayout:
    """A mesh's positions with no process behind them: ``extents`` over
    ``axis_names``, seen from rank ``rank`` (row-major coordinates, as
    :class:`ProcessMesh` places ranks). ``shape``, ``size``, ``coords``,
    :meth:`axis_index`, :meth:`extent`, :meth:`block` and :meth:`shard`
    are a process mesh's; ``device`` is ``meta`` (shapes only) unless
    given, and :meth:`group` raises: a collective over a layout is priced
    on meta tensors (:mod:`~repro_torch.core.comm`), never run."""

    def __init__(self, extents, axis_names, rank: int = 0, *, device="meta"):
        extents = tuple(int(s) for s in extents)
        axis_names = tuple(axis_names)
        if len(extents) != len(axis_names) or not extents:
            raise ValueError(f"mesh shape {extents} and axis names {axis_names} must pair up")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.extents = extents
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, extents))
        self.size = math.prod(extents)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not a position of the mesh {self.shape}")
        self.rank = int(rank)
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, extents))))
        self.device = torch.device(device)

    def group(self, axes):
        raise RuntimeError(f"a mesh layout has no process groups (over {axes}): collectives "
                           f"over it take meta tensors, which comm prices")

    def axis_index(self, ax: str) -> int:
        """This rank's coordinate along axis ``ax``."""
        return self.coords[ax]

    def extent(self, axes) -> int:
        """Ranks in :meth:`group` over ``axes``."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in key)

    def block(self, axes) -> tuple[int, int]:
        """``(index, extent)`` of this rank's block along a dimension split
        over ``axes`` (a spec entry: None, one axis name or a tuple): the
        index row-major over ``axes``, as ``NamedSharding`` places blocks."""
        if axes is None:
            return 0, 1
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        index = 0
        for ax in key:
            index = index * self.shape[ax] + self.coords[ax]
        return index, self.extent(key)

    def shard(self, x, spec: tuple, name: str = "leaf"):
        """This rank's block of ``x`` (a tensor or an array) under ``spec``
        (one entry per leading dimension: None, an axis name or a tuple of
        names), as a view. A dimension that the extent of its axes does not
        divide raises ``ValueError`` naming ``name``, the dimension and the
        extent."""
        if len(spec) > x.ndim:
            raise ValueError(f"{name}: spec {spec} has more entries than its "
                             f"{x.ndim} dimensions {tuple(x.shape)}")
        index = []
        for d, axes in enumerate(spec):
            i, n = self.block(axes)
            if x.shape[d] % n:
                raise ValueError(f"{name}: dimension {d} of shape {tuple(x.shape)} does not "
                                 f"divide over {axes} (extent {n})")
            size = x.shape[d] // n
            index.append(slice(i * size, (i + 1) * size))
        return x[tuple(index)]

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


class ProcessMesh(MeshLayout):
    """``shape`` (one extent per axis) over ``axis_names``, one rank a position.

    ``mesh.shape`` maps each axis name to its extent (as a JAX mesh does),
    ``mesh.size`` is the number of ranks, ``mesh.axis_index(ax)`` this rank's
    coordinate along ``ax``. ``mesh.group(axes)`` is the process group of the
    ranks that share this rank's coordinates off ``axes`` (one axis name, or
    a tuple of them in the mesh's order); its ranks are in row-major order
    over ``axes``, the order of a tiled ``all_gather``.

    ``device`` is where this rank's tensors live: ``cuda:(local rank %
    device count)`` by default (the local rank is ``$LOCAL_RANK``, else the
    global rank), so several ranks share a card when there are fewer cards
    than ranks. It raises without a GPU, as :func:`resolve_device` does;
    ``device="cpu"`` runs the rank on the host.
    """

    def __init__(self, shape, axis_names, *, device=None):
        shape = tuple(int(s) for s in shape)
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh needs an initialised default process group "
                "(torch.distributed.init_process_group with this rank's address, "
                "world size and rank)")
        size = math.prod(shape)
        if size != dist.get_world_size():
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has {size} positions, "
                             f"the world {dist.get_world_size()} ranks")
        if device is None:
            resolve_device("cuda")
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = f"cuda:{local % torch.cuda.device_count()}"
        super().__init__(shape, axis_names, dist.get_rank(), device=resolve_device(device))
        axis_names = self.axis_names
        grid = np.arange(size).reshape(shape)
        self._groups = {}
        n = len(axis_names)
        for k in range(1, n):
            for dims in itertools.combinations(range(n), k):
                # One group per block of the grid along `dims`; every rank
                # makes them all, in this order, and keeps its own.
                extent = math.prod(shape[d] for d in dims)
                blocks = np.moveaxis(grid, dims, range(n - k, n)).reshape(-1, extent)
                for block in blocks:
                    ranks = [int(r) for r in block]
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[tuple(axis_names[d] for d in dims)] = group
        self._groups[axis_names] = dist.group.WORLD

    def group(self, axes):
        """The process group over ``axes`` (one axis name, or a tuple of
        them in the mesh's order) that holds this rank."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self._groups:
            raise ValueError(f"no process group over {key}: the mesh keeps one over each "
                             f"subset of its axes {self.axis_names}, in that order")
        return self._groups[key]

