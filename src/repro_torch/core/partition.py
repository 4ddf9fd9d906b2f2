"""Workload placement: round-robin vs structure-aware (+ elastic resharding).

Port of ``repro.core.partition``, pure numpy like the original and a copy of
it rather than an import (the port imports nothing of the JAX package).

The paper contrasts two placements (Fig. 2):

* **round-robin** (conventional): neuron ``gid`` lives on process
  ``gid % M`` -- perfect load balance, zero structure. Any pair of processes
  may host neurons separated by the overall minimum delay ``d_min``, so global
  communication is required every ``d_min``.

* **structure-aware**: area ``a`` maps onto one process (or, as proposed in
  the paper's Discussion and implemented here, onto a *subgroup* of devices --
  the ``model`` mesh axis). Heterogeneous areas are padded with frozen "ghost
  neurons" to the largest area size so the placement machinery stays uniform
  (§4.1.1). Inter-process delays are then >= ``d_min_inter``, enabling the
  D-cycle communication interval.

This module is pure metadata -- numpy only; engines and cost models consume it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.areas import MultiAreaSpec

__all__ = [
    "RoundRobinPlacement",
    "StructureAwarePlacement",
    "round_robin_placement",
    "structure_aware_placement",
    "elastic_reshard_plan",
    "placement_from_sizes",
    "reshard_area_order",
    "reshard_moves",
    "shard_pathway_rows",
]


def shard_pathway_rows(
    mode: str, shard: int, n_shards: int, n_areas: int, n_pad: int,
    *, subgroup: int = 1, lane: int = 0,
) -> np.ndarray:
    """Global row ids of the targets shard ``shard`` (lane ``lane``) owns.

    The shard -> pathway-row-range derivation shared by the inbound
    inter-table cut (``connectivity.shard_inter_tables``) and the host-free
    sharded build (``connectivity.build_shard_tables``): a shard's table is
    exactly the inversion of these rows' incoming draws. Rows are returned
    ascending (area-major), matching how the host path slices the global
    tensors -- which is what makes the per-shard inversion bitwise-equal.
    The ranks' cut of the neuron grid is the same (``dist_engine._cut``).

    ``'group'`` -- the structure-aware placement: shards own ``A / S``
    consecutive areas (row-major over the mesh's area axes, matching
    ``dist_engine`` placement and ``ProcessMesh`` rank order). With
    ``subgroup > 1``, lane ``lane`` of the shard additionally owns only its
    ``n_pad / subgroup`` neuron window of each owned area (the mesh's
    last-axis window split).
    ``'window'`` -- the conventional round-robin placement: shards own a
    ``n_pad / S`` neuron window of *every* area (the split over all mesh
    axes).
    """
    if mode == "group":
        a_loc = n_areas // n_shards
        n_loc = n_pad // subgroup
        areas = np.arange(shard * a_loc, (shard + 1) * a_loc, dtype=np.int64)
        win = np.arange(lane * n_loc, (lane + 1) * n_loc, dtype=np.int64)
        return (areas[:, None] * n_pad + win[None, :]).reshape(-1)
    if mode == "window":
        n_loc = n_pad // n_shards
        win = np.arange(shard * n_loc, (shard + 1) * n_loc, dtype=np.int64)
        return (np.arange(n_areas, dtype=np.int64)[:, None] * n_pad
                + win[None, :]).reshape(-1)
    raise ValueError(f"unknown inter_shard_mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class RoundRobinPlacement:
    """Conventional placement: neuron gid -> process gid % M."""

    n_total: int
    n_procs: int

    def neurons_on(self, proc: int) -> int:
        return (self.n_total - proc + self.n_procs - 1) // self.n_procs

    def proc_of(self, gids: np.ndarray) -> np.ndarray:
        return gids % self.n_procs

    @property
    def max_neurons_per_proc(self) -> int:
        return (self.n_total + self.n_procs - 1) // self.n_procs


@dataclasses.dataclass(frozen=True)
class StructureAwarePlacement:
    """Area-aligned placement over a (groups x group_size) device grid.

    ``area_of_group[g]`` lists the areas hosted by device group ``g`` (each
    group is the paper's MPI process / MPI_Group); ``n_pad`` is the padded
    per-area size; ghost counts quantify the padding overhead.
    """

    n_groups: int
    group_size: int  # devices per group ('model' axis extent)
    areas_per_group: int
    n_pad: int
    area_sizes: tuple[int, ...]

    @property
    def n_areas(self) -> int:
        return len(self.area_sizes)

    def areas_of_group(self, g: int) -> tuple[int, ...]:
        lo = g * self.areas_per_group
        return tuple(range(lo, lo + self.areas_per_group))

    def group_of_area(self, a: int) -> int:
        return a // self.areas_per_group

    @property
    def ghost_count(self) -> int:
        return sum(self.n_pad - s for s in self.area_sizes)

    @property
    def ghost_fraction(self) -> float:
        return self.ghost_count / (self.n_pad * self.n_areas)

    def neurons_on_group(self, g: int) -> int:
        return sum(self.area_sizes[a] for a in self.areas_of_group(g))

    def load_imbalance(self) -> float:
        """max/mean live-neuron load across groups (1.0 = perfectly balanced).

        This is the quantity that drives the elevated synchronization time for
        heterogeneous models in Fig. 8a / Fig. 9.
        """
        loads = np.asarray(
            [self.neurons_on_group(g) for g in range(self.n_groups)], dtype=float
        )
        return float(loads.max() / loads.mean())


def round_robin_placement(spec: MultiAreaSpec, n_procs: int) -> RoundRobinPlacement:
    return RoundRobinPlacement(n_total=spec.n_total, n_procs=n_procs)


def structure_aware_placement(
    spec: MultiAreaSpec,
    n_groups: int,
    group_size: int = 1,
    *,
    size_multiple: int = 1,
) -> StructureAwarePlacement:
    """Map areas onto ``n_groups`` device groups of ``group_size`` devices.

    Requires ``n_areas % n_groups == 0`` (areas per group constant); the padded
    area size must divide evenly by ``group_size`` so the intra-area ('model')
    sharding is uniform.
    """
    A = spec.n_areas
    if A % n_groups != 0:
        raise ValueError(
            f"n_areas={A} must be divisible by n_groups={n_groups}; "
            "pad the model with empty areas or choose a different mesh"
        )
    n_pad = spec.padded_area_size(max(size_multiple, group_size))
    if n_pad % group_size != 0:
        raise ValueError("padded area size must divide by group_size")
    return StructureAwarePlacement(
        n_groups=n_groups,
        group_size=group_size,
        areas_per_group=A // n_groups,
        n_pad=n_pad,
        area_sizes=tuple(int(a.n_neurons) for a in spec.areas),
    )


def elastic_reshard_plan(
    old: StructureAwarePlacement, new_n_groups: int
) -> dict[int, tuple[int, int]]:
    """Plan an elastic re-mesh: for every area, (old_group, new_group).

    Used by checkpoint restore when the data-parallel extent changes (node
    failure / elastic scale-up): state arrays are keyed by area, so moving an
    area is a pure data movement with no renumbering.
    """
    if old.n_areas % new_n_groups != 0:
        raise ValueError(
            f"cannot rebalance {old.n_areas} areas onto {new_n_groups} groups"
        )
    per = old.n_areas // new_n_groups
    plan: dict[int, tuple[int, int]] = {}
    for a in range(old.n_areas):
        plan[a] = (old.group_of_area(a), a // per)
    return plan


def placement_from_sizes(
    area_sizes: tuple[int, ...] | list[int],
    n_groups: int,
    *,
    n_pad: int,
    group_size: int = 1,
) -> StructureAwarePlacement:
    """A placement from already-built network metadata (no MultiAreaSpec).

    Checkpoint resume works from a manifest + an instantiated ``Network``
    (area sizes = live-neuron counts, ``n_pad`` already fixed), not from the
    original spec; this constructor lets the resume path build the *old*
    placement recorded in the manifest and plan the elastic re-mesh.
    """
    n_areas = len(area_sizes)
    if n_areas % n_groups != 0:
        raise ValueError(
            f"n_areas={n_areas} not divisible by n_groups={n_groups}")
    return StructureAwarePlacement(
        n_groups=n_groups,
        group_size=group_size,
        areas_per_group=n_areas // n_groups,
        n_pad=n_pad,
        area_sizes=tuple(int(s) for s in area_sizes),
    )


def reshard_area_order(plan: dict[int, tuple[int, int]]) -> np.ndarray:
    """Global area order implied by a reshard plan (new-group-major).

    The gather/re-scatter step of elastic resume: per-area state rows are
    re-laid-out so that each *new* group's areas are contiguous (ties broken
    by area id, matching ``StructureAwarePlacement.areas_of_group``). For the
    contiguous plans :func:`elastic_reshard_plan` emits this is the identity
    permutation -- asserted by the resume tests, since any non-identity
    order here would have to be applied to the inter-table shard cut too.
    """
    areas = np.arange(len(plan))
    new_groups = np.asarray([plan[int(a)][1] for a in areas])
    return areas[np.argsort(new_groups, kind="stable")]


def reshard_moves(plan: dict[int, tuple[int, int]]) -> int:
    """How many areas change device group under the plan.

    Group ids are renumbered when the group count changes, so "moved" means
    the area's *peer set* changed: the set of areas co-hosted with it differs
    between the old and new placement. This is the data-movement count an
    elastic restart actually pays (areas whose whole group maps 1:1 onto a
    new group need no cross-device traffic).
    """
    old_peers: dict[int, list[int]] = {}
    new_peers: dict[int, list[int]] = {}
    for a, (og, ng) in plan.items():
        old_peers.setdefault(og, []).append(a)
        new_peers.setdefault(ng, []).append(a)
    moved = 0
    for a, (og, ng) in plan.items():
        if old_peers[og] != new_peers[ng]:
            moved += 1
    return moved
