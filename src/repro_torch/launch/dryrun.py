"""Dry run of the paper's workload at production scale: priced, not run.

The port of the ``mam-snn`` half of ``repro.launch.dryrun``. The production
MAM (4.2 M neurons, ~25 G synapses) on 16 x 16 or 2 x 16 x 16 ranks does not
fit one card, so each cell is priced from a shape-only network
(:func:`~repro_torch.core.connectivity.network_sds`, tensors on the ``meta``
device) and the production mesh's counts of area groups and lanes; no rank
is made and nothing is allocated. A cell's row holds, per schedule and mesh:

* ``inter_tables``: one rank's inter receive-table bytes and receive work,
  replicated against sharded
  (:func:`~repro_torch.core.exchange.priced_inter_table_report`);
* ``wire_bytes_window``: the mesh-total bytes a window puts on the wire, as
  the engine's ``wire_bytes`` reports them (static, and the adaptive
  two-phase model);
* ``rank_bytes``: one rank's table slices and state, from the meta shapes
  cut as :mod:`repro_torch.core.dist_engine` cuts them, held to the HBM
  budget (``--hbm-gib``; by default the card's own memory).

Beside the cells: the width bounds held against tables instantiated at a
small size (:func:`verify_inter_table_bounds`), the construction model
(:func:`construction_cost_row`) and, with ``--build-rss``, the measured
peaks of the host and the sharded build (:func:`measure_build_rss`).

The reference's XLA readings (``memory_analysis`` temp bytes,
``cost_analysis`` FLOPs, the compiled HLO's collectives) and its TPU
roofline have no counterpart here, and its LM cells wait for the LM
training slice.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mam-snn \\
        --snn-schedule conventional,structure_aware --mesh both --out rows.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --hbm-gib 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any

import numpy as np
import torch

from repro_torch.core import connectivity as connectivity_lib
from repro_torch.core import delivery as delivery_lib
from repro_torch.core import dist_engine as dist_engine_lib
from repro_torch.core import exchange as exchange_lib
from repro_torch.core.areas import mam_benchmark_spec, mam_spec
from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device

__all__ = [
    "SNN_ARCH",
    "MeshLayout",
    "production_layout",
    "enforce_hbm_budget",
    "verify_inter_table_bounds",
    "construction_cost_row",
    "measure_build_rss",
    "dryrun_snn_cell",
    "main",
]

SNN_ARCH = "mam-snn"


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's counts with no ranks behind it: the extents, axis names and
    rank 0's coordinates, which is what ``dist_engine``'s cut reads of a
    :class:`~repro_torch.core.mesh.ProcessMesh`."""

    extents: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int = 0

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        return math.prod(self.extents)

    def axis_index(self, ax: str) -> int:
        coords = np.unravel_index(self.rank, self.extents)
        return int(coords[self.axis_names.index(ax)])


def production_layout(multi_pod: bool) -> MeshLayout:
    """The paper's production meshes: 16 x 16 (data, model) or 2 x 16 x 16
    (pod, data, model); the last axis is the intra-area subgroup."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def modelled_hbm_gib(row: dict) -> float:
    """One rank's priced bytes (GiB): its table slices and its state."""
    return row.get("rank_bytes", {}).get("total", 0) / 2**30


def enforce_hbm_budget(row: dict, budget_gib: float | None) -> dict:
    """Fail-fast HBM gate: one rank's priced bytes must fit ``budget_gib``.

    Flips an OK row to FAIL (which trips the dry run's nonzero exit) when
    they do not; the bound is recorded on the row either way, so the JSON
    stays auditable. ``0`` or ``None`` disables the gate.
    """
    if not budget_gib or row.get("status") != "OK":
        return row
    got = modelled_hbm_gib(row)
    row["hbm_gib_modelled"] = round(got, 3)
    row["hbm_gib_budget"] = budget_gib
    if got > budget_gib:
        row["status"] = (f"FAIL(HBM: modelled {got:.2f} GiB/rank exceeds "
                         f"the --hbm-gib {budget_gib:g} budget)")
    return row


def verify_inter_table_bounds(
    n_shards: int = 2, subgroup: int = 2, seed: int = 12, *, spec=None, device=None,
) -> dict:
    """The instantiated-shard check behind the priced rows.

    The production cells price their tables from ``network_sds`` width
    *bounds*. This builds a real network (by default the reference's 4 x 64
    areas, K 8/12; ``spec`` for another) on ``device``, cuts the same
    inbound slices (``shard_inter_tables(mode='group', subgroup=...)``) and
    the lane intra tables (``slice_intra_tables``), and asserts that the
    bound brackets them: the same lead axes, a bound width >= the
    instantiated one, the same delay dtypes. A violated bound raises: the
    production rows are only as good as these bounds. The cuts are made one
    after the other, each freed before the next, so a network at the
    paper's per-area size fits one card.
    """
    if spec is None:
        spec = mam_benchmark_spec(n_areas=4, n_per_area=64, k_intra=8, k_inter=12)
    row: dict[str, Any] = {
        "arch": SNN_ARCH, "shape": "table_bounds",
        "mesh": f"{n_shards}x{subgroup}", "mode": "verify",
    }
    sds = connectivity_lib.network_sds(spec, size_multiple=8, outgoing=True,
                                       inter_shards=n_shards, subgroup=subgroup)
    net = connectivity_lib.build_network(spec, seed=seed, size_multiple=8,
                                         device=resolve_device(device))
    syn_b = net.bytes_per_synapse()
    cut = connectivity_lib.shard_inter_tables(net, n_shards, mode="group", subgroup=subgroup)
    got_shape, got_dtype = tuple(cut.tgt_inter_in.shape), cut.dout_inter_in.dtype
    del cut
    bound = tuple(sds.tgt_inter_in.shape)
    if bound[:2] != got_shape[:2]:
        raise AssertionError(
            f"SDS shard/lane axes {bound[:2]} != instantiated {got_shape[:2]}")
    if bound[-1] < got_shape[-1]:
        raise AssertionError(
            f"SDS width bound {bound[-1]} < instantiated {got_shape[-1]}: the "
            f"production rows under-price the tables")
    if got_dtype != sds.dout_inter_in.dtype:
        raise AssertionError(
            f"SDS delay dtype {sds.dout_inter_in.dtype} != instantiated {got_dtype}")
    # The same bracket for the lane-cut outgoing intra tables, the other
    # table the production rows price by a width bound. The incoming tables
    # go first: the intra cut reads only the outgoing ones.
    net = connectivity_lib.add_outgoing_tables(net, "intra")
    net = dataclasses.replace(net, **{
        f: getattr(net, f).new_empty((0, 0, getattr(net, f).shape[-1]))
        for f in connectivity_lib._TABLES[2:]})
    cut_i = connectivity_lib.slice_intra_tables(net, subgroup)
    del net
    if tuple(sds.tgt_intra.shape[:2]) != tuple(cut_i.tgt_intra.shape[:2]):
        raise AssertionError(
            f"SDS intra lane axis {tuple(sds.tgt_intra.shape[:2])} != instantiated "
            f"{tuple(cut_i.tgt_intra.shape[:2])}")
    if sds.tgt_intra.shape[-1] < cut_i.tgt_intra.shape[-1]:
        raise AssertionError(
            f"SDS intra width bound {sds.tgt_intra.shape[-1]} < instantiated "
            f"{cut_i.tgt_intra.shape[-1]}: the production rows under-price the "
            f"intra tables")
    if cut_i.dout_intra.dtype != sds.dout_intra.dtype:
        raise AssertionError(
            f"SDS intra delay dtype {sds.dout_intra.dtype} != instantiated "
            f"{cut_i.dout_intra.dtype}")
    # Bytes of ONE rank's slice, modelled against instantiated.
    per_dev_model = int(np.prod(bound[2:])) * syn_b
    per_dev_real = int(np.prod(got_shape[2:])) * syn_b
    row["bytes_per_device_modelled"] = per_dev_model
    row["bytes_per_device_instantiated"] = per_dev_real
    row["bound_slack"] = round(per_dev_model / max(per_dev_real, 1), 3)
    row["intra_bound_slack"] = round(
        sds.tgt_intra.shape[-1] / max(cut_i.tgt_intra.shape[-1], 1), 3)
    row["status"] = "OK"
    return row


def construction_cost_row(scale: float = 1.0, min_reduction: float = 4.0) -> dict:
    """Modelled peak bytes of constructing the production network.

    Prices the host-build path (``build_network(outgoing=True)`` + the two
    shard cuts) against the sharded build (plan pass + one shard's draws,
    temporaries and output slice) with
    :func:`~repro_torch.core.connectivity.construction_cost_model`, at the
    production structure-aware cut (16 area groups x 16-lane subgroups). At
    ``scale=1`` the reduction must clear ``min_reduction`` or the row FAILs.
    """
    row: dict[str, Any] = {
        "arch": SNN_ARCH, "shape": f"mam_x{scale:g}_build",
        "mesh": "16x16", "mode": "construction",
    }
    cm = connectivity_lib.construction_cost_model(
        mam_spec(scale=scale), n_shards=16, subgroup=16, size_multiple=16)
    row["build_bytes_host_modelled"] = cm["build_bytes_host_modelled"]
    row["build_bytes_shard_modelled"] = cm["build_bytes_shard_modelled"]
    row["build_gib_host_modelled"] = round(cm["build_bytes_host_modelled"] / 2**30, 2)
    row["build_gib_shard_modelled"] = round(cm["build_bytes_shard_modelled"] / 2**30, 2)
    row["build_reduction"] = round(cm["reduction"], 1)
    if cm["reduction"] < min_reduction:
        row["status"] = (f"FAIL(construction: modelled reduction {cm['reduction']:.1f}x "
                         f"below the {min_reduction:g}x bar)")
    else:
        row["status"] = "OK"
    return row


# Each child prints its peak last: on the CPU the peak resident set of its
# own process image (VmHWM; ru_maxrss would carry the parent's peak, which
# Linux keeps across exec), on the card torch.cuda.max_memory_allocated.
_PEAK = {
    "cpu": ("def peak():\n"
            "    with open('/proc/self/status') as f:\n"
            "        kib = [ln.split()[1] for ln in f if ln.startswith('VmHWM:')]\n"
            "    return int(kib[0]) * 1024\n"),
    "cuda": ("import torch\n"
             "def peak():\n"
             "    torch.cuda.synchronize()\n"
             "    return torch.cuda.max_memory_allocated()\n"),
}
_MEASURED = {"cpu": "VmHWM", "cuda": "torch.cuda.max_memory_allocated"}


def measure_build_rss(
    n_areas: int = 8, n_per_area: int = 4096,
    k_intra: int = 256, k_inter: int = 256,
    n_shards: int = 4, subgroup: int = 2, seed: int = 12, *, device=None,
) -> dict:
    """Measured peak of the host build against the sharded build, in two
    fresh interpreters on ``device`` (default ``"cuda"``).

    Child A runs the host path: the global build and both shard cuts. Child
    B runs the sharded path: the plan pass, then every (shard, lane)'s
    tables built one at a time (the peak one rank pays). On the CPU each
    reads its process image's peak resident set (``VmHWM``), on the card
    ``torch.cuda.max_memory_allocated``; ``row["measured"]`` says which. The
    sharded peak must come in under the host peak or the row FAILs.
    """
    dev = resolve_device(device)
    row: dict[str, Any] = {
        "arch": SNN_ARCH, "shape": "build_rss",
        "mesh": f"{n_shards}x{subgroup}", "mode": "construction",
        "measured": _MEASURED[dev.type],
    }
    common = _PEAK[dev.type] + (
        "from repro_torch.core.areas import mam_benchmark_spec\n"
        "from repro_torch.core import connectivity as c\n"
        f"spec = mam_benchmark_spec(n_areas={n_areas}, n_per_area={n_per_area}, "
        f"k_intra={k_intra}, k_inter={k_inter})\n"
        f"dev = {dev.type!r}\n")
    host_src = common + (
        f"net = c.build_network(spec, seed={seed}, outgoing='intra', device=dev)\n"
        f"cut = c.shard_inter_tables(net, {n_shards}, mode='group', subgroup={subgroup})\n"
        f"cut = c.slice_intra_tables(cut, {subgroup})\n"
        "print(peak())\n")
    a_loc = n_areas // n_shards
    shard_src = common + (
        f"plan = c.sharded_build_plan(spec, {seed}, {n_shards}, mode='group', "
        f"subgroup={subgroup}, device=dev)\n"
        f"for s in range({n_shards}):\n"
        f"    areas = list(range(s * {a_loc}, (s + 1) * {a_loc}))\n"
        f"    for lane in range({subgroup}):\n"
        f"        t = c.build_shard_tables(spec, {seed}, s, plan=plan, lane=lane, device=dev)\n"
        "        del t\n"
        f"        ti = c.build_lane_intra_tables(spec, {seed}, areas, lane, plan=plan, "
        "device=dev)\n"
        "        del ti\n"
        "print(peak())\n")
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def _peak_bytes(src: str) -> int:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, (src_dir, env.get("PYTHONPATH"))))
        out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                             env=env, check=True)
        return int(out.stdout.strip().splitlines()[-1])

    t0 = time.time()
    host = _peak_bytes(host_src)
    t1 = time.time()
    shard = _peak_bytes(shard_src)
    t2 = time.time()
    row["host_peak_mib"] = round(host / 2**20, 1)
    row["sharded_peak_mib"] = round(shard / 2**20, 1)
    row["peak_reduction"] = round(host / max(shard, 1), 2)
    row["host_build_s"] = round(t1 - t0, 1)
    row["sharded_build_s"] = round(t2 - t1, 1)
    if shard >= host:
        row["status"] = (f"FAIL(build peak: sharded {shard} B >= host {host} B "
                         f"({row['measured']}) -- the host-free build saved nothing)")
    else:
        row["status"] = "OK"
    return row


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _rank_bytes(net, layout: MeshLayout, schedule: str, neuron_model: str) -> dict:
    """One rank's bytes: its cut of ``net``'s tables
    (``dist_engine.shard_network`` on the meta shapes) and of the state
    (neuron leaves, spike counts and ring, each ``[a_loc, n_loc, ...]``)."""
    view = dist_engine_lib.shard_network(net, layout, schedule)
    tables = sum(_nbytes(getattr(view, f.name)) for f in dataclasses.fields(view))
    c = dist_engine_lib._cut(layout, schedule, net.n_areas, net.n_pad)
    per_neuron = 4 * (3 if neuron_model == "lif" else 1) + 4  # neuron leaves + spike_count
    state = c.a_loc * c.n_loc * (per_neuron + 4 * net.ring_len) + 12  # t, overflow, shipped
    return dict(tables=tables, state=state, total=tables + state)


def dryrun_snn_cell(
    schedule: str,
    multi_pod: bool,
    scale: float = 1.0,
    backend: str = "",
    exchange: str = "",
    shard_tables: bool = True,
    subgroup_tables: bool = True,
    adaptive: bool = False,
) -> dict:
    """Price the distributed engine's window at production MAM scale.

    The reference's cell (the same spec, padding, shard counts, subgroup
    and routing per schedule), priced instead of lowered. ``backend`` picks
    the delivery backend (``event`` prices the outgoing tables of
    ``network_sds(outgoing=True)``), ``exchange`` the global pathway
    (``routed`` routes over the spec's all-to-all adjacency), and
    ``shard_tables`` / ``subgroup_tables`` / ``adaptive`` the table layout
    and the two-phase exchange, as in ``EngineConfig``. The row carries
    ``inter_tables`` (receive tables, replicated against sharded),
    ``wire_bytes_window`` (the engine's ``wire_bytes``) and ``rank_bytes``.
    """
    label = "_".join(x for x in (schedule, backend, exchange) if x)
    if not shard_tables:
        label += "_reptables"
    elif not subgroup_tables:
        label += "_nosub"
    if adaptive:
        label += "_adaptive"
    layout = production_layout(multi_pod)
    row: dict[str, Any] = {
        "arch": SNN_ARCH, "shape": f"mam_x{scale:g}_{label}",
        "mesh": "x".join(map(str, layout.extents)), "mode": schedule,
    }
    spec = mam_spec(scale=scale)
    cfg = EngineConfig(neuron_model="lif", schedule=schedule, delivery_backend=backend,
                       exchange=exchange, shard_inter_tables=shard_tables,
                       subgroup_inter_tables=subgroup_tables, adaptive_exchange=adaptive)
    cfg.check(distributed=True)
    sa = schedule == "structure_aware"
    # Pad so both the 16-way subgroup and (conventional) every rank divide.
    mult = 16 if sa else 512
    needs_outgoing = backend == "event" or exchange == "routed"
    gsz = layout.shape["model"]
    n_groups = layout.size // gsz
    n_shards = n_groups if sa else layout.size
    shard_mode = "group" if sa else "window"
    # The lane cut exists only under the structure-aware group cut; the
    # conventional window cut is already per-rank.
    sub = gsz if shard_tables and subgroup_tables and sa else 1
    net = connectivity_lib.network_sds(
        spec, size_multiple=mult, outgoing=needs_outgoing,
        inter_shards=n_shards if needs_outgoing and shard_tables else 0,
        inter_shard_mode=shard_mode, subgroup=sub)
    kw = dict(headroom=cfg.s_max_headroom, floor=cfg.s_max_floor)
    routing = None
    if exchange == "routed":
        # The engine's routing: rounds ordered by the pod tier on two pods.
        area_axes = layout.axis_names[:-1]
        intra_tier = n_groups // layout.shape[area_axes[0]] if len(area_axes) > 1 else None
        routing = exchange_lib.build_routing(
            connectivity_lib.area_adjacency(net, spec), n_groups,
            exp_area_spikes=delivery_lib.expected_area_spikes(net), intra_tier=intra_tier,
            **kw)
    if needs_outgoing and spec.k_inter > 0:
        # Both layouts at the draws' width bounds: the inbound slices at the
        # cell's cut beside the replicated outgoing tables.
        sliced = net if net.tgt_inter_in is not None else connectivity_lib.network_sds(
            spec, size_multiple=mult, outgoing=True, inter_shards=n_shards,
            inter_shard_mode=shard_mode, subgroup=sub)
        rep = net if net.tgt_inter is not None else connectivity_lib.network_sds(
            spec, size_multiple=mult, outgoing=True)
        priced = dataclasses.replace(sliced, tgt_inter=rep.tgt_inter,
                                     wout_inter=rep.wout_inter, dout_inter=rep.dout_inter)
        row["inter_tables"] = exchange_lib.priced_inter_table_report(
            priced, n_groups=n_groups, gsz=gsz, schedule=schedule, routing=routing,
            subgroup=sub, **kw)
    if needs_outgoing and net.tgt_inter_in is not None:
        # The engine drops the incoming inter tables once the inbound
        # slices exist; a rank does not hold both layouts.
        net = dataclasses.replace(net, **{
            f: getattr(net, f).new_empty((0, 0, net.k_inter))
            for f in ("src_inter", "w_inter", "delay_inter")})
    wire_kw = dict(backend=cfg.backend, gsz=gsz, **kw)
    if routing is not None:
        wire = exchange_lib.routed_wire_bytes(net, routing, **wire_kw)
    else:
        wire = exchange_lib.dense_wire_bytes(net, schedule=schedule, n_groups=n_groups,
                                             **wire_kw)
    wire["adaptive"] = exchange_lib.adaptive_wire_bytes(
        net, schedule=schedule, n_groups=n_groups, routing=routing, **wire_kw)
    wire["adaptive_on"] = adaptive
    row["rank_bytes"] = _rank_bytes(net, layout, schedule, cfg.neuron_model)
    row["status"] = "OK"
    row["n_neurons"] = spec.n_total
    row["n_synapses_per_neuron"] = spec.k_total
    row["delay_ratio_D"] = spec.delay_ratio
    row["wire_bytes_window"] = wire
    return row


def _failed(arch: str, shape: str, mesh: str, exc: Exception) -> dict:
    traceback.print_exc()
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": f"FAIL({type(exc).__name__}: {exc})"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=SNN_ARCH,
                    help="'mam-snn' (the LM cells wait for the LM training slice)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--snn-schedule", default="structure_aware",
                    help="comma-separated schedules ('' prices no cell: only the "
                         "verify and construction rows)")
    ap.add_argument("--snn-scale", type=float, default=1.0)
    ap.add_argument("--snn-backend", default="",
                    help="delivery backend ('' = config default; 'event' prices the "
                         "outgoing tables)")
    ap.add_argument("--snn-exchange", default="",
                    help="global pathway ('' = dense, 'routed')")
    ap.add_argument("--snn-replicated-tables", action="store_true",
                    help="price the replicated inter receive tables instead of the "
                         "sharded inbound slices")
    ap.add_argument("--snn-no-subgroup-tables", action="store_true",
                    help="keep the per-group inbound slices instead of the "
                         "subgroup-sliced layout")
    ap.add_argument("--snn-adaptive", action="store_true",
                    help="the adaptive two-phase exchange (the row prices both sizings "
                         "either way)")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="per-rank memory budget (GiB) on the priced rows; 0 disables "
                         "the gate. Default: the card's memory (on the CPU it must "
                         "be given)")
    ap.add_argument("--build-rss", action="store_true",
                    help="also measure the host and the sharded build's peaks in two "
                         "fresh processes on --device")
    ap.add_argument("--device", default=None,
                    help="where the measured builds run (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.arch != SNN_ARCH:
        ap.error(f"--arch {args.arch!r}: only {SNN_ARCH!r} is priced; the LM cells need "
                 f"the training artifacts, which wait for the LM training slice")
    dev = resolve_device(args.device)
    budget = args.hbm_gib
    if budget is None:
        if dev.type != "cuda":
            ap.error("--hbm-gib must be given off the card (its default is the card's "
                     "memory)")
        budget = torch.cuda.mem_get_info(dev)[1] / 2**30
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    rows = []
    try:
        rows.append(verify_inter_table_bounds(device=dev))
    except Exception as e:  # a failed check is a FAIL row, and the run goes on
        rows.append(_failed(SNN_ARCH, "table_bounds", "2x2", e))
    _print_row(rows[-1])
    try:
        rows.append(construction_cost_row(args.snn_scale))
    except Exception as e:
        rows.append(_failed(SNN_ARCH, "build", "16x16", e))
    _print_row(rows[-1])
    if args.build_rss:
        try:
            rows.append(measure_build_rss(device=dev))
        except Exception as e:
            rows.append(_failed(SNN_ARCH, "build_rss", "4x2", e))
        _print_row(rows[-1])
    for multi_pod in meshes:
        for sched in filter(None, args.snn_schedule.split(",")):
            try:
                rows.append(enforce_hbm_budget(dryrun_snn_cell(
                    sched, multi_pod, args.snn_scale, backend=args.snn_backend,
                    # routed applies to the structure-aware lumped pathway only
                    exchange=args.snn_exchange if sched == "structure_aware" else "",
                    shard_tables=not args.snn_replicated_tables,
                    subgroup_tables=not args.snn_no_subgroup_tables,
                    adaptive=args.snn_adaptive), budget))
            except Exception as e:
                rows.append(_failed(SNN_ARCH, sched, "2x16x16" if multi_pod else "16x16", e))
            _print_row(rows[-1])

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"\nwrote {len(rows)} rows to {args.out}")
    n_ok = sum(r["status"] == "OK" for r in rows)
    n_fail = len(rows) - n_ok
    print(f"\n=== dry-run summary: {n_ok} OK, 0 SKIP, {n_fail} FAIL ===")
    return 1 if n_fail else 0


def _print_row(row: dict) -> None:
    status = row.get("status", "?")
    base = f"[{row['mesh']}] {row['arch']:28s} {row['shape']:12s} "
    if status != "OK":
        print(base + status)
    elif "build_reduction" in row:  # modelled construction row
        print(base + f"OK build host={row['build_gib_host_modelled']}GiB "
              f"sharded={row['build_gib_shard_modelled']}GiB ({row['build_reduction']}x)")
    elif "peak_reduction" in row:  # measured construction row
        print(base + f"OK build-peak ({row['measured']}) host={row['host_peak_mib']}MiB/"
              f"{row['host_build_s']}s sharded={row['sharded_peak_mib']}MiB/"
              f"{row['sharded_build_s']}s ({row['peak_reduction']}x)")
    elif "rank_bytes" not in row:  # bounds-verify row
        print(base + f"OK modelled={row['bytes_per_device_modelled']}B "
              f"instantiated={row['bytes_per_device_instantiated']}B "
              f"slack={row['bound_slack']}x")
    else:
        rb, wire = row["rank_bytes"], row["wire_bytes_window"]
        tables = ""
        if "inter_tables" in row:
            tb = row["inter_tables"]["table_bytes"]
            tables = (f" inter-tables rep={tb['replicated'] / 2**30:.1f}GiB "
                      f"sharded={tb['sharded'] / 2**30:.1f}GiB ({tb['reduction']:.1f}x)")
        print(base + f"OK rank={rb['total'] / 2**30:7.2f}GiB (tables "
              f"{rb['tables'] / 2**30:.2f}, state {rb['state'] / 2**30:.2f}) "
              f"wire={wire['total_bytes']:,}B/window "
              f"(adaptive {wire['adaptive']['total_bytes_expected']:,})" + tables)


if __name__ == "__main__":
    sys.exit(main())
