"""Dry run at production scale: priced, not run. The port of
``repro.launch.dryrun``.

**The LM cells** (every registered architecture x ``train_4k`` /
``prefill_32k`` / ``decode_32k`` / ``long_500k`` x the 16 x 16 and 2 x 16
x 16 meshes; :func:`dryrun_lm_cell`) take the reference's choices per cell
(the batch axes, the attention layout by ``n_kv % 16``, FSDP over ``data``
from 1e9 parameters, ``n_micro`` the per-replica batch, the hierarchical
int8 trainer with ``--hierarchical`` on two pods) and run one rank's call
on ``meta`` tensors over a :class:`~repro_torch.core.mesh.MeshLayout`:
the training step (its FLOPs one microbatch's times ``n_micro``, its
collectives the microbatch loop's times ``n_micro`` and the step's own
once: :func:`price_lm`) and, in hierarchical mode, the sync step, or one
prefill or decode call of ``make_serve_artifacts``. Nothing is allocated
and no process group is made. The row holds ``rank_bytes`` (the shards a
rank holds, a training step's gradient accumulator (``grad_accum``, the
rank's shards, f32 where it sums: ZeRO-2) among them, and ``gathered``: the most
parameter bytes the call held gathered at once, as the FSDP gather point
counts them while it runs, one unit at a time), ``collectives`` (what
:mod:`~repro_torch.core.comm` counts into the rank, by the same rules a
world counts them),
``flops_per_device`` (``torch.utils.flop_counter.FlopCounterMode``),
``model_flops_total`` and ``useful_flops_ratio`` as the reference defines
them, and the H100 roofline (:data:`H100`). The call runs under the
live-bytes tracker (:class:`~repro_torch.launch.memory.LiveBytes`, in the
FLOP counter's pass), the counterpart of XLA's ``memory_analysis``:
``rank_bytes["transient"]`` (the most the call created and held at once:
activations, saved tensors, gathered units, the accumulator),
``["output"]`` and ``["peak"]`` (held at entry plus transient), recorded
as ``hbm_gib_modelled``, not gated, as the reference records it. Its HLO
statistics have no counterpart (no HLO).

**The paper's workload** (``--arch mam-snn``, the default): the production
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
* ``rank_bytes``: one rank's table slices and state (``total``), from the
  meta shapes cut as :mod:`repro_torch.core.dist_engine` cuts them; one
  window of that rank's engine run on the meta network under the
  live-bytes tracker (``transient``, ``output``; every size a run reads
  from the device at its static bound); and ``peak``, the two summed,
  held to the HBM budget (``--hbm-gib``; by default the card's own
  memory), as the reference gates XLA's argument + temp + output bytes.

Beside the cells: the width bounds held against tables instantiated at a
small size (:func:`verify_inter_table_bounds`), the construction model
(:func:`construction_cost_row`) and, with ``--build-rss``, the measured
peaks of the host and the sharded build (:func:`measure_build_rss`).

The reference's other XLA readings of these cells (``cost_analysis``
FLOPs, the compiled HLO's statistics and collectives) and its TPU roofline
have no counterpart here.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mam-snn \\
        --snn-schedule conventional,structure_aware --mesh both --out rows.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mam-snn --device cpu --hbm-gib 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b,grok-1-314b \\
        --shape all --mesh both --hierarchical
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
from repro_torch.core import comm
from repro_torch.core.engine import EngineConfig
from repro_torch.core.mesh import MeshLayout
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.configs.registry import arch_skips, get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.memory import LiveBytes
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import (kv_heads, make_serve_artifacts, make_train_artifacts,
                                    shard_state)

__all__ = [
    "SNN_ARCH",
    "H100",
    "MeshLayout",
    "production_layout",
    "model_flops",
    "lm_cell_choices",
    "price_lm",
    "roofline_terms",
    "dryrun_lm_cell",
    "record_hbm",
    "enforce_hbm_budget",
    "verify_inter_table_bounds",
    "construction_cost_row",
    "measure_build_rss",
    "dryrun_snn_cell",
    "price_window",
    "main",
]

SNN_ARCH = "mam-snn"


# The card's constants, each with its source. Compute and HBM: the H100 SXM
# (80 GB HBM3) data sheet, dense bf16 989 TFLOP/s and 3.35 TB/s, the
# figures PERF.md's kernel bounds use. The wire: a node of 8 cards joined by
# NVLink 4 (900 GB/s a card, both directions: 450 GB/s into a card) and
# across nodes one 400 Gb/s NDR InfiniBand port a card (50 GB/s into it),
# as in NVIDIA's DGX H100 (its data sheet). A collective whose group lies
# within a node is priced at NVLink's rate, any other at the network's.
H100 = {
    "peak_flops_bf16": 989e12,
    "hbm_bytes_s": 3.35e12,
    "nvlink_bytes_s": 450e9,
    "network_bytes_s": 50e9,
    "cards_per_node": 8,
}


def production_layout(multi_pod: bool) -> MeshLayout:
    """The paper's production meshes: 16 x 16 (data, model) or 2 x 16 x 16
    (pod, data, model); the last axis is the intra-area subgroup."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def modelled_hbm_gib(row: dict) -> float:
    """One rank's priced bytes (GiB): its table slices and its state, plus
    a window's transient (``rank_bytes["peak"]``), as the reference sums
    XLA's argument, temp and output bytes."""
    return row.get("rank_bytes", {}).get("peak", 0) / 2**30


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


def price_window(net, spec, layout: MeshLayout, cfg: EngineConfig) -> dict:
    """The live bytes of one window of ``layout``'s rank: its engine built
    over the layout on ``net`` (a meta network: nothing is allocated, no
    process group is made), its state from ``init``, and one ``window``
    run under :class:`~repro_torch.launch.memory.LiveBytes`. Every size a
    run reads from the device takes its static bound (a ladder its top
    rung, a routed edge its bound), the size the reference compiles for.
    Returns ``{"transient", "output"}`` bytes."""
    engine = dist_engine_lib._make_dist_engine(net, spec, layout, cfg)
    state = engine.init()
    _, _, _, _, live = _measured(lambda: engine.window(state), False)
    return live


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
    ``wire_bytes_window`` (the engine's ``wire_bytes``) and ``rank_bytes``:
    the rank's tables and state (``total``), one window of rank 0's engine
    run on the meta network (:func:`price_window`: ``transient``,
    ``output``) and ``peak``, the two summed, which the HBM gate holds.
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
    rb = row["rank_bytes"] = _rank_bytes(net, layout, schedule, cfg.neuron_model)
    rb.update(price_window(net, spec, layout, cfg))
    rb["peak"] = rb["total"] + rb["transient"]
    row["status"] = "OK"
    row["n_neurons"] = spec.n_total
    row["n_synapses_per_neuron"] = spec.k_total
    row["delay_ratio_D"] = spec.delay_ratio
    row["wire_bytes_window"] = wire
    return row


# ---------------------------------------------------------------------------
# the LM cells


def model_flops(bundle, shape: ShapeSpec) -> float:
    """6 * N_active * tokens (train) / 2 * N_active * tokens (inference):
    the reference's ``model_flops``."""
    n_active = bundle.cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * tokens


def lm_cell_choices(arch_id: str, shape_name: str, multi_pod: bool,
                    hierarchical: bool) -> dict:
    """The reference's choices for a cell: ``dp_axes`` (every DP axis, the
    pod's too, except for the hierarchical trainer), ``act_batch_axes``
    (none for ``long_500k``), ``attn_sharding`` (``"heads"`` where the KV
    heads divide the 16-way model axis, else ``"seq"``), ``fsdp_axis``
    (``"data"`` from 1e9 parameters), ``hierarchical`` (two pods, training,
    ``--hierarchical``) and ``n_micro`` (the per-replica batch: one sample
    a microbatch)."""
    shape = SHAPES[shape_name]
    layout = production_layout(multi_pod)
    hier = hierarchical and multi_pod and shape.kind == "train"
    dp_axes = (("pod", "data") if multi_pod and not (hierarchical and shape.kind == "train")
               else ("data",))
    n_kv = kv_heads(get_arch(arch_id))
    choices = {
        "dp_axes": dp_axes,
        "act_batch_axes": None if shape.name == "long_500k" else dp_axes,
        "attn_sharding": None if n_kv is None else "heads" if n_kv % 16 == 0 else "seq",
        "hierarchical": hier,
    }
    bundle = get_arch(arch_id, act_batch_axes=choices["act_batch_axes"],
                      attn_sharding=choices["attn_sharding"])
    choices["fsdp_axis"] = "data" if bundle.cfg.param_count() >= 1e9 else None
    n_dp = math.prod(layout.shape[a] for a in dp_axes)
    per_replica = shape.global_batch // (n_dp * (layout.shape["pod"] if hier else 1))
    choices["n_micro"] = max(1, per_replica)
    return choices


def _bytes(tree) -> int:
    return sum(_nbytes(x) for x in named_leaves(tree).values())


def _table() -> dict:
    """What :mod:`comm` counted, ``"op axes,..."`` -> calls and bytes into
    this rank."""
    return {f"{op} {','.join(axes)}": {"calls": comm.calls[(op, axes)], "bytes": n}
            for (op, axes), n in sorted(comm.received.items())}


def _wire_s(table: dict, layout: MeshLayout) -> float:
    """Seconds on the wire of ``table``'s bytes, each collective at the
    rate of its group: NVLink within a node, the network across nodes."""
    node = H100["cards_per_node"]
    total = 0.0
    for key, entry in table.items():
        axes = key.split(" ", 1)[1].split(",")
        rest = {a: c for a, c in layout.coords.items() if a not in axes}
        members = [r for r in range(layout.size)
                   if all(MeshLayout(layout.extents, layout.axis_names, r).coords[a] == c
                          for a, c in rest.items())]
        within = len({r // node for r in members}) == 1
        total += entry["bytes"] / H100["nvlink_bytes_s" if within else "network_bytes_s"]
    return total


def roofline_terms(flops: float, hbm_bytes: float, table: dict, layout: MeshLayout) -> dict:
    """The three terms in seconds for one rank (:data:`H100`): FLOPs over
    the bf16 peak, bytes over HBM's rate, the collectives' bytes over their
    wire's rate."""
    return {"compute_s": flops / H100["peak_flops_bf16"],
            "memory_s": hbm_bytes / H100["hbm_bytes_s"],
            "collective_s": _wire_s(table, layout)}


def _dominant(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])


def _measured(fn, count_flops: bool):
    """``fn()`` with comm's counters zeroed first, under a FLOP counter and
    the live-bytes tracker on ``meta``: ``(its result, the counted
    table, the FLOPs, the peak of the gathered parameter bytes, the
    tracker's {"transient", "output"} bytes)``."""
    from torch.utils.flop_counter import FlopCounterMode

    comm.reset_stats()
    if not count_flops:
        with LiveBytes("meta") as live:
            out = fn()
        flops = 0
    else:
        with FlopCounterMode(display=False) as counter, LiveBytes("meta") as live:
            out = fn()
        flops = counter.get_total_flops()
    return (out, _table(), flops, comm.gathered["peak"],
            {"transient": live.transient, "output": live.output})


def price_lm(bundle, shape: ShapeSpec, layout: MeshLayout, *, fsdp_axis: str | None = "data",
             dp_axes: tuple[str, ...] = ("data",), hier_cfg: HierarchicalConfig | None = None,
             n_micro: int = 1, cache_index: int | None = None, prompt_len: int | None = None,
             cache_dtype=torch.bfloat16, count_flops: bool = True) -> dict:
    """One rank's call of ``shape`` priced on ``layout``'s rank: the
    training step of ``make_train_artifacts`` (microbatches of one sequence
    a rank; ``flops_per_device`` is one microbatch's FLOPs times
    ``n_micro``), with the sync step priced apart in hierarchical mode, or
    a prefill or decode call of ``make_serve_artifacts`` (a prompt of
    ``prompt_len`` tokens, by default the cache's length; decode at
    ``cache_index``, by default the cache's last position; the cache of
    ``cache_dtype``, as ``make_serve_artifacts`` takes it). Returns
    ``rank_bytes``, ``collectives``, ``flops_per_device`` and,
    hierarchical, ``sync_step``. ``rank_bytes["gathered"]`` is the peak of
    the parameter bytes the call held gathered (the FSDP gather point's
    count, :data:`~repro_torch.core.comm.gathered`: its largest unit, as a
    rank computes on it), and a training step's ``held`` counts its
    gradient accumulator (``grad_accum``: the rank's shards, 4 bytes an
    element where the step sums microbatches or batch ranks).

    Each call runs under :class:`~repro_torch.launch.memory.LiveBytes`, in
    the same pass as the FLOP counter: ``rank_bytes["transient"]`` is the
    most bytes the call created and held at once (activations, the saved
    tensors of the backward, the gathered units, the accumulator, the
    optimizer's temporaries, a prefill's cache: XLA's temp and output
    bytes), the largest over the microbatch counts priced and, in
    hierarchical mode, the sync step; ``["output"]`` what that call left
    alive when it returned; ``["peak"]`` the bytes alive at entry (``held``
    less what the call makes itself: the accumulator, a prefill's cache)
    plus ``transient``.

    A training step's ``collectives`` are the step's as it runs them:
    what the microbatch loop counts (the split's activation sums and
    gathers, forward and backward) ``n_micro`` times, what the step counts
    once (the parameters' gathers, the gradients' sums, the clip's norm)
    once. With ``n_micro`` above 2 the step is priced at two microbatches
    and at three, and each collective's calls and bytes are ``c2 +
    (n_micro - 2) * (c3 - c2)``: the loop body times its trip count, as the
    reference counts a loop (from two microbatches on, the step sums its
    gradients in the f32 accumulator, not in the parameters' dtype)."""
    out: dict[str, Any] = {}
    if shape.kind == "train":
        def step_at(micro: int, count: bool):
            art = make_train_artifacts(bundle, mesh=layout, batch_axes=dp_axes,
                                       fsdp_axis=fsdp_axis, hier_cfg=hier_cfg, n_micro=micro)
            params = art.shard(art.params_sds, "params")
            for x in params.parameters():
                x.requires_grad_()
            opt = art.shard(art.opt_sds, "opt")
            # one sequence a rank a microbatch, cut as host_batch cuts it
            n_shards = micro * layout.extent(dp_axes) * (
                layout.shape[hier_cfg.pod_axis] if hier_cfg else 1)
            batch = art.batch_sds(bundle, dataclasses.replace(shape, global_batch=n_shards))
            batch = shard_state(batch, art.batch_specs, layout)
            _, table, flops, peak, live = _measured(lambda: art.step_fn(params, opt, batch),
                                                    count)
            return art, params, opt, _bytes(batch) // micro, table, flops, peak, live

        micros = [1] if n_micro == 1 else [2] if n_micro == 2 else [2, 3]
        if count_flops and n_micro > 1:
            micros = [1] + micros  # one microbatch's FLOPs
        runs = {m: step_at(m, count_flops and m == 1) for m in micros}
        art, params, opt, batch_bytes, _, flops, _, _ = runs[micros[0]]
        gathered = max(run[6] for run in runs.values())
        lives = [run[7] for run in runs.values()]
        table = runs[min(n_micro, 2)][4]
        if n_micro > 2:
            more = runs[3][4]
            table = {k: {f: table[k][f] + (n_micro - 2) * (v[f] - table[k][f]) if k in table
                         else (n_micro - 2) * v[f] for f in ("calls", "bytes")}
                     for k, v in more.items()}
        sync = art.shard(art.sync_sds, "sync") if hier_cfg is not None else None
        held = {"params": _bytes(params), "opt": _bytes(opt), "batch": n_micro * batch_bytes,
                "grad_accum": art.accumulator_bytes(params)}
        flops *= n_micro
        if sync is not None:
            held["sync"] = _bytes(sync)
            _, sync_table, _, _, live = _measured(lambda: art.sync_fn(params, sync), False)
            lives.append(live)
            out["sync_step"] = {"collectives": sync_table,
                                "bytes": sum(e["bytes"] for e in sync_table.values())}
        # The step makes its accumulator itself: it is in the transient.
        created = held["grad_accum"]
    else:
        art = make_serve_artifacts(bundle, shape, layout, fsdp_axis=fsdp_axis,
                                   cache_dtype=cache_dtype)
        params = art.shard(art.params_sds)
        if shape.kind == "prefill":
            specs = bundle.input_specs(dataclasses.replace(
                shape, seq_len=prompt_len or shape.seq_len))
            del specs["labels"]
            batch = {k: layout.shard(v, (art.batch_axes,) + (None,) * (v.dim() - 1), k).clone()
                     for k, v in specs.items()}
            (_, state), table, flops, gathered, live = _measured(
                lambda: art.prefill_fn(params, batch), count_flops)
        else:
            state = shard_state(art.state_sds, art.state_specs, layout)
            batch = {"tokens": layout.shard(
                torch.empty((shape.global_batch, 1), dtype=torch.long, device="meta"),
                art.token_spec, "tokens")}
            index = shape.seq_len - 1 if cache_index is None else cache_index
            _, table, flops, gathered, live = _measured(
                lambda: art.decode_fn(params, state, batch["tokens"], index), count_flops)
        lives = [live]
        held = {"params": _bytes(params), "cache": _bytes(state["cache"]),
                "batch": _bytes(batch)}
        if "enc_out" in state:
            held["enc_out"] = _nbytes(state["enc_out"])
        # A prefill makes the cache (and an encoder's output) it returns: they
        # are in its transient.
        created = held["cache"] + held.get("enc_out", 0) if shape.kind == "prefill" else 0
    held["held"] = sum(held.values())
    held["gathered"] = gathered
    worst = max(lives, key=lambda live: live["transient"])
    held["transient"], held["output"] = worst["transient"], worst["output"]
    held["peak"] = held["held"] - created + held["transient"]
    out.update(rank_bytes=held, collectives=table, flops_per_device=flops)
    return out


def dryrun_lm_cell(arch_id: str, shape_name: str, multi_pod: bool, hierarchical: bool) -> dict:
    """The reference's cell for ``arch_id`` x ``shape_name`` on a production
    mesh, priced by :func:`price_lm` on rank 0 of the layout: a ``SKIP``
    row where the architecture skips the shape."""
    shape = SHAPES[shape_name]
    layout = production_layout(multi_pod)
    row: dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": "x".join(map(str, layout.extents)),
        "mode": "hierarchical" if hierarchical else "sync",
    }
    skip = arch_skips(arch_id).get(shape_name)
    if skip:
        row["status"] = f"SKIP({skip})"
        return row
    t0 = time.time()
    choices = lm_cell_choices(arch_id, shape_name, multi_pod, hierarchical)
    bundle = get_arch(arch_id, act_batch_axes=choices["act_batch_axes"],
                      attn_sharding=choices["attn_sharding"])
    hier_cfg = (HierarchicalConfig(sync_every=10, compression="int8")
                if choices["hierarchical"] else None)
    priced = price_lm(bundle, shape, layout, fsdp_axis=choices["fsdp_axis"],
                      dp_axes=choices["dp_axes"], hier_cfg=hier_cfg, n_micro=choices["n_micro"])
    row["choices"] = choices
    row.update(priced)
    rb = priced["rank_bytes"]
    row["roofline"] = roofline_terms(priced["flops_per_device"], rb["held"] + rb["gathered"],
                                     priced["collectives"], layout)
    row["dominant"] = _dominant(row["roofline"])
    if hier_cfg is not None:
        row["sync_every"] = hier_cfg.sync_every
        sync = row["sync_step"]
        sync["roofline"] = roofline_terms(0.0, 0.0, sync["collectives"], layout)
        # the sync trainer's step on the same mesh: what the slow tier replaces
        base = price_lm(bundle, shape, layout, fsdp_axis=choices["fsdp_axis"],
                        dp_axes=("pod", "data"), n_micro=choices["n_micro"], count_flops=False)
        row["sync_trainer_step"] = {
            "collectives": base["collectives"],
            "bytes": sum(e["bytes"] for e in base["collectives"].values())}
    row["status"] = "OK"
    row["price_s"] = round(time.time() - t0, 1)
    row["model_flops_total"] = mf = model_flops(bundle, shape)
    total = row["flops_per_device"] * layout.size
    row["useful_flops_ratio"] = mf / total if total else 0.0
    row["not_priced"] = "the reference's HLO statistics (no HLO: no counterpart)"
    return row


def record_hbm(row: dict, budget_gib: float | None) -> dict:
    """An LM row's modelled bytes a rank (``rank_bytes["peak"]``: what the
    rank holds at entry plus the call's transient, the gathered units and
    the activations among them) beside ``budget_gib``: recorded, not gated
    (the reference gates its SNN rows only)."""
    if row.get("status") == "OK":
        row["hbm_gib_modelled"] = round(row["rank_bytes"]["peak"] / 2**30, 3)
        row["hbm_gib_budget"] = budget_gib
    return row


def _failed(arch: str, shape: str, mesh: str, exc: Exception) -> dict:
    traceback.print_exc()
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": f"FAIL({type(exc).__name__}: {exc})"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=SNN_ARCH,
                    help="'mam-snn' (the default), 'all' (every registered LM "
                         "architecture) or arch ids, comma separated")
    ap.add_argument("--shape", default="all", help="'all' or shape names, comma separated")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--hierarchical", action="store_true",
                    help="train with the paper's hierarchical trainer (multi-pod only)")
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
                    help="per-rank memory budget (GiB): gates the SNN rows, recorded on "
                         "the LM rows; 0 disables the gate. Default: the card's memory "
                         "(off the card the SNN rows need it given)")
    ap.add_argument("--build-rss", action="store_true",
                    help="also measure the host and the sharded build's peaks in two "
                         "fresh processes on --device")
    ap.add_argument("--device", default=None,
                    help="where the SNN rows' instantiated checks run (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    unknown = [a for a in archs if a != SNN_ARCH and a not in list_archs()]
    if unknown:
        ap.error(f"--arch: unknown {unknown}; available: {SNN_ARCH}, all, "
                 f"{', '.join(list_archs())}")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    if any(sh not in SHAPES for sh in shapes):
        ap.error(f"--shape: {args.shape!r}; available: all, {', '.join(SHAPES)}")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    budget = args.hbm_gib
    dev = None
    if SNN_ARCH in archs:
        dev = resolve_device(args.device)
        if budget is None:
            if dev.type != "cuda":
                ap.error("--hbm-gib must be given off the card for the SNN rows (its "
                         "default is the card's memory)")
            budget = torch.cuda.mem_get_info(dev)[1] / 2**30
    elif budget is None and torch.cuda.is_available():
        budget = torch.cuda.mem_get_info()[1] / 2**30

    rows = []
    if SNN_ARCH in archs:
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
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            if arch == SNN_ARCH:
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
                        rows.append(_failed(SNN_ARCH, sched, mesh_name, e))
                    _print_row(rows[-1])
                continue
            for shape in shapes:
                try:
                    rows.append(record_hbm(dryrun_lm_cell(arch, shape, multi_pod,
                                                          args.hierarchical), budget))
                except Exception as e:
                    rows.append(_failed(arch, shape, mesh_name, e))
                _print_row(rows[-1])

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"\nwrote {len(rows)} rows to {args.out}")
    n_ok = sum(r["status"] == "OK" for r in rows)
    n_skip = sum(r["status"].startswith("SKIP") for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"\n=== dry-run summary: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL ===")
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
    elif "flops_per_device" in row:  # LM cell
        rb, terms = row["rank_bytes"], row["roofline"]
        wire = sum(e["bytes"] for e in row["collectives"].values())
        line = (f"OK held={rb['held'] / 2**30:.2f}GiB gathered={rb['gathered'] / 2**30:.2f}GiB "
                f"transient={rb['transient'] / 2**30:.2f}GiB peak={rb['peak'] / 2**30:.2f}GiB "
                f"wire={wire:,}B flops/dev={row['flops_per_device']:.3e} "
                f"useful={row['useful_flops_ratio']:.3f} roofline compute="
                f"{terms['compute_s']:.3e}s memory={terms['memory_s']:.3e}s collective="
                f"{terms['collective_s']:.3e}s ({row['dominant']}) {row['price_s']}s")
        if "sync_step" in row:
            line += (f" | sync step {row['sync_step']['bytes']:,}B every {row['sync_every']} "
                     f"steps vs the sync trainer's {row['sync_trainer_step']['bytes']:,}B "
                     f"a step")
        print(base + line)
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
              f"transient={rb['transient'] / 2**30:.2f}GiB peak={rb['peak'] / 2**30:.2f}GiB "
              f"wire={wire['total_bytes']:,}B/window "
              f"(adaptive {wire['adaptive']['total_bytes_expected']:,})" + tables)


if __name__ == "__main__":
    sys.exit(main())
