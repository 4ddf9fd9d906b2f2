"""What a window needs of the chip: bytes and operations, counted from the
window's spikes and the tables' shapes, whichever route runs.

The rule (each input byte read once, each output byte written once, only
what these inputs need):

* a neuron, every cycle: its state read and written (LIF ``v``, ``i_syn``,
  ``refrac``: 12 + 12 bytes; ignore-and-fire ``countdown``: 4 + 4), its
  ring slot read and cleared (4 + 4) and its spike written (1); once a
  window its constant inputs read (LIF: drive probability and id, 8, and
  ``alive``, 1; ignore-and-fire: interval, 4, and ``alive``, 1);
* a delivered synapse (one whose source spiked): its target, weight and
  delay read once (4 + 4 + the delay's 1 or 4) and its ring add written
  once (4).

Operations: a LIF step is 7 (two fused multiply-adds count 2 each, the
current's product, the drive's add, the threshold's compare); an
ignore-and-fire step is integer work and counts 0; a delivery is one add.
At these ratios bytes bound every part (a few operations per 13 or more
bytes, against the chip's 20 operations a byte).

The synapses a window delivers are counted in expectation from its spikes
per area: a target row draws ``k_intra`` sources uniformly in its own area,
so a source of area ``a`` reaches ``k_intra`` of its area's live rows on
average, and ``k_inter`` sources over the ``n_allowed(b)`` areas allowed to
project into its area ``b``, so it reaches ``live(b) * k_inter /
(n_allowed(b) * size(a))`` rows of each area ``b`` it projects to. ``live``
counts the live target rows the work lands on. Over the ~10^3-10^5 spikes of a window the expectation is
within a small fraction of a percent of the exact count.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["PARTS", "window_work", "least_seconds", "peaks_for", "kernel_share", "fused_window"]

PARTS = ("neuron", "intra", "inter")
_STATE_BYTES = {"lif": 12, "ignore_and_fire": 4}
_CONST_BYTES = {"lif": 9, "ignore_and_fire": 5}
_STEP_FLOPS = {"lif": 7, "ignore_and_fire": 0}


def window_work(desc, model: str, area_spikes, live_rows, *, cycles_per_window: int) -> dict:
    """``{part: (bytes, operations)}`` of the windows whose spikes per
    (window, source area) are ``area_spikes [W, A]``, onto ``live_rows
    [A]`` live target rows of each area. ``desc`` is a
    :class:`~perfbench.reference.network.NetDesc`."""
    spikes = np.asarray(area_spikes, np.float64).reshape(-1, desc.n_areas)
    live = np.asarray(live_rows, np.float64)
    sizes = np.asarray(desc.sizes, np.float64)
    w = spikes.shape[0]
    per_source = spikes.sum(axis=0)  # spikes of each source area over the windows
    d_bytes = 1 if max(desc.intra_max, desc.inter_max) <= 127 else 4
    syn_bytes = 4 + 4 + d_bytes + 4
    neurons = live.sum()
    neuron_bytes = neurons * (w * cycles_per_window * (2 * _STATE_BYTES[model] + 8 + 1)
                              + w * _CONST_BYTES[model])
    neuron_flops = neurons * w * cycles_per_window * _STEP_FLOPS[model]
    intra = float((per_source * desc.k_intra * live / sizes).sum())
    adj = desc.adjacency_matrix()
    n_allowed = adj.sum(axis=0).astype(np.float64)
    reach = np.zeros(desc.n_areas)
    for a in range(desc.n_areas):
        for b in np.flatnonzero(adj[a]):
            reach[a] += live[b] * desc.k_inter / (n_allowed[b] * sizes[a])
    inter = float((per_source * reach).sum())
    return {"neuron": (float(neuron_bytes), float(neuron_flops)),
            "intra": (intra * syn_bytes, intra),
            "inter": (inter * syn_bytes, inter)}


def least_seconds(work: dict, parts, peaks: dict) -> float:
    """The least time ``parts`` of ``work`` could take: the larger of bytes
    over the memory bandwidth and operations over the float32 peak."""
    b = sum(work[p][0] for p in parts)
    f = sum(work[p][1] for p in parts)
    return max(b / peaks["bytes_per_s"], f / peaks["flops_per_s"])


def peaks_for(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    None for a card the table does not hold."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    return None


def kernel_share(ctx, symbols, parts) -> float | None:
    """A kernel's share of its roofline over the traced stretch, in %: the
    least time of ``parts`` of the traced windows' work over the device time
    of the kernels whose name holds any of ``symbols``. None where the trace
    holds no such kernel or the card no peaks."""
    from perfbench import trace

    if ctx.trace is None or ctx.peaks is None:
        return None
    seconds = trace.kernel_seconds(ctx.trace, symbols)
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ctx.work_traced, parts, ctx.peaks) / seconds


def fused_window(ctx) -> bool:
    """Whether the cell runs the fused window kernel (which delivers the
    window's short-range synapses itself)."""
    return bool(ctx.traffic["engine"].get("superstep_kernel", False))
