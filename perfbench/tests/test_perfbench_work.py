"""The work counts behind ``window_mfu`` and the kernels' roofline shares,
on hand-counted cases, and the trace's reduction on a made-up trace."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import trace, work  # noqa: E402
from perfbench.reference import simulate  # noqa: E402
from perfbench.reference.network import NetDesc, global_sources  # noqa: E402
from perfbench.tests import cells  # noqa: E402


def _desc(n=10, k=(3, 2), areas=2):
    return NetDesc.from_config(cells.bench_config(n_areas=areas, n=n, k=k)["network"])


def test_a_window_with_no_spikes_moves_only_the_neurons():
    desc = _desc()
    w = work.window_work(desc, "lif", np.zeros((1, 2)), [10, 10], cycles_per_window=10)
    # 20 neurons x 10 cycles x (24 state + 8 ring slot + 1 spike) + 20 x 9 constant bytes
    assert w["neuron"] == (20 * 10 * 33 + 20 * 9, 20 * 10 * 7)
    assert w["intra"] == (0.0, 0.0) and w["inter"] == (0.0, 0.0)
    iaf = work.window_work(desc, "ignore_and_fire", np.zeros((1, 2)), [10, 10],
                           cycles_per_window=10)
    assert iaf["neuron"] == (20 * 10 * 17 + 20 * 5, 0.0)


def test_one_spike_reaches_its_expected_fan_out():
    """One spike in area 0 of two areas of 10, K 3 / 2: 3 synapses within
    its area and 10 * 2 / (1 * 10) = 2 into area 1, 13 bytes each."""
    desc = _desc()
    w = work.window_work(desc, "lif", np.array([[1, 0]]), [10, 10], cycles_per_window=10)
    assert w["intra"] == (3 * 13, 3) and w["inter"] == (2 * 13, 2)
    # Onto area 1 alone lands only the long-range part.
    w1 = work.window_work(desc, "lif", np.array([[1, 0]]), [0, 10], cycles_per_window=10)
    assert w1["intra"] == (0.0, 0.0) and w1["inter"] == (2 * 13, 2)


def test_expected_fan_out_matches_the_drawn_tables():
    """Summed over every source the expectation is the tables' exact count."""
    desc = _desc(n=200, k=(20, 10), areas=4)
    counts = torch.zeros(desc.n_rows, dtype=torch.int64)

    def count(p, rows, src, w, d):
        counts.add_(torch.bincount(global_sources(desc, rows, p, src).reshape(-1),
                                   minlength=desc.n_rows))

    simulate.for_each_draw(desc, 3, simulate.Block(desc), "cpu", count, full=False)
    every = np.full((1, 4), 200.0)  # every source spikes once
    w = work.window_work(desc, "lif", every, [200] * 4, cycles_per_window=10)
    assert w["intra"][1] + w["inter"][1] == pytest.approx(int(counts.sum()))


def test_least_time_is_bound_by_bytes():
    peaks = {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}
    w = {"neuron": (3.35e12, 1e9), "intra": (0.0, 0.0), "inter": (0.0, 0.0)}
    assert work.least_seconds(w, work.PARTS, peaks) == pytest.approx(1.0)
    assert work.peaks_for("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert work.peaks_for("cpu") is None


def test_trace_summary_of_a_made_up_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "spike_deliver_kernel", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "superstep_lif_kernel", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 70, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(str(path))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40) and [70, 80)
    assert s["launches"] == 2
    assert s["idle_gaps"]["aten::nonzero"] == pytest.approx(30e-6)  # [40, 70)
    assert trace.kernel_seconds(s, ("spike_deliver",)) == pytest.approx(30e-6)
