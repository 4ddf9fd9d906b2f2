"""Reading a profiler trace of a stretch of windows.

The harness profiles a stretch of windows with ``torch.profiler`` (CPU and
CUDA activities, CUPTI on the card) inside one ``bench.traced`` span, and
exports the trace as Chrome JSON. :func:`summarize` reduces it to what the
per-layer metrics read: the span's length, the union of the device's busy
intervals in it, device time and launches by kernel name, and the idle
gaps, each named by the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

__all__ = ["SPAN", "WINDOW_SPAN", "summarize", "kernel_seconds"]

SPAN = "bench.traced"
WINDOW_SPAN = "bench.window"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def _union(intervals):
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(host, starts, t: float, reach: int = 256) -> str:
    """The innermost host operation running at ``t``: of those that
    contain it, the one that started last (host operations nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host, outside any operation"


def summarize(path: str) -> dict | None:
    """The summary of the Chrome trace at ``path`` (times in seconds), or
    None when it holds no ``bench.traced`` span or no device operation."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    spans = [e for e in xs if e.get("name") == SPAN]
    if not spans:
        return None
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device, host = [], []
    for e in xs:
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE and s < hi and s + d > lo:
            device.append((max(s, lo), min(s + d, hi), cat, e.get("name", "")))
        elif cat in _HOST and e.get("name") not in (SPAN,):
            host.append((s, s + d, e.get("name", "")))
    if not device:
        return None
    busy = _union((s, e) for s, e, _, _ in device)
    by_name = defaultdict(float)
    launches = 0
    for s, e, cat, name in device:
        by_name[name] += (e - s) * 1e-6
        launches += cat == "kernel"
    gaps = []
    cursor = lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        idle[_host_at(host, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "launches": launches,
        "device_ops": dict(by_name),
        "idle_gaps": dict(idle),
    }


def kernel_seconds(summary: dict, symbols) -> float:
    """Device seconds of the kernels whose name holds any of ``symbols``."""
    return sum(s for name, s in summary["device_ops"].items()
               if any(sym in name for sym in symbols))
