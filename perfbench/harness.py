"""The benchmark's harness: one cell of ``BENCHMARK.json`` on one card.

A run builds the cell's network from ``--seed`` on the device
(``repro_torch.core.connectivity.build_network`` and
``core.factory.make_simulation``), runs the traffic's untimed warm-up
windows, then times ``--seconds`` of windows through
``repro_torch.core.schedule.run_windows``, the resilient loop the launcher
drives, with no checkpoints. ``run_windows`` waits for the device after
every window. The timed window's length is the host clock from its start
to its last window's end; each window's own time is read between CUDA
events recorded at consecutive window ends (the device's clock: a host
clock is too coarse for a window of a few ms). Once the window has closed
and the peak memory is read, the run's outputs are compared with the plain
reference (:mod:`perfbench.judge`, :mod:`perfbench.reference`), which draws
the network again from the seed.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``.

With ``trace`` a stretch of ``trace_windows`` windows at the start of the
timed window runs under ``torch.profiler`` inside a ``bench.traced`` span
(each window in a ``bench.window`` span); the rest of the window runs
untraced, and the per-layer metrics read both.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from perfbench import judge, trace as trace_lib, work as work_lib
from perfbench.reference import simulate
from perfbench.reference.network import M32, NetDesc, mix32

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Cell", "load_cell", "seeds", "run", "forbidden_modules"]


@dataclasses.dataclass
class Cell:
    """One workload: its configuration and traffic files' contents and the
    metrics it reports (``(name, unit)`` pairs)."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    manifest = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")

    def applies(m):
        return name in m.get("workloads", [name])

    # A per-layer metric reads in the cells that report the metric it moves.
    end_to_end = [(m["name"], m["unit"]) for m in manifest["end_to_end"] if applies(m)]
    reported = {n for n, _ in end_to_end}
    per_layer = [(m["name"], m["unit"]) for m in manifest["per_layer"]
                 if applies(m) and m["moves"] in reported]
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=end_to_end, per_layer=per_layer)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeds(seed: int) -> tuple[int, int]:
    """``(network seed, drive seed)``, both 32-bit, from the run's seed."""
    s = int(seed)
    build = (s ^ (s >> 32)) & M32
    drive = int(mix32(torch.tensor((build + 0x632BE5AB) & M32)))
    return build, drive


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The program: its spec, checked against the configuration's description
# ---------------------------------------------------------------------------

def program_spec(config: dict):
    from repro_torch.core import areas

    return getattr(areas, config["builder"])(**config["args"])


def spec_drift(spec, desc: NetDesc, lif) -> list[str]:
    """Where the program's spec (and its LIF parameters) departs from the
    configuration's description."""
    out = []
    sizes = tuple(int(x) for x in spec.area_sizes())
    if sizes != desc.sizes:
        out.append(f"sizes {sizes} != {desc.sizes}")
    rates = np.asarray(spec.area_rates(), np.float32)
    if not np.array_equal(rates, np.asarray(desc.rates_hz, np.float32)):
        out.append(f"rates {rates.tolist()} != {desc.rates_hz}")
    for f in ("k_intra", "k_inter", "dt_ms", "d_min_inter_ms", "delay_intra_mean_ms",
              "delay_intra_std_ms", "delay_intra_max_ms", "delay_inter_mean_ms",
              "delay_inter_std_ms", "delay_inter_max_ms", "exc_fraction", "w_exc", "g",
              "ext_rate_hz", "w_ext"):
        if getattr(spec, f) != getattr(desc, f):
            out.append(f"{f} {getattr(spec, f)} != {getattr(desc, f)}")
    if not np.array_equal(spec.adjacency_matrix(), desc.adjacency_matrix()):
        out.append("area adjacency differs")
    for f, v in desc.lif.items():
        if getattr(lif, f) != v:
            out.append(f"lif.{f} {getattr(lif, f)} != {v}")
    return out


def _tables_bytes(net) -> int:
    total = 0
    for f in dataclasses.fields(net):
        x = getattr(net, f.name)
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Clock:
    """Window ends: the host clock, and on the card a CUDA event each, whose
    differences time the windows on the device's clock."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.host, self.events = [], []

    def mark(self) -> None:
        self.host.append(time.perf_counter())
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    def seconds(self, lo: int, hi: int) -> np.ndarray:
        """Each window's time from mark ``lo`` to mark ``hi``."""
        if not self.cuda:
            return np.diff(np.asarray(self.host[lo:hi + 1]))
        evs = self.events[lo:hi + 1]
        return np.asarray([a.elapsed_time(b) for a, b in zip(evs, evs[1:])]) * 1e-3


def _body(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float,
          tamper=None, stamps: dict | None = None) -> dict:
    from repro_torch.core import connectivity, faults
    from repro_torch.core import schedule as schedule_lib
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.factory import make_simulation

    traffic = cell.traffic
    dev = torch.device("cuda:0" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    build_seed, drive_seed = seeds(seed)
    desc = NetDesc.from_config(cell.config["network"])
    cfg = EngineConfig(**traffic["engine"], seed=drive_seed)
    spec = program_spec(cell.config)
    drift = spec_drift(spec, desc, cfg.lif)
    if drift:
        raise RuntimeError(f"the program's spec is not the configuration's: {drift}")
    model = cfg.neuron_model
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter()
    marks_in = dict(stamps or {}, program=t_build)
    phases, last = {}, t_start
    for name, t in marks_in.items():
        phases[name] = t - last
        last = t
    net = connectivity.build_network(spec, seed=build_seed, outgoing=cfg.backend == "event",
                                     device=dev)
    eng = make_simulation(spec, cfg, net=net, build_seed=build_seed, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t_build
    tables_bytes = _tables_bytes(net)
    if tamper is not None:
        module, fn = tamper.split(":")
        eng = getattr(importlib.import_module(module), fn)(eng)
    block = simulate.Block(desc)

    cum = []      # per window: spikes so far per area (device)
    clock = _Clock(dev)

    def on_window(w, st):
        clock.mark()
        cum.append(st.spike_count.sum(1, dtype=torch.int64))

    state = eng.init()
    warm = int(traffic["warmup_windows"])
    if warm:
        state = schedule_lib.run_windows(eng, state, warm, on_window=on_window).state
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    phases["build"] = build_s
    phases["warm-up"] = setup_s - sum(phases.values())
    deadline = time.perf_counter() + seconds
    n_warm = len(cum)
    clock.mark()  # the timed window's start
    t_window = clock.host[-1]

    def timed(engine, st, n, stop=True):
        try:
            return schedule_lib.run_windows(
                engine, st, n, on_window=on_window,
                stop_requested=(lambda: time.perf_counter() >= deadline) if stop else None).state
        except faults.Preempted as exc:
            return exc.result.state

    trace_path = None
    n_traced = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        def traced_window(st, _window=eng.window):
            with record_function(trace_lib.WINDOW_SPAN):
                return _window(st)

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(trace_lib.SPAN):
                state = timed(dataclasses.replace(eng, window=traced_window), state,
                              int(traffic["trace_windows"]), stop=False)
        n_traced = len(cum) - n_warm
        fd, trace_path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
        os.close(fd)
        t_export = time.perf_counter()
        prof.export_chrome_trace(trace_path)
        deadline += time.perf_counter() - t_export  # the export is not part of the window
        del prof, traced_window  # the traced window holds the engine and its tables
        clock.mark()  # the untraced stretch's start
    state = timed(eng, state, 1 << 40)
    _sync(dev)
    n_timed = len(cum) - n_warm
    wall_s = clock.host[-1] - t_window
    # The untraced windows' times (all of them without a trace). Marks: the
    # warm-up's windows, the window's start, the traced windows and the
    # untraced stretch's start (with a trace), the untraced windows.
    first = n_warm + (n_traced + 1 if trace else 0)
    window_times = clock.seconds(first, len(clock.host) - 1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- the run's outputs, then the program's memory freed --------------------
    counts = torch.stack(cum).to("cpu")
    area_counts = torch.diff(counts, dim=0, prepend=torch.zeros_like(counts[:1]))
    run_out = {"spike_count": state.spike_count.clone(), "ring": state.ring.clone(),
               "area_counts": area_counts.to(dev)}
    for f in dataclasses.fields(state.neuron):
        run_out[f.name] = getattr(state.neuron, f.name).clone()
    overflow = int(state.overflow)
    n_windows = len(cum)
    del eng, state, cum
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------------
    t_ref = time.perf_counter()
    tables = judge.TableCheck(net, outgoing=True)
    alive = desc.alive(dev)
    if model == "ignore_and_fire":
        ref = simulate.iaf_outputs(desc, build_seed, block, n_windows, dev, on_draw=tables)
    else:
        simulate.for_each_draw(desc, build_seed, block, dev, tables)
    checks = {"tables_differ": tables.differ, "outgoing_differ": tables.outgoing_differ()}
    del tables, net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if model == "lif":
        csr = simulate.build_csr(desc, build_seed, dev)
        ref = simulate.lif_replay(desc, csr, drive_seed, n_windows, dev)
        del csr
    checks.update(judge.compare(run_out, ref, alive))
    checks["overflow"] = overflow
    ref_s = time.perf_counter() - t_ref

    summary = None
    if trace_path is not None:
        summary = trace_lib.summarize(trace_path)
        os.remove(trace_path)
    return dict(
        live_rows=alive.sum(1).tolist(), n_warm=n_warm, n_timed=n_timed, n_traced=n_traced,
        wall_s=wall_s, window_times=window_times.tolist(), setup_s=setup_s,
        build_s=build_s, tables_bytes=tables_bytes, peak_bytes=int(peak),
        checks=checks, trace=summary, area_counts=area_counts.numpy(), ref_s=ref_s,
        phases=phases,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")


# ---------------------------------------------------------------------------
# The metrics and the result line
# ---------------------------------------------------------------------------

def _context(cell: Cell, report: dict, desc: NetDesc, trace: bool):
    model = cell.traffic["engine"].get("neuron_model", "lif")
    n_warm, n_traced = report["n_warm"], report["n_traced"]
    areas = np.asarray(report["area_counts"], np.float64)

    def work(lo, hi):
        return work_lib.window_work(desc, model, areas[lo:hi], report["live_rows"],
                                    cycles_per_window=desc.d)

    window_times = np.asarray(report["window_times"])
    return types.SimpleNamespace(
        cell=cell, traffic=cell.traffic, desc=desc, kind=report["kind"],
        peaks=work_lib.peaks_for(report["kind"]), model_s_per_window=desc.d * desc.dt_ms * 1e-3,
        n_timed=report["n_timed"], n_traced=n_traced, wall_s=report["wall_s"],
        window_times=window_times, setup_s=report["setup_s"], build_s=report["build_s"],
        tables_bytes=report["tables_bytes"], peak_bytes=report["peak_bytes"],
        trace=report["trace"] if trace else None,
        work_traced=work(n_warm, n_warm + n_traced),
        work_untraced=work(n_warm + n_traced, n_warm + report["n_timed"]),
        untraced_wall_s=float(np.sum(window_times)))


def _result(cell: Cell, report: dict, *, trace: bool, platform: str) -> dict:
    desc = NetDesc.from_config(cell.config["network"])
    ctx = _context(cell, report, desc, trace)
    checks = {name: int(report["checks"].get(name, 0)) for name in judge.NAMES}
    correct = judge.passed(checks)
    metrics = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(name).read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    n = ctx.n_timed
    failed = 0 if correct else n  # a run whose outputs disagree fails as a whole
    device = {"platform": platform, "kind": ctx.kind, "count": 1,
              "memory_peak_bytes": ctx.peak_bytes}
    out = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
           "device": device}
    if trace and ctx.trace is not None:
        t = ctx.trace
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        out["breakdown"] = {"device_ops": top(t["device_ops"]), "idle_gaps": top(t["idle_gaps"])}
    out["checks"] = {name: {"value": checks[name], "limit": judge.LIMITS[name]}
                     for name in judge.NAMES}
    _log(f"windows: {len(report['area_counts'])} ({report['n_warm']} warm-up, "
         f"{n} timed, {report['n_traced']} traced); build {ctx.build_s:.3f} s; "
         f"reference {report['ref_s']:.3f} s; set-up "
         + ", ".join(f"{k} {v:.3f} s" for k, v in report["phases"].items()))
    for name in judge.NAMES:
        _log(f"check {name} {checks[name]} limit {judge.LIMITS[name]}")
    return out


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, tamper: str | None = None) -> dict:
    """Run ``cell`` and return the result line's object. ``tamper``
    (``"module:function"``, for the benchmark's own tests) maps the engine
    to a broken one before the run."""
    t_start = time.perf_counter() if t_start is None else t_start
    stamps = {"imports": time.perf_counter()}
    if int(cell.chips) != 1:
        raise NotImplementedError(f"{cell.name}: the harness runs one card, the cell asks for "
                                  f"{cell.chips}")
    if device == "cuda":
        from repro_torch.kernels import cuda as kcuda

        kcuda.build_all(tuple(k for k in kcuda.KERNELS if k != "flash_attention"))
    stamps["kernels"] = time.perf_counter()
    report = _body(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                   t_start=t_start, tamper=tamper, stamps=stamps)
    return _result(cell, report, trace=trace, platform="gpu" if device == "cuda" else "cpu")
