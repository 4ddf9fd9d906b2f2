#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, in parallel;
3. full width, the main path: the paper's per-area size and in-degree
   (``mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000,
   k_inter=3000)``, build seed 12; 4 areas instead of 32 so the 28 GB of
   tables fit one card), built on the device, then ``make_simulation`` on the
   ``pallas`` backend: ignore-and-fire (2.5 Hz) under both schedules for 1 + 5
   windows, bitwise equal to each other, and LIF under the structure-aware
   schedule for 1 + 5 windows. The kernels' launch counts are reset just
   before and read just after, and both must be > 0;
4. each kernel against its plain PyTorch version on the card, bitwise, at
   the main path's shapes, and timed (CUDA events; median of 100 launches
   for lif_update, 20 for spike_deliver) beside its memory bound;
5. the port on the card against the port on the CPU at the quickstart size
   (4 x 256 neurons, K 32/32), ``pallas`` backend, ignore-and-fire (30 Hz)
   and LIF under both schedules, 10 windows, bitwise.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2


def log(*args) -> None:
    print(*args, flush=True)


def bitwise_equal(a, b) -> bool:
    """Same dtype, shape and bytes (so -0.0 != +0.0 and NaNs compare), on
    ``a``'s device."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_bytes = lambda x: x.contiguous().view(torch.uint8)  # noqa: E731
    return bool(torch.equal(as_bytes(a), as_bytes(b.to(a.device))))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def time_ms(fn, *, reps: int = 20, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    after 3 warm-up launches."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def state_equal(a, b) -> bool:
    import dataclasses

    leaves = [(a.ring, b.ring), (a.spike_count, b.spike_count)] + [
        (getattr(a.neuron, f.name), getattr(b.neuron, f.name))
        for f in dataclasses.fields(a.neuron)]
    return a.t == b.t and all(bitwise_equal(x, y) for x, y in leaves)


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}: {name}")
    log(smi.splitlines()[0])  # nvidia-smi's name and power limit, as it prints them
    return dict(platform="gpu", kind=name, count=torch.cuda.device_count())


def phase_build() -> None:
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    seconds = cuda.build_all()
    log(f"[build] {len(seconds)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    for name, out in cuda.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_main_path(spec) -> tuple[object, dict]:
    """Build the full-width network and drive the engine; returns the network
    and the main path's launch counts."""
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation
    from repro_torch.kernels import cuda

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_network(spec, seed=12)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table_gb = sum(getattr(net, f).numel() * getattr(net, f).element_size()
                   for f in ("src_intra", "w_intra", "delay_intra",
                             "src_inter", "w_inter", "delay_inter")) / 1e9
    log(f"[full] network {spec.n_areas} x {net.n_pad}, K {net.k_intra}/{net.k_inter}, "
        f"D {net.delay_ratio}, ring {net.ring_len}, intra window "
        f"[{net.steps_lo_intra}, +{net.r_span_intra}), inter window "
        f"[{net.steps_lo_inter}, +{net.r_span_inter}); built on {net.device} in "
        f"{build_s:.2f} s, tables {table_gb:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    model_ms = net.delay_ratio * net.dt_ms

    def timed_windows(eng, st, n, check=None):
        """1 warm-up + n timed windows (host clock around each window, which
        ends in a synchronize); ``check`` runs outside the timing. Returns
        the state, ms/window (mean) and kernel launches per window."""
        times = []
        for w in range(n + 1):
            if w == 1:
                before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, blk = eng.window(st)
            torch.cuda.synchronize()
            if w:
                times.append(time.perf_counter() - t0)
            if check:
                check(w, st, blk)
        per = {k: (cuda.launches[k] - before[k]) / n for k in before}
        return st, 1e3 * sum(times) / n, per

    cuda.reset_launches()
    engines = {s: make_simulation(spec, EngineConfig(
        neuron_model="ignore_and_fire", schedule=s, delivery_backend="pallas"), net=net)
        for s in ("conventional", "structure_aware")}
    # The conventional run keeps each window's block and ring; the
    # structure-aware run must reproduce them bitwise, window by window.
    st_c, st_s = engines["conventional"].init(), engines["structure_aware"].init()
    blocks_c = []
    st_c, ms_c, per_c = timed_windows(
        engines["conventional"], st_c, 5,
        check=lambda w, st, blk: blocks_c.append((blk.clone(), st.ring.clone())))

    def same_as_conventional(w, st, blk):
        blk_c, ring_c = blocks_c[w]
        if not (bitwise_equal(blk, blk_c) and bitwise_equal(st.ring, ring_c)):
            raise AssertionError(f"schedules differ at window {w}")

    st_s, ms_s, per_s = timed_windows(
        engines["structure_aware"], st_s, 5, check=same_as_conventional)
    del blocks_c
    spikes = int(st_s.spike_count.sum())
    if spikes <= 0 or not state_equal(st_c, st_s):
        raise AssertionError(f"full width: spikes {spikes}, or final states differ")
    for sched, ms, per in (("conventional", ms_c, per_c), ("structure_aware", ms_s, per_s)):
        log(f"[full] ignore_and_fire {sched}: {ms:.2f} ms/window, real-time factor "
            f"{ms / model_ms:.1f}, launches/window {per}")
    log(f"[full] conventional == structure_aware bitwise over 6 windows "
        f"(spike blocks, rings, states); {spikes} spikes")
    del st_c, st_s, engines

    eng = make_simulation(spec, EngineConfig(
        neuron_model="lif", schedule="structure_aware", delivery_backend="pallas"), net=net)
    st, ms_l, per_l = timed_windows(eng, eng.init(), 5)
    if not bool(torch.isfinite(st.neuron.v).all()) or not bool(torch.isfinite(st.ring).all()):
        raise AssertionError("LIF state is not finite")
    log(f"[full] lif structure_aware: {ms_l:.2f} ms/window, real-time factor "
        f"{ms_l / model_ms:.1f}, launches/window {per_l}, "
        f"{int(st.spike_count.sum())} spikes")
    if per_l != {"lif_update": 10.0, "spike_deliver": 20.0}:
        raise AssertionError(f"unexpected launches per structure-aware LIF window: {per_l}")
    launches = dict(cuda.launches)
    log(f"[full] main-path launches {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    profile_window("lif structure_aware", eng, st)
    for sched in ("conventional", "structure_aware"):
        eng = make_simulation(spec, EngineConfig(
            neuron_model="ignore_and_fire", schedule=sched, delivery_backend="pallas"), net=net)
        profile_window(f"ignore_and_fire {sched}", eng, eng.window(eng.init())[0])
    return net, launches


def profile_window(name, eng, st) -> None:
    """Device time by kernel over one window (torch.profiler), and the share
    of the window's wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.window(st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    log(f"[profile] {name}: window {wall_us / 1e3:.2f} ms wall, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} kernel kinds")
    for us, count, key in kernels[:6]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def phase_kernels(net, launches: dict) -> list[dict]:
    """Each kernel against its plain version on the card, and timed."""
    import numpy as np
    import torch

    from repro_torch.kernels import lif_update as lif
    from repro_torch.kernels import spike_deliver as dlv
    from repro_torch.core.neuron import LIFParams

    dev = net.device
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []

    # lif_update at the main path's N, state around threshold with refractory lanes.
    n = net.alive.numel()
    p = LIFParams()
    kw = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
              v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps)
    args = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.normal(14.0, 2.0, n).astype(np.float32),
        rng.normal(0.0, 300.0, n).astype(np.float32),
        rng.integers(0, 4, n).astype(np.int32),
        rng.normal(0.0, 200.0, n).astype(np.float32),
        rng.random(n) < 0.95))
    got = lif.lif_update_cuda(*args, **kw)
    want = lif.lif_update_plain(*args, **kw)
    if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("lif_update kernel != plain version")
    err = max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))
    ms = time_ms(lambda: lif.lif_update_cuda(*args, **kw), reps=100, flush=flush)
    plain_ms = time_ms(lambda: lif.lif_update_plain(*args, **kw), reps=100, flush=flush)
    nbytes = 30 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 6 * n / F32_OPS_PER_S) * 1e3
    log(f"[kernel] lif_update N={n}: bitwise == plain; {ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by bytes, {nbytes / ms / 1e6:.0f} GB/s), "
        f"plain {plain_ms:.4f} ms")
    rows.append(dict(
        name="lif_update", route="cuda", source="src/repro_torch/kernels/csrc/lif_update.cu",
        replaces="src/repro/kernels/lif_update.py:77", launches=launches["lif_update"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None, checked=True))

    # spike_deliver on the full tables, spike vector at ~1% density.
    a, n_pad = net.alive.shape
    spikes = torch.from_numpy((rng.random(a * n_pad) < 0.01).astype(np.float32)).to(dev)
    timings = {}
    for pathway in ("intra", "inter"):
        k = getattr(net, f"k_{pathway}")
        src = getattr(net, f"src_{pathway}").view(a * n_pad, k)
        w = getattr(net, f"w_{pathway}").view(a * n_pad, k)
        delay = getattr(net, f"delay_{pathway}").view(a * n_pad, k)
        kw = dict(steps_lo=getattr(net, f"steps_lo_{pathway}"),
                  r_span=getattr(net, f"r_span_{pathway}"))
        if pathway == "intra":
            kw.update(rows_per_area=n_pad, src_stride=n_pad)
        got = dlv.spike_deliver_cuda(spikes, src, w, delay, **kw)
        want = dlv.spike_deliver_plain(spikes, src, w, delay, **kw)
        if not bitwise_equal(got, want):
            raise AssertionError(f"spike_deliver ({pathway}) kernel != plain version")
        err = max_abs_err(got, want)
        ms = time_ms(lambda: dlv.spike_deliver_cuda(spikes, src, w, delay, **kw))
        plain_ms = time_ms(lambda: dlv.spike_deliver_plain(spikes, src, w, delay, **kw))
        # Bytes this data needs: all of src, w and delay of the synapses whose
        # source spiked, the spike vector and the output.
        active = _active_synapses(spikes, src, n_pad if pathway == "intra" else None)
        nbytes = (src.numel() * 4 + active * (4 + delay.element_size())
                  + spikes.numel() * 4 + got.numel() * 4)
        dense_bytes = src.numel() * (8 + delay.element_size()) + got.numel() * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * active / F32_OPS_PER_S) * 1e3
        log(f"[kernel] spike_deliver {pathway} [{a * n_pad}, {k}] r_span {kw['r_span']}: "
            f"bitwise == plain; {active} active synapses; {ms:.3f} ms (bound "
            f"{bound_ms:.3f} ms by bytes, {nbytes / ms / 1e6:.0f} GB/s of needed bytes; "
            f"all-table bound {dense_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms), "
            f"plain {plain_ms:.3f} ms")
        timings[pathway] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, err=err)
    # One row for the kernel, at the inter call (the larger delay window);
    # the intra call's numbers are on the line above.
    t = timings["inter"]
    rows.append(dict(
        name="spike_deliver", route="cuda",
        source="src/repro_torch/kernels/csrc/spike_deliver.cu",
        replaces="src/repro/kernels/spike_deliver.py:63",
        launches=launches["spike_deliver"], max_abs_err=max(
            timings["intra"]["err"], t["err"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes", library_ms=None, checked=True,
        intra=dict(ms=timings["intra"]["ms"], plain_ms=timings["intra"]["plain_ms"],
                   bound_ms=timings["intra"]["bound_ms"])))
    return rows


def _active_synapses(spikes, src, rows_per_area) -> int:
    """Synapses whose source spike is nonzero (row chunks)."""
    import torch

    total, n = 0, src.shape[0]
    for r0 in range(0, n, 65536):
        r1 = min(n, r0 + 65536)
        idx = src[r0:r1].long()
        if rows_per_area is not None:
            area = torch.arange(r0, r1, device=src.device) // rows_per_area
            idx = idx + (area * rows_per_area)[:, None]
        total += int((spikes[idx] != 0).sum())
    return total


def phase_device_vs_cpu() -> dict:
    """The port on the card against the port on the CPU, bitwise."""
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.kernels import cuda

    cuda.reset_launches()
    for model, rate in (("ignore_and_fire", 30.0), ("lif", 2.5)):
        spec = mam_benchmark_spec(n_areas=4, n_per_area=256, k_intra=32, k_inter=32,
                                  rate_hz=rate)
        nets = {d: build_network(spec, seed=12, device=d) for d in ("cuda", "cpu")}
        for f in ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra",
                  "src_inter", "w_inter", "delay_inter"):
            if not bitwise_equal(getattr(nets["cuda"], f), getattr(nets["cpu"], f)):
                raise AssertionError(f"device-built {f} != CPU-built {f}")
        for sched in ("conventional", "structure_aware"):
            cfg = EngineConfig(neuron_model=model, schedule=sched, delivery_backend="pallas")
            engs = {d: make_simulation(spec, cfg, net=nets[d], device=d) for d in nets}
            st = {d: e.init() for d, e in engs.items()}
            for w in range(10):
                blk = {}
                for d, e in engs.items():
                    st[d], blk[d] = e.window(st[d])
                if not (bitwise_equal(blk["cuda"], blk["cpu"])
                        and state_equal(st["cuda"], st["cpu"])):
                    raise AssertionError(f"{model} {sched}: cuda != cpu at window {w}")
            log(f"[cpu] {model} {sched}: cuda == cpu bitwise over 10 windows "
                f"(blocks, ring, neuron state, spike_count); "
                f"{int(st['cpu'].spike_count.sum())} spikes")
    counts = dict(cuda.launches)
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the cuda runs: {counts}")
    log(f"[cpu] kernel launches in the cuda runs {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import mam_benchmark_spec

    device = phase_device()
    phase_build()
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    net, launches = phase_main_path(spec)
    rows = phase_kernels(net, launches)
    del net
    torch.cuda.empty_cache()
    phase_device_vs_cpu()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
