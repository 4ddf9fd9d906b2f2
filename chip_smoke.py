#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc``, in
   parallel;
3. full width, the main path: the paper's per-area size and in-degree
   (``mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000,
   k_inter=3000)``, build seed 12; 4 areas instead of 32 so the 28 GB of
   tables fit one card), built on the device, then ``make_simulation`` on the
   ``pallas`` backend, 1 + 5 windows each: ignore-and-fire (2.5 Hz) under
   the conventional schedule, the structure-aware one and the structure-aware
   one with the fused superstep kernel (``superstep_kernel=True``), bitwise
   equal to each other window by window; LIF under the structure-aware
   schedule, unfused and fused, bitwise equal window by window. Launches per
   window are asserted exactly; the kernels' launch counts are reset just
   before and read just after, and every kernel's must be > 0;
4. each kernel against its plain PyTorch version on the card, bitwise, at
   the main path's shapes, and timed (CUDA events after an L2 flush; median
   of 100 launches for lif_update, 20 for spike_deliver, 10 for the
   superstep kernels) beside its memory bound;
5. the port on the card against the port on the CPU at the quickstart size
   (4 x 256 neurons, K 32/32), ``pallas`` backend, ignore-and-fire (30 Hz)
   and LIF under both schedules and fused, 10 windows, bitwise.

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

    def engine(model, sched="structure_aware", **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model=model, schedule=sched, delivery_backend="pallas", **kw), net=net)

    def keep(store):
        return lambda w, st, blk: store.append((blk.clone(), st.ring.clone()))

    def same_as(store, what):
        def check(w, st, blk):
            blk_0, ring_0 = store[w]
            if not (bitwise_equal(blk, blk_0) and bitwise_equal(st.ring, ring_0)):
                raise AssertionError(f"{what} differ at window {w}")
        return check

    def expect(per, name, **nonzero):
        want = {k: float(nonzero.get(k, 0)) for k in cuda.KERNELS}
        if per != want:
            raise AssertionError(f"{name}: launches per window {per}, expected {want}")

    def report(name, ms, per, st):
        log(f"[full] {name}: {ms:.2f} ms/window, real-time factor {ms / model_ms:.1f}, "
            f"launches/window {per}, {int(st.spike_count.sum())} spikes")

    cuda.reset_launches()
    # The conventional run keeps each window's block and ring; the
    # structure-aware runs, unfused and fused, must reproduce them bitwise.
    iaf = {"conventional": engine("ignore_and_fire", "conventional"),
           "structure_aware": engine("ignore_and_fire"),
           "structure_aware fused": engine("ignore_and_fire", superstep_kernel=True)}
    blocks = []
    runs = {"conventional": timed_windows(
        iaf["conventional"], iaf["conventional"].init(), 5, check=keep(blocks))}
    for name in ("structure_aware", "structure_aware fused"):
        runs[name] = timed_windows(iaf[name], iaf[name].init(), 5,
                                   check=same_as(blocks, f"iaf conventional and {name}"))
    del blocks
    st_c = runs["conventional"][0]
    for name, (st, ms, per) in runs.items():
        if int(st.spike_count.sum()) <= 0 or not state_equal(st_c, st):
            raise AssertionError(f"full width iaf {name}: no spikes, or final state differs")
        report(f"ignore_and_fire {name}", ms, per, st)
    expect(runs["conventional"][2], "iaf conventional", spike_deliver=20)
    expect(runs["structure_aware"][2], "iaf structure_aware", spike_deliver=20)
    expect(runs["structure_aware fused"][2], "iaf fused", spike_deliver=10, superstep_iaf=1)
    log("[full] ignore_and_fire conventional == structure_aware == fused bitwise over "
        "6 windows (spike blocks, rings, states)")
    del runs, st_c

    # LIF: the unfused structure-aware run keeps its blocks and rings, the
    # fused run must reproduce them and the final state bitwise.
    lif = {"structure_aware": engine("lif"),
           "structure_aware fused": engine("lif", superstep_kernel=True)}
    blocks = []
    st_u, ms_u, per_u = timed_windows(lif["structure_aware"], lif["structure_aware"].init(),
                                      5, check=keep(blocks))
    st_f, ms_f, per_f = timed_windows(lif["structure_aware fused"],
                                      lif["structure_aware fused"].init(), 5,
                                      check=same_as(blocks, "lif unfused and fused"))
    del blocks
    if not bool(torch.isfinite(st_f.neuron.v).all()) or not bool(torch.isfinite(st_f.ring).all()):
        raise AssertionError("LIF state is not finite")
    if not state_equal(st_u, st_f):
        raise AssertionError("full width LIF: fused final state != unfused")
    report("lif structure_aware", ms_u, per_u, st_u)
    report("lif structure_aware fused", ms_f, per_f, st_f)
    expect(per_u, "lif structure_aware", lif_update=10, spike_deliver=20)
    expect(per_f, "lif fused", spike_deliver=10, superstep_lif=1)
    log("[full] lif unfused == fused bitwise over 6 windows (spike blocks, rings, states)")
    launches = dict(cuda.launches)
    log(f"[full] main-path launches {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    for name, eng in lif.items():
        profile_window(f"lif {name}", eng, st_f)
    for name, eng in iaf.items():
        profile_window(f"ignore_and_fire {name}", eng, eng.window(eng.init())[0])
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
    rows += _superstep_rows(net, launches, rng, flush)
    return rows


def _superstep_rows(net, launches: dict, rng, flush) -> list[dict]:
    """The fused superstep kernels against their plain versions on the
    full-width intra tables, with states drawn so that many lanes spike."""
    import numpy as np
    import torch

    from repro_torch.core.neuron import LIFParams
    from repro_torch.kernels import cycle as cyc

    dev = net.device
    a, n, k = net.src_intra.shape
    d_win, lo, span = net.delay_ratio, net.steps_lo_intra, net.r_span_intra
    tables = (net.src_intra, net.w_intra, net.delay_intra)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    # On the 1/256 grid, without -0.0: the engine's rings never hold one
    # (csrc/deposit.cuh), and a row that receives nothing keeps its zeros.
    fut0 = t((np.round(rng.normal(0, 300, (a, n, net.live_window)) * 4) / 1024 + 0.0)
             .astype(np.float32))
    scratch = fut0.clone()  # timing runs deposit into it, in place
    delay_b = net.delay_intra.element_size()
    src_bytes = n * k * 4  # one area's rows of src
    fut_bytes = 2 * 4 * a * n * net.live_window  # fut read and written once
    rows = []

    def check_and_time(name, kernel, plain, args, kw):
        got = kernel(*args(fut0.clone()), **kw)
        want = plain(*args(fut0.clone()), **kw)
        if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
            again = kernel(*args(fut0.clone()), **kw)
            raise AssertionError(
                f"{name} kernel != plain version: elements that differ "
                f"{[int((g != w).sum()) for g, w in zip(got, want)]}; a second launch "
                f"{'agrees' if all(map(bitwise_equal, got, again)) else 'differs'}")
        err = max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))
        ms = time_ms(lambda: kernel(*args(scratch), **kw), reps=10, flush=flush)
        plain_ms = time_ms(lambda: plain(*args(scratch), **kw), reps=10, flush=flush)
        return want, err, ms, plain_ms

    # LIF: membrane potentials spread below threshold and strong synaptic
    # currents, so neurons cross threshold in every cycle of the window.
    p = LIFParams()
    state = (t(rng.uniform(0, 15, (a, n)).astype(np.float32)),
             t(rng.normal(6000, 2000, (a, n)).astype(np.float32)),
             t(rng.integers(0, 25, (a, n)).astype(np.int32)))
    drive_p = t(rng.uniform(0, 0.5, (a, n)).astype(np.float32))
    gids = torch.arange(a * n, dtype=torch.int32, device=dev).view(a, n)
    kw = dict(d_win=d_win, steps_lo=lo, r_span=span, p11=p.p11, p21=p.p21, p22=p.p22,
              v_th=p.v_th_mv, v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps,
              seed=42, w_ext=87.75)
    want, err, ms, plain_ms = check_and_time(
        "superstep_lif", cyc.superstep_lif_cuda, cyc.superstep_lif_plain,
        lambda fut: (*state, fut, drive_p, gids, net.alive, *tables, 1230), kw)
    spikes = want[4]
    per_cycle = [int(x) for x in spikes.sum(dim=(1, 2))]
    if min(per_cycle) <= 0:
        raise AssertionError(f"superstep_lif check: a cycle without spikes {per_cycle}")
    # Bytes this data needs: per cycle, src of every area that spiked, w and
    # delay of the synapses whose source spiked; the state (21 B in, 12 B out
    # per neuron), the spikes and fut once.
    areas = int(spikes.any(dim=2).sum())
    active = sum(_active_synapses(spikes[s].reshape(-1).float(), net.src_intra.view(a * n, k),
                                  n) for s in range(d_win))
    nbytes = areas * src_bytes + active * (4 + delay_b) + a * n * (33 + d_win) + fut_bytes
    bound_ms = max(nbytes / HBM_BYTES_PER_S, active / F32_OPS_PER_S) * 1e3
    log(f"[kernel] superstep_lif [{a}, {n}, {k}] D {d_win} W {net.live_window}: bitwise == "
        f"plain; spikes per cycle {per_cycle}, {active} active synapse-cycles; {ms:.3f} ms "
        f"(bound {bound_ms:.3f} ms by bytes, {nbytes / ms / 1e6:.0f} GB/s of needed bytes), "
        f"plain {plain_ms:.3f} ms")
    rows.append(dict(
        name="superstep_lif", route="cuda", source="src/repro_torch/kernels/csrc/superstep_lif.cu",
        replaces="src/repro/kernels/cycle.py:131", launches=launches["superstep_lif"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None, checked=True))

    # Ignore-and-fire: phases spread over 200 cycles, intervals of 1-12, so
    # ~5% of the neurons fire in the window, some of them several times.
    countdown = t(rng.integers(0, 200, (a, n)).astype(np.int32))
    interval = t(rng.integers(1, 13, (a, n)).astype(np.int32))
    kw = dict(d_win=d_win, steps_lo=lo, r_span=span)
    want, err, ms, plain_ms = check_and_time(
        "superstep_iaf", cyc.superstep_iaf_cuda, cyc.superstep_iaf_plain,
        lambda fut: (countdown, fut, interval, net.alive, *tables), kw)
    spikes = want[2]
    per_cycle = [int(x) for x in spikes.sum(dim=(1, 2))]
    if min(per_cycle) <= 0:
        raise AssertionError(f"superstep_iaf check: a cycle without spikes {per_cycle}")
    # Bytes: all of src once; w, delay and the source's pattern of every
    # synapse whose source spiked in the window; the state (13 B per
    # neuron), the spikes and fut once.
    fired = spikes.any(dim=0).reshape(-1).float()
    active = _active_synapses(fired, net.src_intra.view(a * n, k), n)
    nbytes = a * src_bytes + active * (8 + delay_b) + a * n * (13 + d_win) + fut_bytes
    bound_ms = max(nbytes / HBM_BYTES_PER_S, active / F32_OPS_PER_S) * 1e3
    log(f"[kernel] superstep_iaf [{a}, {n}, {k}] D {d_win}: bitwise == plain; spikes per "
        f"cycle {per_cycle}, {active} active synapses; {ms:.3f} ms (bound {bound_ms:.3f} ms "
        f"by bytes, {nbytes / ms / 1e6:.0f} GB/s of needed bytes), plain {plain_ms:.3f} ms")
    rows.append(dict(
        name="superstep_iaf", route="cuda", source="src/repro_torch/kernels/csrc/superstep_iaf.cu",
        replaces="src/repro/kernels/cycle.py:183", launches=launches["superstep_iaf"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None, checked=True))
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
        for sched, fused in (("conventional", False), ("structure_aware", False),
                             ("structure_aware", True)):
            cfg = EngineConfig(neuron_model=model, schedule=sched, delivery_backend="pallas",
                               superstep_kernel=fused)
            sched += " fused" if fused else ""
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
