#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the six CUDA kernels from ``src/repro_torch/kernels/csrc``, and
   the event scatter with each of its regimes forced, in parallel;
3. full width, the main path: the paper's per-area size and in-degree
   (``mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000,
   k_inter=3000)``, build seed 12; 4 areas instead of 32 so the tables fit
   one card), built on the device with its incoming tables (28 GB) and the
   outgoing tables the event backend reads (``add_outgoing_tables``, the
   inversion of ``build_network(outgoing=True)``, timed on its own line; ~31
   GB), every outgoing row checked to ascend with its -1 padding at the end
   (the event kernel's precondition; in row chunks). Then
   ``make_simulation`` on the ``pallas`` backend, 1 + 5 windows each:
   ignore-and-fire (2.5 Hz) under the conventional schedule, the
   structure-aware one and the structure-aware one with the fused superstep
   kernel (``superstep_kernel=True``), bitwise equal to each other window by
   window; LIF under the structure-aware schedule, unfused and fused,
   bitwise equal window by window, from the state after 18 untimed
   windows, when the areas have begun to spike (``LIF_RAMP_WINDOWS``).
   Launches per window are asserted exactly; the kernels' launch counts are
   reset just before and read just after, and every kernel of the path must
   have launched. Each run's window is then profiled (torch.profiler): the
   six longest kernels and every port kernel that ran, with device time and
   count;
4. ``[event]`` the same configurations on the ``event`` backend (the
   ``event_deliver`` kernel), on the same network, 1 + 5 windows each, every
   one bitwise the matching ``pallas`` run's spike blocks and rings window by
   window with ``overflow == 0``: ignore-and-fire conventional,
   structure-aware, legacy (``superstep=False``), fused, adaptive, and
   adaptive + overlap through ``run_windows`` (one drain); LIF unfused with
   ``fused_update=True`` and fused. Launches per window asserted exactly
   (counts reset just before the event runs, read just after), ms/window
   beside the ``pallas`` run's, the peak memory, and the profile of one
   window of the unfused and the fused iaf event runs;
   ``[steady]`` LIF at its steady state (~70 Hz, from window 40): the
   fused pallas run and the adaptive event runs, unfused and fused, bitwise
   the unfused pallas run window by window with ``overflow == 0``, launches
   per window asserted, ms/window; one window of each adaptive event run
   profiled, with ``event_deliver``'s share of the device's busy time; and
   the spikes the static event packets drop in one window at this rate;
5. ``[kernel]`` event_deliver against its plain version, bitwise, on the
   packets the engine makes from the iaf runs' last window (2.5 Hz, static
   packets) and from the steady LIF runs' last window (~70 Hz, the adaptive
   ladders' rungs), inter and the busiest cycle's intra, and on both
   windows' inter packets with every padding case; timed beside its bound
   (the tables' bytes and 64 B per distinct ring sector touched), the
   ceiling of one reduction a synapse at the L2's RED rate (measured here
   by ``red_probe``), the earlier bound (32 B of ring a synapse), the plain
   version (3 windows at the steady size) and the gather + ``index_add_``
   of the same adds; then both of the kernel's regimes (builds that force
   each) beside its own choice, bitwise and timed, on packets thinned to
   0.5-15 adds per ring sector; then the outgoing tables are freed;
6. each pallas-path kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shapes (superstep_iaf also at the main path's
   2.5 Hz), and timed beside its memory bound: median of 100 windows for
   lif_update, 20 for spike_deliver and event_deliver (10 for the library
   call at the steady size), 10 for the superstep kernels, each window an
   L2 flush, a start event, the call and an end
   event. The windows are enqueued in batches behind a device spin that
   outlasts the host's enqueue of the batch, so the device never waits for
   the host inside a window; an event after the spin checks that, and the
   timer raises if it cannot hold (``time_ms``). Plain versions whose
   enqueue blocks on the launch queue are timed host-paced, with a
   ``[timer]`` line. lif_update is also timed host-paced, the timer of
   earlier runs, and its per-launch device time in the profiled LIF window
   is printed;
7. the port on the card against the port on the CPU at the quickstart size
   (4 x 256 neurons, K 32/32), bitwise over 10 windows (40 for LIF, which
   first spikes in window 18 at this size), ``overflow`` included:
   ignore-and-fire (30 Hz) and LIF on ``pallas`` (both schedules and
   fused) and on ``event`` (both schedules, legacy, fused, adaptive,
   adaptive + overlap), and ignore-and-fire at 2000 Hz with forced overflow
   (``s_max_headroom=0, s_max_floor=1``);

then, with the simulator's tables freed, the LM path (weights drawn on the
card from seed 0, f32 products in f32):

8. ``[lm]`` qwen2-0.5b at its published width and dtypes (bf16), B 2 x S
   4096 with ``use_pallas_attention=True``: 1 warm-up + 3 timed forwards,
   exactly 24 ``flash_attention`` launches each (counts reset just before,
   read just after), finite logits, and the profile of one forward;
9. ``[lm]`` the same model in f32: the kernel against the streaming path
   (<= 1e-4 of the largest logit), and prefill of 4096 tokens + decode of
   token 4096 against the forward of the 5120-token sequence (<= 5e-4);
10. ``[lm]`` serving at the published dtypes through
   ``repro_torch.serve_lm.serve``: batch 4, 4096-token prompts, 32 tokens
   (prefill attends with a cache, so no kernel launch);
11. ``[lm]`` h2o-danube-1.8b, bf16, B 1 x S 8192 (its 4096 window cuts in):
   24 launches per forward; in f32, kernel against streaming (<= 1e-4);
12. ``[kernel]`` flash_attention against its plain version at qwen2's and
    danube's shapes and with k_len < S (f32: max abs <= 2e-5; bf16: one bf16
    ulp of the plain output's largest magnitude, and per element one bf16 ulp
    of the larger of the two values + 2e-5, the card tests' bar, which
    ``scaled_dot_product_attention`` must fail at qwen2's shape: it rounds P
    to bf16), timed (as in 6, median of 20) beside its bound, the plain
    version and SDPA (the library time, and its own error);
    the bf16 route runs on the tensor cores, the f32 route (timed at qwen2's
    shape) on the CUDA cores; the tensor-core kernel's wgmma and TMA
    instructions counted in its SASS (none fails the run), its registers,
    spills and shared memory from the build report;
13. ``[cpu]`` reduced qwen2-0.5b in f32 on the card against the CPU, with
    ``FLASH_THRESHOLD`` lowered so the forward runs the kernel: the forward
    (<= 1e-4) and prefill + 4 decode steps (<= 5e-4).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
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
SIM_KERNELS = ("lif_update", "spike_deliver", "superstep_lif", "superstep_iaf",
               "event_deliver")
PALLAS_PATH_KERNELS = SIM_KERNELS[:4]
EVENT_PATH_KERNELS = ("lif_update", "superstep_lif", "superstep_iaf", "event_deliver")
# LIF at full width (seed 12) first spikes in window 11, ramps up and
# outgrows the static event packets (276 ids an area, 1,104 a cycle) in
# window 25, and fires ~36,000 spikes a window (~70 Hz) from window ~30 on
# (the untimed windows' lines of this script show it). Its main-path runs
# start after LIF_RAMP_WINDOWS windows, so that their 1 + 5 windows carry
# spikes within the packets; the steady-state runs after LIF_STEADY_WINDOWS.
LIF_RAMP_WINDOWS = 18
LIF_STEADY_WINDOWS = 40
INCOMING = ("src_intra", "w_intra", "delay_intra", "src_inter", "w_inter", "delay_inter")
OUTGOING = ("tgt_intra", "wout_intra", "dout_intra", "tgt_inter", "wout_inter", "dout_inter")
# The port's kernel functions (csrc/*.cu), as the profiler names them: every
# one that ran in a profiled window gets a [profile] line.
PORT_KERNEL_SYMBOLS = ("lif_update_kernel", "pack_spikes", "spike_deliver_kernel",
                       "superstep_lif_kernel", "iaf_spikes", "iaf_deposit",
                       "flash_attention_kernel", "flash_attention_tc",
                       "event_deliver_kernel")


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


SPIN_CYCLES_PER_S = 2.0e9   # above the H100's clocks, so a spin lasts at least as asked
MAX_SPIN_S = 4.0
TIMER_BATCH = 25            # windows behind one spin: bounds the launch queue's depth


def _enqueue_windows(fn, reps: int, flush) -> list:
    """Enqueue ``reps`` x (L2 flush, start event, ``fn()``, end event)."""
    import torch

    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    return pairs


def time_ms_host_paced(fn, *, reps: int = 20, flush=None) -> float:
    """The earlier timer of this script: each window enqueued and
    synchronized in turn, so the device waits inside a window for whatever
    host work ``fn`` does before its launch. Kept to show that effect, and
    for functions :func:`time_ms` cannot hold behind a spin."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        ((start, end),) = _enqueue_windows(fn, 1, flush)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gated_batch(fn, reps: int, flush, spin_s: float) -> list[float] | None:
    """``reps`` windows enqueued behind a device spin of ``spin_s``; their
    times, or None if the device got past the spin before the host had
    enqueued the last window."""
    import torch

    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    gate = torch.cuda.Event()
    gate.record()
    pairs = _enqueue_windows(fn, reps, flush)
    early = gate.query()
    torch.cuda.synchronize()
    return None if early else [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, *, reps: int = 20, flush=None, host_paced_ok: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` windows (CUDA events), with
    no host time inside a window.

    Three warm-up windows give the host's time to enqueue one window. The
    windows are then enqueued in batches of at most ``TIMER_BATCH``, each
    behind a device spin (``torch.cuda._sleep``) of 1.5x the batch's enqueue
    time plus 1 ms, and the host synchronizes after each batch. An event
    recorded right after the spin tells whether the device got past it
    before the host had enqueued the batch's last window: then the device
    may have waited for the host inside a window, so the spin is made 4x
    longer and the batch repeated once; if the device is still too early,
    this raises. A function whose enqueue blocks on the launch queue
    (hundreds of launches per call, as some plain versions) cannot be held
    behind a spin: with ``host_paced_ok`` its time is taken by
    :func:`time_ms_host_paced` instead, and a ``[timer]`` line says so.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _enqueue_windows(fn, 3, flush)
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        batch = min(TIMER_BATCH, reps - len(times))
        spin_s = 1.5 * batch * host_s + 1e-3
        got, what = None, f"{batch} windows take {batch * host_s:.3f} s to enqueue"
        for _ in range(2):
            if spin_s > MAX_SPIN_S:
                break
            got = _gated_batch(fn, batch, flush, spin_s)
            if got is not None:
                break
            what = (f"the device got past a {spin_s * 1e3:.1f} ms spin before the host "
                    f"had enqueued {batch} windows")
            spin_s *= 4
        if got is None:
            if not host_paced_ok:
                raise RuntimeError(f"time_ms: {what}; host time would land in the windows")
            log(f"[timer] {what}: host-paced timer for this function")
            return time_ms_host_paced(fn, reps=reps, flush=flush)
        times += got
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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cuda
    from repro_torch.kernels.event_deliver import REGIMES

    t0 = time.perf_counter()
    # The event scatter's two forced-regime builds (for [kernel]'s regime
    # lines) start with the others.
    with ThreadPoolExecutor(1 + len(REGIMES)) as pool:
        variants = [pool.submit(cuda.build_all, ("event_deliver",), d) for d in REGIMES.values()]
        seconds = cuda.build_all()
        variant_s = [v.result() for v in variants]
    log(f"[build] {len(seconds)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}); event_deliver "
        f"with its regime forced: "
        f"{', '.join(f'{r} {sum(v.values()):.1f} s' for r, v in zip(REGIMES, variant_s))}")
    for name, out in cuda.build_logs.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:40]  # the mangled name names the instantiation
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {entry}: {line.strip()}")


def phase_build_network(spec):
    """The full-width network with its incoming and outgoing tables, built on
    the card: ``build_network(spec, seed=12)``, then the inversion that
    ``build_network(..., outgoing=True)`` runs (``add_outgoing_tables``),
    timed on its own line."""
    import torch

    from repro_torch.core import build_network
    from repro_torch.core.connectivity import (
        _outgoing_k_bound, add_outgoing_tables, check_outgoing_order,
    )

    def gb(net, fields):
        return sum(getattr(net, f).numel() * getattr(net, f).element_size()
                   for f in fields) / 1e9

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_network(spec, seed=12)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[full] network {spec.n_areas} x {net.n_pad}, K {net.k_intra}/{net.k_inter}, "
        f"D {net.delay_ratio}, ring {net.ring_len}, intra window "
        f"[{net.steps_lo_intra}, +{net.r_span_intra}), inter window "
        f"[{net.steps_lo_inter}, +{net.r_span_inter}); incoming tables built on "
        f"{net.device} in {build_s:.2f} s, {gb(net, INCOMING):.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    net = add_outgoing_tables(net)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    k_out = (net.tgt_intra.shape[-1], net.tgt_inter.shape[-1])
    bound = (_outgoing_k_bound(net.k_intra), _outgoing_k_bound(net.k_inter))
    log(f"[full] outgoing tables (the inversion): {invert_s:.2f} s, K_out {k_out[0]}/"
        f"{k_out[1]} (bound {bound[0]}/{bound[1]}), {gb(net, OUTGOING):.2f} GB; build "
        f"{build_s + invert_s:.2f} s in all, tables {gb(net, INCOMING + OUTGOING):.2f} GB, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if k_out[0] > bound[0] or k_out[1] > bound[1]:
        raise AssertionError(f"K_out {k_out} above the bound {bound}")
    t0 = time.perf_counter()
    check_outgoing_order(net)  # raises on a row the event kernel cannot take
    log(f"[full] every outgoing row ascends with its -1 padding at the end (checked in "
        f"row chunks in {time.perf_counter() - t0:.2f} s)")
    return net


def _timed_windows(eng, st, n, check=None):
    """1 warm-up + n timed windows (host clock around each window, which ends
    in a synchronize); ``check`` runs outside the timing. Returns the state,
    ms/window (mean), kernel launches per window, and a note of the slowest
    and fastest window and of the caching allocator's retries (a cudaMalloc
    that failed, emptied the cache and synchronized) during the windows."""
    import torch

    from repro_torch.kernels import cuda

    times = []
    for w in range(n + 1):
        if w == 1:
            before = dict(cuda.launches)
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, blk = eng.window(st)
        torch.cuda.synchronize()
        if w:
            times.append(time.perf_counter() - t0)
        if check:
            check(w, st, blk)
    per = {k: (cuda.launches[k] - before[k]) / n for k in before}
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    note = (f"windows {1e3 * min(times):.2f}-{1e3 * max(times):.2f} ms, "
            f"{retries} allocator retries")
    return st, 1e3 * sum(times) / n, per, note


def _advance(eng, st, n, what):
    """``st`` after ``n`` untimed windows of ``eng``; logs each window's
    spikes and those of its busiest (cycle, area)."""
    first = st.t // eng.delay_ratio
    blocks = []
    for _ in range(n):
        st, blk = eng.window(st)
        blocks.append(blk)
    log(f"[full] {what}, windows {first}-{first + n - 1}: {_fired(blocks)}")
    return st


def _fired(blocks) -> str:
    """Spikes a window, and those of each window's busiest (cycle, area)."""
    import torch

    per = [blk.sum(-1, dtype=torch.int32) for blk in blocks]  # [D, A] each
    return (f"spikes {[int(x.sum()) for x in per]}, busiest (cycle, area) "
            f"{[int(x.max()) for x in per]}")


def _keep(store):
    return lambda w, st, blk: store.append((blk.clone(), st.ring.clone()))


def _same_as(store, what):
    def check(w, st, blk):
        blk_0, ring_0 = store[w]
        if not (bitwise_equal(blk, blk_0) and bitwise_equal(st.ring, ring_0)):
            raise AssertionError(f"{what} differ at window {w}")
    return check


def _expect(per, name, **nonzero):
    from repro_torch.kernels import cuda

    want = {k: float(nonzero.get(k, 0)) for k in cuda.KERNELS}
    if per != want:
        raise AssertionError(f"{name}: launches per window {per}, expected {want}")


def _report(name, ms, per, note, st, model_ms):
    log(f"[full] {name}: {ms:.2f} ms/window ({note}), real-time factor "
        f"{ms / model_ms:.1f}, launches/window {per}, {int(st.spike_count.sum())} spikes")


def phase_main_path(spec, net) -> dict:
    """The ``pallas`` runs at full width. Returns their stores (each window's
    block and ring, for the event runs to match), ms/window per run, the
    path's launch counts and lif_update's profiled us per launch."""
    import torch

    from repro_torch.core import EngineConfig, make_simulation
    from repro_torch.kernels import cuda

    model_ms = net.delay_ratio * net.dt_ms

    def engine(model, sched="structure_aware", **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model=model, schedule=sched, delivery_backend="pallas", **kw), net=net)

    cuda.reset_launches()
    # The conventional run keeps each window's block and ring; the
    # structure-aware runs, unfused and fused, must reproduce them bitwise.
    iaf = {"conventional": engine("ignore_and_fire", "conventional"),
           "structure_aware": engine("ignore_and_fire"),
           "structure_aware fused": engine("ignore_and_fire", superstep_kernel=True)}
    iaf_store = []
    runs = {"conventional": _timed_windows(
        iaf["conventional"], iaf["conventional"].init(), 5, check=_keep(iaf_store))}
    for name in ("structure_aware", "structure_aware fused"):
        runs[name] = _timed_windows(iaf[name], iaf[name].init(), 5,
                                    check=_same_as(iaf_store, f"iaf conventional and {name}"))
    st_c = runs["conventional"][0]
    for name, (st, ms, per, note) in runs.items():
        if int(st.spike_count.sum()) <= 0 or not state_equal(st_c, st):
            raise AssertionError(f"full width iaf {name}: no spikes, or final state differs")
        _report(f"ignore_and_fire {name}", ms, per, note, st, model_ms)
    _expect(runs["conventional"][2], "iaf conventional", spike_deliver=20)
    _expect(runs["structure_aware"][2], "iaf structure_aware", spike_deliver=20)
    _expect(runs["structure_aware fused"][2], "iaf fused", spike_deliver=10, superstep_iaf=1)
    log("[full] ignore_and_fire conventional == structure_aware == fused bitwise over "
        "6 windows (spike blocks, rings, states)")
    ms = {f"iaf {name}": run[1] for name, run in runs.items()}
    del runs, st_c

    # LIF: both runs start from the state after LIF_RAMP_WINDOWS windows of
    # the fused engine; the unfused structure-aware run keeps its blocks and
    # rings, the fused run must reproduce them and the final state bitwise.
    lif = {"structure_aware": engine("lif"),
           "structure_aware fused": engine("lif", superstep_kernel=True)}
    lif_start = _advance(lif["structure_aware fused"], lif["structure_aware fused"].init(),
                         LIF_RAMP_WINDOWS, "lif untimed, fused pallas")
    lif_store = []
    st_u, ms_u, per_u, note_u = _timed_windows(lif["structure_aware"], lif_start,
                                       5, check=_keep(lif_store))
    st_f, ms_f, per_f, note_f = _timed_windows(lif["structure_aware fused"], lif_start, 5,
                                       check=_same_as(lif_store, "lif unfused and fused"))
    if not bool(torch.isfinite(st_f.neuron.v).all()) or not bool(torch.isfinite(st_f.ring).all()):
        raise AssertionError("LIF state is not finite")
    if not state_equal(st_u, st_f):
        raise AssertionError("full width LIF: fused final state != unfused")
    if not all(bool(blk.any()) for blk, _ in lif_store):
        raise AssertionError("full width LIF: a window without spikes")
    log(f"[full] lif runs, windows {LIF_RAMP_WINDOWS}-{LIF_RAMP_WINDOWS + 5}: "
        f"{_fired([blk for blk, _ in lif_store])}")
    _report("lif structure_aware", ms_u, per_u, note_u, st_u, model_ms)
    _report("lif structure_aware fused", ms_f, per_f, note_f, st_f, model_ms)
    _expect(per_u, "lif structure_aware", lif_update=10, spike_deliver=20)
    _expect(per_f, "lif fused", spike_deliver=10, superstep_lif=1)
    log("[full] lif unfused == fused bitwise over 6 windows (spike blocks, rings, states)")
    ms.update({"lif structure_aware": ms_u, "lif structure_aware fused": ms_f})
    launches = dict(cuda.launches)
    log(f"[full] main-path launches (pallas runs) {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches[k] for k in PALLAS_PATH_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the pallas runs never launched: {launches}")
    profiled = {}
    for name, eng in lif.items():
        kernels = profile_window(f"lif {name}", lambda: eng.window(st_f))
        if name == "structure_aware":
            us, count = _port_kernel_time(kernels, "lif_update_kernel")
            if count != per_u["lif_update"]:
                raise AssertionError(f"profiled LIF window: {count} lif_update launches, "
                                     f"expected {per_u['lif_update']}")
            profiled["lif_update"] = us / count
    for name, eng in iaf.items():
        st = eng.window(eng.init())[0]
        profile_window(f"ignore_and_fire {name}", lambda: eng.window(st))
    return dict(iaf_store=iaf_store, lif_store=lif_store, lif_start=lif_start, ms=ms,
                launches=launches, profiled=profiled)


def phase_event_runs(spec, net, pallas: dict) -> dict:
    """The ``event`` runs at full width on the same network, 1 + 5 windows
    each, every one bitwise the matching ``pallas`` run window by window
    (spike blocks and rings) with ``overflow == 0``. Returns the event path's
    launch counts."""
    import torch

    from repro_torch.core import EngineConfig, make_simulation, run_windows
    from repro_torch.kernels import cuda

    model_ms = net.delay_ratio * net.dt_ms

    def engine(model, sched="structure_aware", **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model=model, schedule=sched, delivery_backend="event", **kw), net=net)

    def check_final(name, st, store):
        if int(st.overflow) != 0:
            raise AssertionError(f"event {name}: overflow {int(st.overflow)}")
        if not bitwise_equal(st.ring, store[-1][1]):
            raise AssertionError(f"event {name}: final ring differs from the pallas run's")

    # (name, model, schedule, config, the pallas run it must equal and is
    # timed beside, expected launches per window)
    iaf_runs = [
        ("conventional", "conventional", {}, "iaf conventional", dict(event_deliver=20)),
        ("structure_aware", "structure_aware", {}, "iaf structure_aware",
         dict(event_deliver=11)),
        ("structure_aware legacy", "structure_aware", dict(superstep=False),
         "iaf structure_aware", dict(event_deliver=20)),
        ("structure_aware fused", "structure_aware", dict(superstep_kernel=True),
         "iaf structure_aware fused", dict(event_deliver=1, superstep_iaf=1)),
        ("structure_aware adaptive", "structure_aware", dict(adaptive_exchange=True),
         "iaf structure_aware", dict(event_deliver=11)),
    ]
    lif_runs = [
        ("structure_aware", "structure_aware", dict(fused_update=True),
         "lif structure_aware", dict(event_deliver=11, lif_update=10)),
        ("structure_aware fused", "structure_aware", dict(superstep_kernel=True),
         "lif structure_aware fused", dict(event_deliver=1, superstep_lif=1)),
    ]
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    engines = {}
    for model, runs, store, start in (
            ("ignore_and_fire", iaf_runs, pallas["iaf_store"], None),
            ("lif", lif_runs, pallas["lif_store"], pallas["lif_start"])):
        for name, sched, kw, twin, per_window in runs:
            eng = engines[f"{model} {name}"] = engine(model, sched, **kw)
            st, ms, per, note = _timed_windows(eng, eng.init() if start is None else start, 5,
                                         check=_same_as(store, f"event {model} {name} and {twin}"))
            check_final(f"{model} {name}", st, store)
            _expect(per, f"event {model} {name}", **per_window)
            log(f"[event] {model} {name}: {ms:.2f} ms/window ({note}; pallas "
                f"{pallas['ms'][twin]:.2f}), "
                f"real-time factor {ms / model_ms:.1f} (pallas "
                f"{pallas['ms'][twin] / model_ms:.1f}), launches/window {per}, "
                f"{int(st.spike_count.sum())} spikes, overflow 0; bitwise the pallas run "
                f"window by window")

    # Adaptive + overlap through run_windows: blocks window by window, and
    # the drained state at the end, against the pallas run.
    name = "structure_aware adaptive overlap"
    eng = engines[f"ignore_and_fire {name}"] = engine(
        "ignore_and_fire", adaptive_exchange=True, overlap_exchange=True)
    store = pallas["iaf_store"]
    before = dict(cuda.launches)
    checked = []

    def on_block(w, blk):
        if not bitwise_equal(blk, store[w - 1][0]):
            raise AssertionError(f"event iaf {name}: block differs at window {w - 1}")
        checked.append(w)

    res = run_windows(eng, eng.init(), 6, on_block=on_block)
    check_final(f"ignore_and_fire {name}", res.state, store)
    total = {k: cuda.launches[k] - before[k] for k in before}
    want = {k: 66 if k == "event_deliver" else 0 for k in cuda.KERNELS}
    if total != want or not res.overlapped or res.drains != 1 or len(checked) != 6:
        raise AssertionError(f"event iaf {name}: launches {total} (expected {want}), "
                             f"overlapped {res.overlapped}, drains {res.drains}")
    ms = 1e3 * float(res.window_times_s[1:].mean())
    twin = pallas["ms"]["iaf structure_aware"]
    log(f"[event] ignore_and_fire {name} (run_windows): {ms:.2f} ms/window over windows "
        f"2-6 (pallas {twin:.2f}), real-time factor {ms / model_ms:.1f}, launches {total} "
        f"over 6 windows and the drain, drains {res.drains}, overflow 0; blocks bitwise "
        f"the pallas run's window by window, the drained state's ring bitwise its last")
    launches = dict(cuda.launches)
    log(f"[event] event-path launches {launches}, peak while the event engines ran "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches[k] for k in EVENT_PATH_KERNELS) <= 0 or launches["spike_deliver"]:
        raise AssertionError(f"event path launches {launches}")
    for name in ("ignore_and_fire structure_aware", "ignore_and_fire structure_aware fused"):
        eng = engines[name]
        st = eng.window(eng.init())[0]
        kernels = profile_window(f"event {name}", lambda: eng.window(st))
        log(f"[profile]   {sum(k[1] for k in kernels)} kernel launches in the window")
    return launches


def phase_lif_steady(spec, net, start) -> tuple:
    """LIF at its steady state (~70 Hz), 1 + 5 windows from window
    ``LIF_STEADY_WINDOWS`` (``start`` advanced on the fused pallas engine):
    the fused pallas run bitwise the unfused one, and the adaptive event
    runs, unfused (``fused_update=True``) and fused, bitwise the unfused
    pallas run window by window with ``overflow == 0``; one window of each
    adaptive event run profiled, with ``event_deliver``'s share of the
    device's busy time. Then one window of the static event packets, which
    drop spikes at this rate: the count. Returns the last window's block and
    ring and its first step, for ``[kernel]``."""
    from repro_torch.core import EngineConfig, make_simulation

    model_ms = net.delay_ratio * net.dt_ms

    def engine(backend, **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model="lif", delivery_backend=backend, **kw), net=net)

    fused = engine("pallas", superstep_kernel=True)
    start = _advance(fused, start, LIF_STEADY_WINDOWS - LIF_RAMP_WINDOWS,
                     "lif untimed, fused pallas")
    store = []
    runs = [("pallas", engine("pallas"), _keep(store), dict(spike_deliver=20, lif_update=10)),
            ("pallas fused", fused, None, dict(spike_deliver=10, superstep_lif=1)),
            ("event adaptive", engine("event", adaptive_exchange=True, fused_update=True),
             None, dict(event_deliver=11, lif_update=10)),
            ("event adaptive fused",
             engine("event", adaptive_exchange=True, superstep_kernel=True), None,
             dict(event_deliver=1, superstep_lif=1))]
    for name, eng, check, per_window in runs:
        st, ms, per, note = _timed_windows(
            eng, start, 5, check=check or _same_as(store, f"steady lif {name} and pallas"))
        _expect(per, f"steady lif {name}", **per_window)
        if int(st.overflow) != 0 or not bitwise_equal(st.ring, store[-1][1]):
            raise AssertionError(f"steady lif {name}: overflow {int(st.overflow)} or final "
                                 "ring differs")
        log(f"[steady] lif {name}: {ms:.2f} ms/window ({note}), real-time factor "
            f"{ms / model_ms:.1f}, launches/window {per}, overflow 0"
            + ("" if check else "; bitwise the unfused pallas run window by window"))
    log(f"[steady] lif runs, windows {LIF_STEADY_WINDOWS}-{LIF_STEADY_WINDOWS + 5}: "
        f"{_fired([blk for blk, _ in store])}")
    for name, eng, _, _ in runs[2:]:
        kernels = profile_window(f"steady lif {name}, window {LIF_STEADY_WINDOWS}",
                                 lambda: eng.window(start))
        us, count = _port_kernel_time(kernels, "event_deliver_kernel")
        busy = sum(k[0] for k in kernels)
        log(f"[profile]   event_deliver_kernel {us / 1e3:.3f} ms in {count} launches, "
            f"{100 * us / busy:.1f}% of the busy time; {sum(k[1] for k in kernels)} "
            f"kernel launches in the window")
    st = engine("event", superstep_kernel=True).window(start)[0]
    log(f"[steady] lif event fused with static packets: {int(st.overflow)} spikes dropped "
        f"in one window")
    block, ring = store[-1]
    return block, ring, (LIF_STEADY_WINDOWS + 5) * net.delay_ratio


def profile_window(name, fn, what="window") -> list[tuple[float, int, str]]:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the share of its wall time the device was busy; returns the kernels as
    (device us, count, name), longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    log(f"[profile] {name}: {what} {wall_us / 1e3:.2f} ms wall, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} kernel kinds")
    for i, (us, count, key) in enumerate(kernels):
        if i < 6 or any(sym in key for sym in PORT_KERNEL_SYMBOLS):
            log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return kernels


def _port_kernel_time(kernels, symbol) -> tuple[float, int]:
    """Device us and launches of the profiled kernels whose name holds ``symbol``."""
    hits = [(us, count) for us, count, key in kernels if symbol in key]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def event_packets(net, block, t0: int, *, adaptive: bool) -> dict:
    """The packets the event engine makes from a fired window ``block``
    ``[D, A, n]`` emitted from step ``t0``: the window-end inter packets
    ``[D, S_all]`` and the busiest cycle's intra packets ``[A, S_area]``,
    sized by the static bounds of ``EngineConfig``'s defaults, or (with
    ``adaptive``) by the rungs of the adaptive ladders that the counts
    select, as ``LocalExchange`` sizes them. Returns ``{name: (ids,
    pathway, rows_per_area, t)}``."""
    import torch

    from repro_torch.core import EngineConfig
    from repro_torch.core.exchange import LocalExchange
    from repro_torch.kernels import ops

    dev = net.device
    a, n = net.alive.shape
    ex = LocalExchange(net, EngineConfig(delivery_backend="event", adaptive_exchange=adaptive))
    flat = block.reshape(block.shape[0], -1)
    counts = flat.sum(-1, dtype=torch.int32)
    busiest = int(counts.argmax())
    s_all, s_area = ex.s_max_all, ex.s_max_area
    if adaptive:
        s_all = ops.ladder_rung(ex.ladder_all, counts.max())
        per_area = block[busiest].sum(-1, dtype=torch.int32)
        s_area = ops.ladder_rung(ex.ladder_area, per_area.max())
    inter, _ = ops.compact_ids_block(flat, torch.arange(a * n, device=dev), size=s_all,
                                     fill_id=a * n)
    intra, _ = ops.compact_ids_block(block[busiest], torch.arange(n, device=dev),
                                     size=s_area, fill_id=n)
    return {"inter": (inter, "inter", None, t0), "intra": (intra, "intra", n, t0 + busiest)}


def event_adds(ring, ids, tables, per_area, t):
    """What a scatter of the packets ``ids`` adds into ``ring [N, R]``: the
    fired entries' table rows (found here, outside any timing), and a
    function that gathers the flat ring indices and weights of all their
    K_out columns with static shapes and no host sync. A padding column
    adds +0.0 at a ring position of its own, a no-op, since rings never hold
    -0.0, and one that does not queue on a single address. Returns
    ``(src_rows, gather)``; ``gather()`` returns ``(flat_idx, vals, hit)``."""
    import torch

    tgt, w, d = tables
    dev, (n_rows, r), k = ring.device, ring.shape, tgt.shape[1]
    n_src = per_area or tgt.shape[0]
    n_tgt = per_area or n_rows
    row = torch.arange(ids.shape[0], device=dev)[:, None].expand(ids.shape)
    real = (ids >= 0) & (ids < n_src)
    row = row[real]
    src_rows = ids[real].long() + (row * per_area if per_area else 0)
    off = (row * per_area)[:, None] if per_area else 0
    step = 0 if per_area else row[:, None]
    spread = torch.arange(src_rows.numel() * k, device=dev).view(-1, k) % ring.numel()

    def gather():
        tg = tgt[src_rows].long()
        hit = (tg >= 0) & (tg < n_tgt)
        idx = (tg + off) * r + torch.remainder(t + step + d[src_rows].long(), r)
        return (torch.where(hit, idx, spread).view(-1),
                torch.where(hit, w[src_rows], 0.0).view(-1), hit)

    return src_rows, gather


def event_bound(ring, ids, tables, per_area, t, red_rate) -> dict:
    """The least time a scatter of the packets ``ids`` could take: the
    packets, the fired rows' ``tgt``, ``w``/``d`` of the delivered synapses,
    and 64 bytes (read and written once) per distinct 32-byte ring sector
    the adds touch, over the memory rate. ``reds_ms``, the delivered
    reductions over ``red_rate`` (the L2's, measured), is the ceiling of a
    kernel that reduces each synapse on its own into the L2, as this one
    does, not a bound of the function: adds to one sector could be combined
    before they reach the L2. ``old_bound_ms`` is the earlier bound, 32
    bytes of ring per delivered synapse. Also the counts, and ``gather``
    (``event_adds``)."""
    import torch

    tgt, _, d = tables
    src_rows, gather = event_adds(ring, ids, tables, per_area, t)
    idx, _, hit = gather()
    synapses = int(hit.sum())
    sectors = int(torch.unique(idx.view(hit.shape)[hit] // 8).numel())
    del idx, hit
    table_bytes = (ids.numel() * 4 + src_rows.numel() * tgt.shape[1] * 4
                   + synapses * (4 + d.element_size()))
    bytes_ms = (table_bytes + 64 * sectors) / HBM_BYTES_PER_S * 1e3
    reds_ms = synapses / red_rate * 1e3
    return dict(bound_ms=bytes_ms, bound_by="bytes", reds_ms=reds_ms,
                old_bound_ms=(table_bytes + 32 * synapses) / HBM_BYTES_PER_S * 1e3,
                fired=src_rows.numel(), synapses=synapses, sectors=sectors, gather=gather)


def bound_note(b, ms) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by bytes, {100 * b['bound_ms'] / ms:.1f}% of it; "
            f"one L2 RED a synapse {b['reds_ms']:.4f} ms, {100 * b['reds_ms'] / ms:.1f}% of it; "
            f"the earlier bound, 32 B of ring a synapse, {b['old_bound_ms']:.4f} ms, "
            f"{100 * b['old_bound_ms'] / ms:.1f}% of it")


def red_rates(net, flush) -> dict:
    """Reductions per second: the ``red_probe`` of csrc/event_deliver.cu,
    2,048 threads per SM x 64 f32 REDs each at pseudo-random positions,
    into a buffer of one slice of the event kernel (a quarter of the L2,
    left in the L2 between windows) and into one of the ring's size (the L2
    flushed before each window)."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    dev = net.device
    r = net.ring_len
    threads = torch.cuda.get_device_properties(dev).multi_processor_count * 2048
    adds = 64
    slice_rows = evt.slice_rows(r, dev)
    out = dict(slice_rows=slice_rows, slice_mb=slice_rows * r * 4 / 1e6, reds=threads * adds)
    sizes = (("l2", slice_rows * r, None), ("dram", net.alive.numel() * r, flush))
    for name, numel, fl in sizes:
        buf = torch.zeros(numel, dtype=torch.float32, device=dev)
        ms = time_ms(lambda: evt.red_probe(buf, adds, threads), flush=fl)
        out[name] = threads * adds / (ms * 1e-3)
        out[f"{name}_ms"] = ms
        del buf
    log(f"[kernel] event_deliver yardstick, RED rate (red_probe, {threads * adds} f32 "
        f"reductions at random positions): into one slice ({out['slice_mb']:.1f} MB, "
        f"{slice_rows} ring rows, in the L2) {out['l2'] / 1e9:.1f} G/s "
        f"({out['l2_ms']:.4f} ms); "
        f"into a ring-sized buffer ({numel * 4 / 1e6:.0f} MB, from DRAM) "
        f"{out['dram'] / 1e9:.1f} G/s ({out['dram_ms']:.4f} ms)")
    return out


# Where the kernel switches regime: the steady inter packets keep 1 in
# `keep` of their fired entries (15.3 adds per ring sector at keep 1, so
# ~0.5-7.6 below), the steady intra ones (1.6 at keep 1, ~0.2-0.8 below);
# the iaf packets as they are.
REGIME_KEEPS = {("steady", "inter"): (32, 16, 12, 8, 4, 2, 1),
                ("steady", "intra"): (8, 4, 3, 2, 1), ("iaf", "inter"): (1,),
                ("iaf", "intra"): (1,)}


def regime_lines(net, windows: dict, tables: dict, flush) -> list[dict]:
    """The scatter's two regimes, forced by a build of each
    (``event_deliver_forced``), beside the kernel's own choice, on packets
    thinned to fewer fired entries (``REGIME_KEEPS``), packed to the front
    of each row as the engine packs them: each bitwise the
    plain version, each timed (median of 20). Adds per sector count the
    delivered synapses over all of the ring's 32-byte sectors, as the
    kernel's choice does."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    a, n = net.alive.shape
    r = net.ring_len
    out = []
    for run, (block, ring, t0, adaptive) in windows.items():
        cases = event_packets(net, block, t0, adaptive=adaptive)
        ring = ring.view(a * n, r)
        scratch = ring.clone()
        for pathway, (ids, _, per_area, t) in cases.items():
            tgt, w, d = tables[pathway]
            kw = dict(rows_per_area=per_area)
            pad = per_area or a * n
            real = (ids >= 0) & (ids < pad)
            rank = real.cumsum(1)
            for keep in REGIME_KEEPS[run, pathway]:
                # 1 in `keep` of each row's fired entries, first in the row,
                # as the engine packs a packet of fewer spikes.
                kept = real & (rank % keep == 0)
                order = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
                pk = torch.where(kept.gather(1, order), ids.gather(1, order),
                                 torch.full_like(ids, pad))
                src_rows, _ = event_adds(ring, pk, tables[pathway], per_area, t)
                synapses = int((tgt[src_rows] >= 0).sum())
                want = evt.event_deliver_plain(ring.clone(), pk, tgt, w, d, t, **kw)
                ms = {}
                for regime in ("auto", *evt.REGIMES):
                    fn = (evt.event_deliver_cuda if regime == "auto" else
                          lambda *x, regime=regime, **y: evt.event_deliver_forced(regime, *x, **y))
                    if not bitwise_equal(fn(ring.clone(), pk, tgt, w, d, t, **kw), want):
                        raise AssertionError(f"event_deliver {regime} ({run} {pathway}, 1 in "
                                             f"{keep} entries) != plain version")
                    ms[regime] = time_ms(lambda: fn(scratch, pk, tgt, w, d, t, **kw),
                                         flush=flush)
                del want
                per_sector = synapses / (ring.numel() / 8)
                best = min(ms["sliced"], ms["unsliced"])
                log(f"[kernel] event_deliver regimes, {run} {pathway} 1 in {keep} fired entries "
                    f"({src_rows.numel()} sources, {synapses} synapses, {per_sector:.2f} adds a "
                    f"ring sector): sliced {ms['sliced']:.4f} ms, unsliced "
                    f"{ms['unsliced']:.4f} ms, the kernel's choice {ms['auto']:.4f} ms "
                    f"({100 * (ms['auto'] / best - 1):+.1f}% on the faster); bitwise == plain")
                out.append(dict(packets=f"{run} {pathway}", keep=keep, adds_per_sector=per_sector,
                                **{f"{k}_ms": v for k, v in ms.items()}))
        del scratch
    return out


def phase_kernel_event(net, windows: dict, launches: dict) -> dict:
    """event_deliver against its plain version at full width, bitwise, on
    the packets the engine makes (``event_packets``) from fired windows:
    ``windows`` maps a name to ``(block, ring, t0, adaptive)``, the iaf
    run's last window (2.5 Hz, static packets) and LIF's steady state (~70
    Hz, adaptive packets); then the iaf inter packets with every kind of
    padding. Timed beside its bound, the plain version and the library's
    scatter of the same adds (the gather of flat indices and weights from
    the packets' table rows and ``index_add_``, timed together).

    The bound: the packets, the fired rows' ``tgt``, ``w``/``d`` of the
    delivered synapses, and 64 bytes (read and written once) per distinct
    32-byte ring sector the adds touch, over the memory rate. Beside it the
    ceiling of one reduction a synapse, the delivered synapses over the L2's
    measured RED rate (``red_rates``), and the earlier bound (32 bytes of
    ring per delivered synapse).

    Then the kernel's two regimes on thinned packets (``regime_lines``)."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    dev = net.device
    a, n = net.alive.shape
    r = net.ring_len
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rates = red_rates(net, flush)
    flat = lambda x: x.view(a * n, -1)  # noqa: E731
    tables = {p: (flat(getattr(net, f"tgt_{p}")), flat(getattr(net, f"wout_{p}")),
                  flat(getattr(net, f"dout_{p}"))) for p in ("intra", "inter")}
    timings = {}
    for run, (block, ring, t0, adaptive) in windows.items():
        cases = event_packets(net, block, t0, adaptive=adaptive)
        ring = ring.view(a * n, r)
        scratch = ring.clone()  # timing runs scatter into it, in place
        for pathway, (ids, _, per_area, t) in cases.items():
            name = f"{run} {pathway}"
            tgt, w, d = tables[pathway]
            kw = dict(rows_per_area=per_area)
            got = evt.event_deliver_cuda(ring.clone(), ids, tgt, w, d, t, **kw)
            want = evt.event_deliver_plain(ring.clone(), ids, tgt, w, d, t, **kw)
            if not bitwise_equal(got, want):
                raise AssertionError(f"event_deliver ({name}) kernel != plain version: "
                                     f"{int((got != want).sum())} ring entries differ")
            err = max_abs_err(got, want)
            del got, want
            b = event_bound(ring, ids, tables[pathway], per_area, t, rates["l2"])
            ms = time_ms(lambda: evt.event_deliver_cuda(scratch, ids, tgt, w, d, t, **kw),
                         flush=flush)
            plain_ms = time_ms(
                lambda: evt.event_deliver_plain(scratch, ids, tgt, w, d, t, **kw),
                reps=3 if adaptive else 20, flush=flush, host_paced_ok=True)

            def library():
                idx, vals, _ = b["gather"]()
                scratch.view(-1).index_add_(0, idx, vals)

            library_ms = time_ms(library, reps=10 if adaptive else 20, flush=flush,
                                 host_paced_ok=True)
            log(f"[kernel] event_deliver {name} packets {list(ids.shape)}, K_out "
                f"{tgt.shape[1]}: bitwise == plain; {b['fired']} fired sources, "
                f"{b['synapses']} synapses into {b['sectors']} ring sectors "
                f"({b['synapses'] / max(b['sectors'], 1):.2f} adds a sector); {ms:.4f} ms, "
                f"{b['synapses'] / ms / 1e6:.2f} G synapses/s ({bound_note(b, ms)}), "
                f"plain {plain_ms:.3f} ms, gather + index_add_ of the same adds "
                f"{library_ms:.4f} ms")
            timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, err=err,
                                 **{k: v for k, v in b.items() if k != "gather"})
            del b
        del scratch

    # Every kind of padding, on the inter packets of each window (the
    # kernel streams whole rows at 2.5 Hz and slices the ring at ~70 Hz).
    for run, (block, ring, t0, adaptive) in windows.items():
        ids = event_packets(net, block, t0, adaptive=adaptive)["inter"][0].clone()
        ids[0, :4] = torch.tensor([-1, a * n, a * n + 7, 2**31 - 1], dtype=torch.int32)
        ids[1, :] = a * n                      # a row of padding only
        ids[2, :3] = ids[3, 0]                 # one source three times
        tgt, w, d = tables["inter"]
        ring = ring.view(a * n, r)
        got = evt.event_deliver_cuda(ring.clone(), ids, tgt, w, d, t0)
        if not bitwise_equal(got, evt.event_deliver_plain(ring.clone(), ids, tgt, w, d, t0)):
            raise AssertionError(f"event_deliver ({run}, every padding) kernel != plain version")
        real = int(((ids >= 0) & (ids < a * n)).sum())
        log(f"[kernel] event_deliver {run} inter, every padding: bitwise == plain ({real} "
            f"real ids of {ids.numel()})")
        del got
    regimes = regime_lines(net, windows, tables, flush)
    t = timings["iaf inter"]
    extra = {name.replace(" ", "_"): {k: v for k, v in x.items() if k != "err"}
             for name, x in timings.items() if name != "iaf inter"}
    return dict(
        name="event_deliver", route="cuda", source="src/repro_torch/kernels/csrc/event_deliver.cu",
        replaces="src/repro/kernels/ops.py:244 (jnp scatter; no Pallas counterpart)",
        launches=launches["event_deliver"], max_abs_err=max(x["err"] for x in timings.values()),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], checked=True, red_rates=rates, regimes=regimes, **extra)


def phase_kernels(net, launches: dict, lif_profile_us: dict) -> list[dict]:
    """Each kernel against its plain version on the card, and timed;
    ``lif_profile_us`` holds lif_update's profiled us per launch."""
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
    paced_ms = time_ms_host_paced(lambda: lif.lif_update_cuda(*args, **kw), reps=100,
                                  flush=flush)
    # The floor of one timed launch: the same timer around a 4-neuron launch.
    tiny = tuple(x[:4] for x in args)
    floor_ms = time_ms(lambda: lif.lif_update_cuda(*tiny, **kw), reps=100, flush=flush)
    plain_ms = time_ms(lambda: lif.lif_update_plain(*args, **kw), reps=100, flush=flush,
                       host_paced_ok=True)
    nbytes = 30 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 6 * n / F32_OPS_PER_S) * 1e3
    log(f"[kernel] lif_update N={n}: bitwise == plain; {ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by bytes, {100 * bound_ms / ms:.1f}% of it, "
        f"{nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms; the host-paced timer "
        f"reads {paced_ms:.4f} ms in this call; a 4-neuron launch reads "
        f"{floor_ms:.4f} ms (the floor of one timed launch)")
    log(f"[kernel] lif_update in the profiled unfused LIF window (CUPTI): "
        f"{lif_profile_us['lif_update']:.2f} us per launch")
    rows.append(dict(
        name="lif_update", route="cuda", source="src/repro_torch/kernels/csrc/lif_update.cu",
        replaces="src/repro/kernels/lif_update.py:77", launches=launches["lif_update"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None, checked=True, host_paced_ms=paced_ms,
        launch_floor_ms=floor_ms))

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
        plain_ms = time_ms(lambda: dlv.spike_deliver_plain(spikes, src, w, delay, **kw),
                           host_paced_ok=True)
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
    from repro_torch.kernels import cuda
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
        plain_ms = time_ms(lambda: plain(*args(scratch), **kw), reps=10, flush=flush,
                           host_paced_ok=True)
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

    # Ignore-and-fire at two densities: phases spread over 200 cycles and
    # intervals of 1-12, so ~5% of the neurons fire in the window, some of
    # them several times; and the main path's 2.5 Hz (interval 4000 steps,
    # phases over the whole interval), so ~0.25% fire once.
    timed = {}
    for regime, phases, intervals in (("5%", (0, 200), (1, 13)),
                                      ("main path 2.5 Hz", (0, 4000), (4000, 4001))):
        countdown = t(rng.integers(*phases, (a, n)).astype(np.int32))
        interval = t(rng.integers(*intervals, (a, n)).astype(np.int32))
        kw = dict(d_win=d_win, steps_lo=lo, r_span=span)
        want, err, ms, plain_ms = check_and_time(
            "superstep_iaf", cyc.superstep_iaf_cuda, cyc.superstep_iaf_plain,
            lambda fut: (countdown, fut, interval, net.alive, *tables), kw)
        spikes = want[2]
        per_cycle = [int(x) for x in spikes.sum(dim=(1, 2))]
        if min(per_cycle) <= 0:
            raise AssertionError(f"superstep_iaf check ({regime}): a cycle without spikes "
                                 f"{per_cycle}")
        # Bytes: all of src once; w, delay and the source's pattern of every
        # synapse whose source spiked in the window; the state (13 B per
        # neuron), the spikes and fut once.
        fired = spikes.any(dim=0).reshape(-1).float()
        active = _active_synapses(fired, net.src_intra.view(a * n, k), n)
        nbytes = a * src_bytes + active * (8 + delay_b) + a * n * (13 + d_win) + fut_bytes
        bound_ms = max(nbytes / HBM_BYTES_PER_S, active / F32_OPS_PER_S) * 1e3
        log(f"[kernel] superstep_iaf [{a}, {n}, {k}] D {d_win}, {regime}: bitwise == plain; "
            f"{100 * float(fired.mean()):.2f}% of sources fire, spikes per cycle {per_cycle}, "
            f"{active} active synapses; {ms:.3f} ms (bound {bound_ms:.3f} ms by bytes, "
            f"{100 * bound_ms / ms:.1f}% of it, {nbytes / ms / 1e6:.0f} GB/s of needed "
            f"bytes), plain {plain_ms:.3f} ms")
        timed[regime] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, err=err)
    # A yardstick for the stream: one library reduction that reads all of
    # src once, in its own int32 (a widening sum is much slower).
    stream_ms = time_ms(lambda: net.src_intra.amax(), reps=10, flush=flush)
    log(f"[kernel] superstep_iaf yardstick: torch.amax over src ({a * src_bytes / 1e9:.2f} GB) "
        f"{stream_ms:.3f} ms, {a * src_bytes / stream_ms / 1e6:.0f} GB/s")
    lib = cuda.library("superstep_iaf")
    log(f"[kernel] superstep_iaf deposit at N={a * n}: "
        f"{lib.superstep_iaf_smem_bytes(a * n, d_win, span)} bytes of dynamic shared memory, "
        f"bitmask {'in shared memory' if lib.superstep_iaf_mask_in_smem(a * n, d_win, span) else 'read through L2'}"
        f" (registers and spills: [build] lines)")
    # The row is the 5% shape; the main path's density is beside it.
    five, main = timed["5%"], timed["main path 2.5 Hz"]
    rows.append(dict(
        name="superstep_iaf", route="cuda", source="src/repro_torch/kernels/csrc/superstep_iaf.cu",
        replaces="src/repro/kernels/cycle.py:183", launches=launches["superstep_iaf"],
        max_abs_err=max(five["err"], main["err"]), ms=five["ms"], plain_ms=five["plain_ms"],
        bound_ms=five["bound_ms"], bound_by="bytes", library_ms=None, checked=True,
        main_path_density={k: main[k] for k in ("ms", "plain_ms", "bound_ms")}))
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
    """The port on the card against the port on the CPU, bitwise: the
    ``pallas`` configs, and the ``event`` configs (static, adaptive,
    adaptive + overlap through run_windows, and forced overflow, whose
    ``overflow`` count must agree too)."""
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation, run_windows
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.kernels import cuda

    configs = [("pallas " + name, dict(delivery_backend="pallas", **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}),
        ("structure_aware fused", dict(superstep_kernel=True)))]
    configs += [("event " + name, dict(delivery_backend="event", **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}),
        ("structure_aware legacy", dict(superstep=False)),
        ("structure_aware fused", dict(superstep_kernel=True)),
        ("structure_aware adaptive", dict(adaptive_exchange=True)),
        ("structure_aware adaptive overlap", dict(adaptive_exchange=True,
                                                  overlap_exchange=True)))]
    # Massed firing (interval 5 steps) past packets of 1 per area and 4 per
    # network: the static bounds drop spikes, and both devices count them.
    forced = [("event " + name + " forced overflow", dict(
        delivery_backend="event", s_max_headroom=0.0, s_max_floor=1, **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}))]
    cuda.reset_launches()
    # LIF at this size first spikes in window 18: its runs take 40 windows.
    for model, rate, configs, n_win in (("ignore_and_fire", 30.0, configs, 10),
                                        ("lif", 2.5, configs, 40),
                                        ("ignore_and_fire", 2000.0, forced, 10)):
        spec = mam_benchmark_spec(n_areas=4, n_per_area=256, k_intra=32, k_inter=32,
                                  rate_hz=rate)
        nets = {d: build_network(spec, seed=12, outgoing=True, device=d)
                for d in ("cuda", "cpu")}
        for f in ("alive", "rate_hz") + INCOMING + OUTGOING:
            if not bitwise_equal(getattr(nets["cuda"], f), getattr(nets["cpu"], f)):
                raise AssertionError(f"device-built {f} != CPU-built {f}")
        for name, kw in configs:
            cfg = EngineConfig(neuron_model=model, **kw)
            engs = {d: make_simulation(spec, cfg, net=nets[d], device=d) for d in nets}
            if cfg.overlap_exchange:
                blocks = {d: [] for d in engs}
                st = {d: run_windows(e, e.init(), n_win,
                                     on_block=lambda w, b, d=d: blocks[d].append(b)).state
                      for d, e in engs.items()}
                if not all(map(bitwise_equal, blocks["cuda"], blocks["cpu"])):
                    raise AssertionError(f"{model} {name}: cuda != cpu blocks")
            else:
                st = {d: e.init() for d, e in engs.items()}
                for w in range(n_win):
                    blk = {}
                    for d, e in engs.items():
                        st[d], blk[d] = e.window(st[d])
                    if not (bitwise_equal(blk["cuda"], blk["cpu"])
                            and state_equal(st["cuda"], st["cpu"])):
                        raise AssertionError(f"{model} {name}: cuda != cpu at window {w}")
            over = {d: int(x.overflow) for d, x in st.items()}
            if not state_equal(st["cuda"], st["cpu"]) or over["cuda"] != over["cpu"]:
                raise AssertionError(f"{model} {name}: cuda != cpu (overflow {over})")
            if ("forced" in name) != (over["cpu"] > 0):
                raise AssertionError(f"{model} {name}: overflow {over['cpu']}")
            if int(st["cpu"].spike_count.sum()) <= 0:
                raise AssertionError(f"{model} {name}: no spikes in {n_win} windows")
            log(f"[cpu] {model} {rate:g} Hz {name}: cuda == cpu bitwise over {n_win} windows "
                f"(blocks, ring, neuron state, spike_count), overflow {over['cpu']}; "
                f"{int(st['cpu'].spike_count.sum())} spikes")
    counts = dict(cuda.launches)
    if min(counts[k] for k in SIM_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched in the cuda runs: {counts}")
    log(f"[cpu] kernel launches in the cuda runs {counts}")
    return counts


# ---------------------------------------------------------------------------
# The LM path: dense transformers at full width, the flash_attention kernel.

BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, the JAX package's model tests' measure
    (on ``got``'s device)."""
    want = want.to(got.device)
    return max_abs_err(got, want) / max(float(want.double().abs().max()), 1e-6)


def _bundle(arch, **overrides):
    """The bundle of ``arch`` at its published width, config fields replaced
    (``make_bundle`` refuses to override a field it sets, such as a dtype)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer

    bundle = get_arch(arch)
    cfg = dataclasses.replace(bundle.cfg, **overrides)
    return dataclasses.replace(bundle, cfg=cfg, model=Transformer(cfg))


def _lm(arch, seed=0, **overrides):
    """``_bundle(arch, **overrides)`` and its weights, drawn on the card
    from ``seed``."""
    import torch

    bundle = _bundle(arch, **overrides)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return bundle, bundle.model.init_params(gen)


def _tokens(vocab, b, s, seed=1):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device="cuda")


def _expect_launches(before, per_call, calls, what):
    from repro_torch.kernels import cuda

    want = {k: before[k] + (per_call * calls if k == "flash_attention" else 0)
            for k in cuda.KERNELS}
    if dict(cuda.launches) != want:
        raise AssertionError(f"{what}: launches {dict(cuda.launches)}, expected {want}")


def phase_lm_main() -> dict:
    """qwen2-0.5b at its published width and dtypes, B 2 x S 4096 with the
    flash kernel: 1 warm-up + 3 timed forwards, 24 launches each; then the
    profile of one forward. Returns the main path's launch counts."""
    import torch

    from repro_torch.configs.common import SHAPES
    from repro_torch.kernels import cuda

    bundle, params = _lm("qwen2-0.5b", use_pallas_attention=True)
    cfg = bundle.cfg
    b, s = 2, SHAPES["train_4k"].seq_len
    toks = _tokens(cfg.vocab, b, s)
    cuda.reset_launches()
    times = []
    with torch.inference_mode():
        for i in range(4):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.model.forward(params, toks)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            _expect_launches(before, cfg.n_layers, 1, "qwen2-0.5b forward")
            if logits.shape != (b, s, cfg.vocab) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"qwen2-0.5b logits {tuple(logits.shape)} not finite")
        launches = dict(cuda.launches)
        if launches["flash_attention"] <= 0:
            raise AssertionError(f"the LM main path never launched flash_attention: {launches}")
        ms = 1e3 * statistics.mean(times)
        log(f"[lm] qwen2-0.5b bf16 forward B {b} x S {s}, use_pallas_attention: "
            f"{ms:.2f} ms/forward (mean of 3 after 1 warm-up; {[round(1e3 * t, 2) for t in times]}), "
            f"{b * s / ms * 1e3:,.0f} tok/s, {2 * cfg.param_count() * b * s / ms / 1e9:.1f} "
            f"TFLOP/s of weight products, {cfg.n_layers} flash_attention launches "
            f"per forward, logits finite; main-path launches {launches}")
        kernels = profile_window("qwen2-0.5b forward", lambda: bundle.model.forward(params, toks),
                                 what="forward")
    busy = sum(k[0] for k in kernels)
    flash = sum(k[0] for k in kernels if "flash_attention" in k[2])
    gemm = sum(k[0] for k in kernels
               if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    log(f"[lm] qwen2-0.5b forward device time: flash_attention {flash / 1e3:.2f} ms "
        f"({100 * flash / busy:.1f}%), cuBLAS products {gemm / 1e3:.2f} ms "
        f"({100 * gemm / busy:.1f}%), other {(busy - flash - gemm) / 1e3:.2f} ms")
    del logits, params
    torch.cuda.empty_cache()
    return launches


def phase_lm_f32() -> None:
    """qwen2-0.5b with f32 parameters and compute: the kernel against the
    streaming path, and serving (prefill + decode) against the forward."""
    import torch

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.train.steps import make_serve_artifacts

    kernel, params = _lm("qwen2-0.5b", param_dtype="float32", compute_dtype="float32",
                         use_pallas_attention=True)
    plain = _bundle("qwen2-0.5b", param_dtype="float32", compute_dtype="float32")
    vocab = kernel.cfg.vocab
    with torch.inference_mode():
        toks = _tokens(vocab, 2, 4096)
        got, _ = kernel.model.forward(params, toks)
        want, _ = plain.model.forward(params, toks)
        err = rel_err(got, want)
        log(f"[lm] qwen2-0.5b f32 B 2 x S 4096: kernel vs streaming path rel {err:.3g} "
            f"(bar 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"qwen2-0.5b f32: kernel vs streaming {err} > 1e-4")
        del got, want
        # One 5120-token sequence: prefill 4096, decode token 4096. Causality
        # makes position 4096 of the longer forward the same quantity, and
        # 5120 keeps the kernel's and the streaming path's block contracts.
        toks = _tokens(vocab, 1, 5120, seed=2)
        full, _ = kernel.model.forward(params, toks)
        art = make_serve_artifacts(kernel, ShapeSpec("check", "prefill", 4097, 1),
                                   cache_dtype=torch.float32)
        lp, state = art.prefill_fn(params, {"tokens": toks[:, :4096]})
        ld, state = art.decode_fn(params, state, toks[:, 4096:4097], 4096)
        scale = float(full.double().abs().max())
        errs = [max_abs_err(lp[:, 0], full[:, 4095]) / scale,
                max_abs_err(ld[:, 0], full[:, 4096]) / scale]
        log(f"[lm] qwen2-0.5b f32 serving: prefill (4096) last logits rel {errs[0]:.3g}, "
            f"decode of token 4096 rel {errs[1]:.3g} against the 5120-token forward (bar 5e-4)")
        if not max(errs) <= 5e-4:
            raise AssertionError(f"qwen2-0.5b f32 serving vs forward {errs} > 5e-4")
    del params, full, state
    torch.cuda.empty_cache()


def phase_lm_serve() -> None:
    """qwen2-0.5b serving at its published dtypes through the entry point:
    batch 4, a 4096-token prompt, 32 tokens (the first from the prefill).
    Serving never reaches the kernel: prefill attends with a cache."""
    import torch

    from repro_torch import serve_lm
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import cuda
    from repro_torch.train.steps import make_serve_artifacts

    bundle, params = _lm("qwen2-0.5b", use_pallas_attention=True)
    before = dict(cuda.launches)
    for run in ("warm-up", "timed"):
        r = serve_lm.serve(bundle, params, batch=4, prompt_len=4096, tokens=32, seed=3)
        steps = r["decode_steps"]
        log(f"[lm] qwen2-0.5b bf16 serving ({run}): prefill 4 x 4096 in "
            f"{r['prefill_s'] * 1e3:.2f} ms ({4 * 4096 / r['prefill_s']:,.0f} tok/s), "
            f"decode {steps} steps x 4 in {r['decode_s'] * 1e3:.2f} ms "
            f"({r['decode_s'] / steps * 1e3:.3f} ms/step, {4 * steps / r['decode_s']:,.0f} tok/s)")
    if r["tokens"].shape != (4, 32) or not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError("qwen2-0.5b serving: wrong shape or non-finite logits")
    _expect_launches(before, 0, 0, "qwen2-0.5b serving")
    # Where a decode step's time goes: one step after a prefill.
    art = make_serve_artifacts(bundle, ShapeSpec("serve", "prefill", 4128, 4))
    with torch.inference_mode():
        _, state = art.prefill_fn(params, {"tokens": r["tokens"].new_zeros(4, 4096)})
        profile_window("qwen2-0.5b decode step (batch 4, cache 4096)",
                       lambda: art.decode_fn(params, state, r["tokens"][:, :1], 4096),
                       what="step")
    del params, state
    torch.cuda.empty_cache()


def phase_lm_danube() -> None:
    """h2o-danube-1.8b, B 1 x S 8192, so its 4096 window cuts in: bf16 with
    the kernel (24 launches), and f32 kernel against the streaming path."""
    import torch

    from repro_torch.kernels import cuda

    bundle, params = _lm("h2o-danube-1.8b", use_pallas_attention=True)
    toks = _tokens(bundle.cfg.vocab, 1, 8192)
    with torch.inference_mode():
        for i in range(2):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.model.forward(params, toks)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            _expect_launches(before, bundle.cfg.n_layers, 1, "h2o-danube-1.8b forward")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("h2o-danube-1.8b logits not finite")
        log(f"[lm] h2o-danube-1.8b bf16 forward B 1 x S 8192 (window 4096): {ms:.2f} ms "
            f"(second call), {8192 / ms * 1e3:,.0f} tok/s, {bundle.cfg.n_layers} "
            f"flash_attention launches, "
            f"logits finite")
        del logits, params
        torch.cuda.empty_cache()
        kernel, params = _lm("h2o-danube-1.8b", param_dtype="float32",
                             compute_dtype="float32", use_pallas_attention=True)
        plain = _bundle("h2o-danube-1.8b", param_dtype="float32", compute_dtype="float32")
        got, _ = kernel.model.forward(params, toks)
        want, _ = plain.model.forward(params, toks)
        err = rel_err(got, want)
    log(f"[lm] h2o-danube-1.8b f32 S 8192: kernel vs streaming path rel {err:.3g} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"h2o-danube-1.8b f32: kernel vs streaming {err} > 1e-4")
    del got, want, params
    torch.cuda.empty_cache()


def _valid_pairs(sq, sk, window, k_len) -> int:
    """(query, key) pairs the mask lets through: the work the data needs."""
    import numpy as np

    pos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, min(k_len, sk) - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bf16_bar_ratio(got, want) -> float:
    """Largest |got - want| over its bar, one bf16 ulp of the larger of the
    two values + 2e-5 (per element, as ``tests/test_torch_cuda.py``)."""
    import torch

    got, want = got.float(), want.float()
    top = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    bar = torch.exp2(torch.floor(torch.log2(top)) - 7) + 2e-5
    return float(((got - want).abs() / bar).max())


def log_flash_build() -> None:
    """The tensor-core kernel's instructions (wgmma and TMA must be there),
    and its instantiations' registers, spills and shared memory from this
    process's ``-Xptxas -v`` report."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import cuda

    lib = cuda.library("flash_attention")
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
                           str(cuda._target("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}[.\w]*", sass)) for op in ("HGMMA", "UTMALDG")}
    log(f"[kernel] flash_attention SASS: {counts['HGMMA']} HGMMA (wgmma), "
        f"{counts['UTMALDG']} UTMALDG (TMA loads)")
    if not all(counts.values()):
        raise AssertionError(f"flash_attention: no wgmma or TMA in the SASS: {counts}")
    report = cuda.build_logs.get("flash_attention")
    if report is None:
        log("[kernel] flash_attention_tc: no build report (library built by another process)")
        return
    dh, seen = None, {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*flash_attention_tcILi(\d+)E", line)
        if m or "Compiling entry function" in line:
            dh = int(m.group(1)) if m else None
        elif dh is not None and ("spill" in line or "registers" in line):
            seen.setdefault(dh, []).append(line.split(":", 1)[-1].strip())
    for dh, lines in sorted(seen.items()):
        log(f"[kernel] flash_attention_tc<{dh}>: {'; '.join(lines)}; dynamic shared memory "
            f"{lib.flash_attention_smem_bytes(1, dh)} bytes; setmaxnreg 232 (compute) / "
            f"40 (load)")


def phase_kernel_flash(launches: dict) -> dict:
    """flash_attention against its plain version at the main paths' shapes
    and with k_len < S; timed beside its bound, the plain version and SDPA,
    and the f32 route at qwen2-0.5b's shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    log_flash_build()

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(5)
    shapes = [("qwen2-0.5b", (2, 4096, 14, 2, 64), 0, 4096),
              ("h2o-danube-1.8b", (1, 8192, 32, 8, 80), 4096, 8192),
              ("k_len < S, windowed", (2, 4096, 14, 2, 64), 1024, 3000)]
    row = None
    for name, (b, s, h, hkv, dh), window, k_len in shapes:
        f32 = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
               for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
        # f32: the JAX kernel test's bar. bf16: both round an f32 result
        # once, so one bf16 ulp of the plain output's largest magnitude.
        got = fa.flash_attention_cuda(*f32, window, k_len)
        want = fa.flash_attention_plain(*f32, window, k_len)
        err32 = max_abs_err(got, want)
        bf = [x.bfloat16() for x in f32]
        got = fa.flash_attention_cuda(*bf, window, k_len)
        want = fa.flash_attention_plain(*bf, window, k_len)
        err16 = max_abs_err(got, want)
        ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
        ratio = bf16_bar_ratio(got, want)
        if not (err32 <= 2e-5 and err16 <= ulp and ratio <= 1.0
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention {name}: kernel vs plain max abs "
                                 f"{err32} (f32, bar 2e-5), {err16} (bf16, bar {ulp}), "
                                 f"bf16 per element {ratio} of the bar")
        ms = time_ms(lambda: fa.flash_attention_cuda(*bf, window, k_len), flush=flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(*bf, window, k_len), flush=flush,
                           host_paced_ok=True)
        f32_ms = None
        if row is None:  # the f32 route (CUDA cores) at the main path's shape
            f32_ms = time_ms(lambda: fa.flash_attention_cuda(*f32, window, k_len), flush=flush)
        pairs = _valid_pairs(s, s, window, k_len)
        flops = 4 * b * h * dh * pairs
        nbytes = sum(x.numel() * 2 for x in bf) + got.numel() * 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e3
        library_ms = None
        if window == 0 and k_len == s:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in bf)
            ref = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
            library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                 flush=flush)
            sdpa_ratio = bf16_bar_ratio(ref, want)
            log(f"[kernel] flash_attention {name}: bf16 vs plain, max abs / largest "
                f"per-element |diff| over the bar: kernel {err16:.3g} / {ratio:.3f}, SDPA "
                f"(P rounded to bf16) {max_abs_err(ref, want):.3g} / {sdpa_ratio:.3f} "
                f"(1 ulp {ulp:.3g})")
            # The control: a kernel that rounds P to bf16 must miss the bar,
            # or the bar could not tell the split P from a single rounding.
            if sdpa_ratio <= 1.0:
                raise AssertionError(f"flash_attention {name}: SDPA meets the per-element "
                                     f"bf16 bar ({sdpa_ratio}), so it separates nothing")
        log(f"[kernel] flash_attention {name} q [{b}, {s}, {h}, {dh}] kv [{b}, {s}, {hkv}, "
            f"{dh}] window {window} k_len {k_len}: max abs vs plain {err32:.3g} f32, "
            f"{err16:.3g} bf16 (1 ulp {ulp:.3g}; per element {ratio:.3f} of the bar); "
            f"bf16 (tensor cores) {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound "
            f"{bound_ms:.4f} ms by operations, {flops / 1e9:.1f} GFLOP), plain "
            f"{plain_ms:.3f} ms, SDPA {library_ms if library_ms is None else round(library_ms, 4)} ms"
            + ("" if f32_ms is None else
               f"; f32 (CUDA cores) {f32_ms:.3f} ms ({flops / f32_ms / 1e9:.1f} TFLOP/s; "
               f"f32 CUDA-core bound {flops / F32_OPS_PER_S * 1e3:.3f} ms)"))
        if row is None:  # the row is the qwen2-0.5b main path's shape
            row = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:79",
                launches=launches["flash_attention"], max_abs_err=err16, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
                library_ms=library_ms, checked=True)
        del f32, bf, got, want
    del flush
    torch.cuda.empty_cache()
    return row


def phase_lm_device_vs_cpu() -> None:
    """Reduced qwen2-0.5b in f32 on the card against the CPU, with
    FLASH_THRESHOLD lowered to 16 so the 32-token forward runs the kernel:
    the forward, then prefill + 4 decode steps."""
    import torch

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda
    from repro_torch.models import layers
    from repro_torch.train.steps import make_serve_artifacts

    bundle = get_arch("qwen2-0.5b", reduced=True, use_pallas_attention=True)
    params = {"cpu": bundle.model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
    toks = torch.randint(0, bundle.cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    threshold = layers.FLASH_THRESHOLD
    layers.FLASH_THRESHOLD = 16
    try:
        before = dict(cuda.launches)
        with torch.inference_mode():
            out = {d: bundle.model.forward(params[d], toks.to(d))[0] for d in params}
            _expect_launches(before, bundle.cfg.n_layers, 1, "reduced qwen2 forward on the card")
            err = rel_err(out["cuda"], out["cpu"])
            art = make_serve_artifacts(bundle, ShapeSpec("check", "prefill", 32, 2),
                                       cache_dtype=torch.float32)
            errs = []
            lp = {d: art.prefill_fn(params[d], {"tokens": toks[:, :28].to(d)}) for d in params}
            errs.append(rel_err(lp["cuda"][0], lp["cpu"][0]))
            for i in range(28, 32):
                lp = {d: art.decode_fn(params[d], lp[d][1], toks[:, i:i + 1].to(d), i)
                      for d in params}
                errs.append(rel_err(lp["cuda"][0], lp["cpu"][0]))
    finally:
        layers.FLASH_THRESHOLD = threshold
    log(f"[cpu] reduced qwen2-0.5b f32: forward (kernel on the card) cuda vs cpu rel "
        f"{err:.3g} (bar 1e-4); prefill + 4 decode steps rel {max(errs):.3g} (bar 5e-4)")
    if not (err <= 1e-4 and max(errs) <= 5e-4):
        raise AssertionError(f"reduced qwen2 cuda vs cpu: forward {err}, serving {errs}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import mam_benchmark_spec

    device = phase_device()
    phase_build()
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    net = phase_build_network(spec)
    pallas = phase_main_path(spec, net)
    event_launches = phase_event_runs(spec, net, pallas)
    steady = phase_lif_steady(spec, net, pallas["lif_start"])
    block, ring = pallas["iaf_store"][-1]  # the iaf runs' last window, from t0 = 5 D
    event_row = phase_kernel_event(
        net, {"iaf": (block, ring, 5 * net.delay_ratio, False), "steady": (*steady, True)},
        event_launches)
    # The outgoing tables and the runs' stores go before the kernel phases'
    # large temporaries.
    net = dataclasses.replace(net, **{f: None for f in OUTGOING})
    launches, profiled = pallas["launches"], pallas["profiled"]
    del pallas, block, ring, steady
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[full] outgoing tables freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rows = phase_kernels(net, launches, profiled) + [event_row]
    log(f"[kernel] peak in the kernel phases after the outgoing tables were freed: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del net
    torch.cuda.empty_cache()
    phase_device_vs_cpu()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32 (the default,
    torch.backends.cudnn.allow_tf32 = False        # stated): the f32 bars assume it
    lm_launches = phase_lm_main()
    phase_lm_f32()
    phase_lm_serve()
    phase_lm_danube()
    rows.append(phase_kernel_flash(lm_launches))
    phase_lm_device_vs_cpu()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
