"""The SNN simulation launcher (port of ``repro.launch.simulate``).

    PYTHONPATH=src python -m repro_torch.launch.simulate --model mam_benchmark \\
        --areas 4 --n-per-area 128 --k 16 --t-ms 100 --backend event --compare
    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu ...

The JAX CLI's flags, defaults, refusals, report lines and exit codes. One
process runs the single-host engine on one device: the GPU by default
(``--device cuda``; it raises when there is none), or the host with
``--device cpu``. Reports wall time, real-time factor, mean rate, spikes,
wire bytes and overflow per run; ``--compare`` verifies that the
conventional and structure-aware schedules give identical spikes (exit 1
otherwise), ``--compare-adaptive`` / ``--compare-overlap`` the same for the
adaptive packets and the overlapped pipeline; ``--checkpoint-dir`` /
``--resume`` / ``--inject-fault`` run the resilient windowed loop
(``schedule.run_windows``), and SIGTERM/SIGINT stop it at the next window
boundary with a checkpoint. ``--profile`` prints the phase table and the
dense-vs-routed wire-volume table.

**On a process group** the launcher runs the distributed engine. It spawns
no rank: it joins a world started from outside, one process a rank,

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.simulate --device cpu --exchange routed --backend event ...

picks the ``(data, model)`` mesh from the world size as the JAX CLI picks it
from the device count (:func:`_pick_mesh`), and takes ``--exchange``,
``--sharded-build``, ``--replicated-inter-tables``,
``--no-subgroup-inter-tables`` and ``--checkpoint-dir`` / ``--resume``
(resharding a checkpoint of another group count) there. The ranks talk over
gloo when they outnumber the host's cards or run with ``--device cpu``, else
over NCCL, a card a rank. Every refusal comes before the first collective,
on every rank alike; rank 0 alone prints the report. The reference's XLA
overlap flags have no counterpart: ``--overlap`` runs the port's own
overlapped pipeline.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core import connectivity as connectivity_lib
from repro_torch.core import dist_engine
from repro_torch.core import exchange as exchange_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.areas import mam_benchmark_spec, mam_spec
from repro_torch.core.engine import EngineConfig
from repro_torch.core.factory import make_simulation
from repro_torch.core.mesh import ProcessMesh
from repro_torch.device import resolve_device


class StopFlag:
    """SIGTERM/SIGINT -> "checkpoint at the next window boundary" flag.

    The handler only records the signal; the windowed run loop polls it
    through ``stop_requested`` after the window's device work has finished
    and stops there (drain, final checkpoint, ``Preempted``). A second
    signal kills the process.
    """

    def __init__(self):
        self.signum: int | None = None

    def __call__(self) -> bool:
        return self.signum is not None

    @property
    def name(self) -> str:
        return signal.Signals(self.signum).name if self.signum else "stop"

    def install(self) -> "StopFlag":
        def handler(signum, frame):
            del frame
            first = self.signum is None
            self.signum = signum
            if first:
                print(f"\n  caught {signal.Signals(signum).name}: finishing "
                      f"the current window, then checkpointing and exiting "
                      f"(repeat to kill immediately)", flush=True)
            else:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
        return self


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_loop(fn, dev, repeats: int = 3) -> float:
    """Best wall time of ``fn()`` over ``repeats`` calls after one warm-up,
    each ending in a device synchronize."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_phases(net, spec, cfg: EngineConfig, cycles: int = 200) -> None:
    """Per-phase timing table: where a cycle's wall time goes.

    Times each phase of the deliver -> update -> collocate cycle on its own,
    a loop of ``cycles`` iterations (best of 3), with the engine's own
    parameters (``resolve_params``), update closure and delivery functions,
    so it times the math ``Engine.run`` runs: ring read/clear (per cycle and
    blocked), neuron update, intra delivery, inter delivery (per cycle and
    the superstep's single pass per window), the full window, and the
    sequential against the overlapped pipeline.
    """
    from repro_torch.core import delivery, neuron as neuron_lib, ring_buffer
    from repro_torch.core.engine import make_fused_lif_update, resolve_params

    dev = net.device
    backend = cfg.backend
    A, n_pad = net.alive.shape
    D = net.delay_ratio
    lif_params, _ = resolve_params(net, spec, cfg)
    fused_lif = make_fused_lif_update(lif_params) if cfg.fused else None
    update_fn = schedule_lib.make_update_fn(cfg, spec, net.dt_ms, lif_params, fused_lif)
    gids = torch.arange(A * n_pad, dtype=torch.int32, device=dev).view(A, n_pad)
    eng = make_simulation(spec, cfg, net=net, device=dev)
    st = eng.init()
    st, blk = eng.window(st)  # a warmed-up state and a real spike raster
    ring0 = st.ring
    per_cycle = blk.reshape(D, -1).sum(1).cpu().numpy()
    sf = blk[int(np.argsort(per_cycle, kind="stable")[D // 2])].float()
    block_f = blk.float().reshape(D, -1)
    s_max_area, s_max_all = delivery.event_bounds(
        net, headroom=cfg.s_max_headroom, floor=cfg.s_max_floor)
    zeros = torch.zeros((A, n_pad), dtype=torch.float32, device=dev)

    def ph_read():
        r = ring0.clone()
        for t in range(cycles):
            ring_buffer.read_and_clear(r, t)

    def ph_read_block():
        r = ring0.clone()
        for w in range(cycles // D):
            ring_buffer.read_and_clear_block(r, w * D, D)

    def ph_update():
        ns = st.neuron
        for t in range(cycles):
            if cfg.neuron_model == "lif":
                ns, _ = update_fn(ns, zeros, t, net, gids)
            else:
                ns, _ = neuron_lib.ignore_and_fire_update(
                    ns, None, net.alive, net.rate_hz, net.dt_ms)

    def ph_intra():
        r = ring0.clone()
        for t in range(cycles):
            delivery.deliver_intra(r, sf, net, t, backend=backend, s_max=s_max_area)

    def ph_inter():
        r = ring0.clone()
        for t in range(cycles):
            delivery.deliver_inter(r, sf.reshape(-1), net, t, backend=backend,
                                   s_max=s_max_all)

    def ph_inter_block():
        r = ring0.clone()
        for w in range(cycles // D):
            delivery.deliver_inter_block(r, block_f, net, w * D, backend=backend,
                                         s_max=s_max_all)

    rows = [
        ("ring read/clear (per-cycle)", _time_loop(ph_read, dev)),
        ("ring read/clear (blocked)", _time_loop(ph_read_block, dev)),
        ("neuron update (+drive)", _time_loop(ph_update, dev)),
        ("intra deliver", _time_loop(ph_intra, dev)),
        ("inter deliver (per-cycle)", _time_loop(ph_inter, dev)),
        ("inter deliver (blocked)", _time_loop(ph_inter_block, dev)),
    ]
    print(f"\n-- phase profile: backend={backend}, {cycles} cycles each --")
    print(f"{'phase':30s} {'us/cycle':>10s} {'cycles/s':>12s}")
    for name, wall in rows:
        print(f"{name:30s} {wall / cycles * 1e6:10.2f} {cycles / wall:12.1f}")
    win = _time_loop(lambda: eng.window(st), dev)
    print(f"{'full window / D':30s} {win / D * 1e6:10.2f} {D / win:12.1f}")
    if cfg.schedule == schedule_lib.STRUCTURE_AWARE:
        # Sequential against the double-buffered pipeline over the same
        # windows (bitwise the same trajectory).
        eng_o = make_simulation(spec, dataclasses.replace(cfg, overlap_exchange=True),
                                net=net, device=dev)
        k = max(cycles // D, 1)
        seq = _time_loop(lambda: eng.run(st, k), dev)
        pipe = _time_loop(lambda: eng_o.run(st, k), dev)
        print(f"{f'window seq (run x{k})':30s} "
              f"{seq / (k * D) * 1e6:10.2f} {k * D / seq:12.1f}")
        print(f"{'window overlapped (pipeline)':30s} "
              f"{pipe / (k * D) * 1e6:10.2f} {k * D / pipe:12.1f}")
        print(f"  overlap hides {(seq - pipe) / k * 1e6:+.2f} us/window "
              f"({(seq - pipe) / seq * 100:+.1f}% of sequential wall) "
              f"on this host")


def print_wire_volume(net, spec, cfg: EngineConfig, n_groups: int, gsz: int):
    """Dense-vs-routed wire bytes per window (static accounting): shape and
    adjacency arithmetic (``exchange.wire_report``) for an ``n_groups x
    gsz`` structure-aware mesh, printable on one process; the distributed
    engines report the same numbers on ``Engine.wire_bytes``."""
    if (net.k_inter == 0 or n_groups < 2
            or net.n_areas % n_groups != 0 or net.n_pad % gsz != 0):
        print(f"\n-- wire volume: n/a (A={net.n_areas}, n_pad={net.n_pad} "
              f"on {n_groups} groups x {gsz})")
        return
    rep = exchange_lib.wire_report(
        net, connectivity_lib.area_adjacency(net, spec), backend=cfg.backend,
        n_groups=n_groups, gsz=gsz, headroom=cfg.s_max_headroom, floor=cfg.s_max_floor)
    dense, routed = rep["dense"], rep["routed"]
    print(f"\n-- wire volume (bytes/window, mesh-total, modelled for "
          f"{n_groups} groups x {gsz} subgroup, backend={cfg.backend}) --")
    print(f"{'exchange':10s} {'local':>12s} {'global':>12s} {'total':>12s}"
          f" {'rounds':>8s}")
    print(f"{'dense':10s} {dense['local_bytes']:12,d} "
          f"{dense['global_bytes']:12,d} {dense['total_bytes']:12,d} "
          f"{max(n_groups - 1, 0):8d}")
    print(f"{'routed':10s} {routed['local_bytes']:12,d} "
          f"{routed['global_bytes']:12,d} {routed['total_bytes']:12,d} "
          f"{routed['rounds']:8d}")
    # The adaptive two-phase model beside the static worst case.
    print(f"{'exchange':10s} {'counts':>12s} {'payload(exp)':>12s} "
          f"{'worst':>12s} {'saved':>12s}  (adaptive two-phase)")
    for name, entry in (("dense", dense), ("routed", routed)):
        ad = entry["adaptive"]
        if not ad["applies"]:
            print(f"{name:10s} {'n/a (bit-packed wire)':>12s}")
            continue
        print(f"{name:10s} {ad['counts_bytes']:12,d} "
              f"{ad['payload_bytes_expected']:12,d} "
              f"{ad['payload_bytes_worst']:12,d} {ad['saved_bytes']:12,d}")
    if net.tgt_inter is not None or net.tgt_inter_in is not None:
        sub = gsz if cfg.subgroup_inter_tables else 1
        tbl = exchange_lib.priced_inter_table_report(
            net, n_groups=n_groups, gsz=gsz, headroom=cfg.s_max_headroom,
            floor=cfg.s_max_floor, subgroup=sub)
        tb = tbl["table_bytes"]
        print(f"-- inter receive tables, per device: replicated "
              f"{tb['replicated']:,} B (K={tbl['k_out_replicated']}) vs "
              f"sharded {tb['sharded']:,} B (K={tbl['k_in_sharded']}, "
              f"{tbl['n_shards']} shards, {tb['reduction']:.1f}x)")


def _pick_mesh(n_dev: int, n_areas: int, n_pad: int):
    """A ``(data, model)`` mesh shape for the structure-aware placement: the
    largest area-parallel tier (groups) whose cuts hold (the areas divide
    into the groups, the padded area size into the subgroup); None if
    nothing fits."""
    for gsz in range(1, n_dev + 1):
        if n_dev % gsz:
            continue
        groups = n_dev // gsz
        if n_areas % groups == 0 and n_pad % gsz == 0:
            return groups, gsz
    return None


def _run_resilient(args, eng, net, exchange, n_windows):
    """The checkpointed / fault-injected leg of a run (``run_windows``):
    resumes from ``--checkpoint-dir`` when asked (resharding elastically
    when the group count changed), wires the fault injector into the run
    loop and the checkpoint writer, and turns a preemption into a clean
    exit with a resume hint. ``net`` is the whole network (its shapes). On a
    process group every rank runs it. Returns ``(state, wall_s,
    windows_run)``."""
    n_groups = schedule_lib.area_groups(eng)
    fault_cfg = faults_lib.parse_fault_specs(args.inject_fault, seed=args.seed)
    injector = None
    if fault_cfg.any_enabled:
        injector = faults_lib.FaultInjector(
            fault_cfg, n_devices=1 if eng.mesh is None else eng.mesh.size,
            delay_ratio=eng.delay_ratio)
        if fault_cfg.jitter_enabled:
            print(f"  fault injection: per-device jitter mu="
                  f"{fault_cfg.jitter_mu_ms} ms sigma="
                  f"{fault_cfg.jitter_sigma_ms} ms/cycle -> predicted "
                  f"straggler overhead "
                  f"{injector.predicted_jitter_s() * 1e3:.2f} ms/window "
                  f"(order-statistics sync model)")
        if fault_cfg.comm_enabled:
            print(f"  fault injection: exchange straggler mu="
                  f"{fault_cfg.comm_mu_ms} ms sigma="
                  f"{fault_cfg.comm_sigma_ms} ms/window -> predicted wall "
                  f"sequential {injector.predicted_sequential_s() * 1e3:.2f}"
                  f" (sum) vs overlapped "
                  f"{injector.predicted_overlap_s() * 1e3:.2f} ms/window "
                  f"(Clark E[max])")
    start_w = 0
    if args.resume:
        st, info = schedule_lib.restore_sim(
            args.checkpoint_dir, eng, net, exchange=exchange)
        start_w = int(info["step"])
        resh = info["reshard"]
        if resh is not None:
            print(f"  resumed window {start_w} from {args.checkpoint_dir}: "
                  f"elastic reshard {resh['old_n_groups']} -> "
                  f"{resh['new_n_groups']} groups "
                  f"({resh['moved_areas']} areas re-homed)")
        else:
            print(f"  resumed window {start_w} from {args.checkpoint_dir} "
                  f"on {n_groups} group(s)")
    else:
        st = eng.init()
    ckpt = None
    if args.checkpoint_dir:
        ckpt = schedule_lib.SimCheckpointer(
            args.checkpoint_dir, eng, net, every=args.checkpoint_every,
            keep=args.checkpoint_keep, exchange=exchange, injector=injector)
    remaining = n_windows - start_w
    if remaining <= 0:
        raise SystemExit(
            f"checkpoint already covers {start_w} windows >= the requested "
            f"{n_windows}; increase --t-ms or start a fresh run")
    # A throwaway warm-up window would advance the trajectory, so the
    # resilient leg pays the kernels' first use inside its first window.
    stop = StopFlag().install()
    try:
        res = schedule_lib.run_windows(
            eng, st, remaining, checkpointer=ckpt, faults=injector,
            stop_requested=stop)
    except faults_lib.Preempted as exc:
        leg = exc.result.windows_done
        why = f"caught {stop.name}" if stop() else "simulated preemption"
        hint = (f"checkpoint written to {exc.checkpoint_path} -- resume "
                f"with --resume --checkpoint-dir {exc.checkpoint_path}"
                if exc.checkpoint_path
                else "no --checkpoint-dir was given, so nothing was saved")
        print(f"  PREEMPTED ({why}) after window {exc.window} "
              f"({leg} this leg); {hint}")
        raise SystemExit(0)
    if res.overlapped:
        print(f"  overlapped pipeline: {res.drains} in-flight drain(s) at "
              f"checkpoint/end boundaries")
    if ckpt is not None:
        ckpt.close()
        if ckpt.retry_count:
            print(f"  checkpoint writer retried {ckpt.retry_count} "
                  f"transient write failure(s)")
        if ckpt.saved_windows:
            print(f"  checkpoints at windows {ckpt.saved_windows} "
                  f"(every {args.checkpoint_every}, "
                  f"keep {args.checkpoint_keep})")
    if res.injected_sleep_s:
        print(f"  injected jitter: {res.injected_sleep_s:.3f} s total, "
              f"measured {res.injected_sleep_s / res.windows_done * 1e3:.2f} "
              f"ms/window over {res.windows_done} windows")
    return res.state, float(res.window_times_s.sum()), res.windows_done


def _wire_received(mesh) -> float:
    """The mesh-total bytes that the exchange's gathers and rotations took
    in since ``comm.reset_stats()`` (a collective)."""
    mine = torch.tensor([float(comm.wire_received())], dtype=torch.float64, device=mesh.device)
    return float(comm.all_reduce(mine, mesh, mesh.axis_names)[0])


def _join_world(args, n_dev: int) -> None:
    """``init_process_group`` from the environment ``torch.distributed.run``
    sets: gloo when the ranks outnumber the host's cards or run on the
    host, NCCL (a card a rank) otherwise."""
    on_host = args.device == "cpu" or not torch.cuda.is_available()
    backend = "gloo" if on_host or n_dev > torch.cuda.device_count() else "nccl"
    dist.init_process_group(backend)


def main(argv=None) -> None:
    """The CLI. On a process group (``torch.distributed.run`` sets ``RANK``)
    rank 0 alone prints the report, and the world that the run joins after
    every refusal is left on the way out."""
    owned = not dist.is_initialized()
    try:
        if int(os.environ.get("RANK", "0")) == 0:
            _main(argv)
        else:
            with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
                _main(argv)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _main(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mam_benchmark",
                    choices=["mam", "mam_benchmark"])
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--areas", type=int, default=8,
                    help="areas (mam_benchmark only)")
    ap.add_argument("--n-per-area", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--t-ms", type=float, default=500.0)
    ap.add_argument("--schedule", default="structure_aware",
                    choices=["conventional", "structure_aware"])
    ap.add_argument("--neuron", default=None,
                    choices=[None, "lif", "ignore_and_fire"])
    ap.add_argument("--backend", default="",
                    choices=["", "onehot", "scatter", "pallas", "event"],
                    help="delivery backend (repro_torch.core.delivery); "
                         "default scatter")
    ap.add_argument("--exchange", default="dense",
                    choices=["dense", "routed"],
                    help="distributed global pathway (repro_torch.core.exchange): "
                         "mesh-wide collectives vs connectivity-routed "
                         "packet rounds (structure-aware schedule only; "
                         "ignored on a single process)")
    ap.add_argument("--replicated-inter-tables", action="store_true",
                    help="keep the replicated inter receive tables on every "
                         "rank instead of the sharded inbound slices "
                         "(distributed event/routed paths only)")
    ap.add_argument("--no-subgroup-inter-tables", action="store_true",
                    help="keep the per-group inbound slices (and the "
                         "lane-replicated outgoing intra tables) instead of "
                         "the subgroup-sliced layouts (structure-aware "
                         "distributed paths only)")
    ap.add_argument("--sharded-build", action="store_true",
                    help="host-free construction (EngineConfig.sharded_build): "
                         "each rank draws its own tables from the seeded "
                         "connectivity rules, no process holds the global "
                         "synapse tables; structure-aware event-backend legs "
                         "on a process group only")
    ap.add_argument("--seed", type=int, default=12,
                    help="network build seed (paper seeds: 12, 654, 91856)")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive two-phase exchange "
                         "(EngineConfig.adaptive_exchange): counts first, "
                         "then bucket-sized packets; SimState.overflow is "
                         "provably 0 and asserted after every run")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered window pipeline "
                         "(EngineConfig.overlap_exchange): window w's "
                         "long-range scatter runs at the top of window w+1 -- "
                         "bitwise the same trajectory, structure-aware "
                         "schedule only")
    ap.add_argument("--compare", action="store_true",
                    help="run both schedules, assert identical spikes")
    ap.add_argument("--compare-adaptive", action="store_true",
                    help="run every selected schedule with BOTH the static "
                         "and the adaptive exchange, assert bit-identical "
                         "spike counts and zero adaptive overflow")
    ap.add_argument("--compare-overlap", action="store_true",
                    help="run every structure-aware leg BOTH sequential and "
                         "overlapped, assert bit-identical spike counts; "
                         "with a jitter-only --inject-fault spec the legs "
                         "run through the fault harness and the pipelined "
                         "injected wall must beat the sequential one")
    ap.add_argument("--profile", action="store_true",
                    help="report per-phase timings (ring read/clear, update, "
                         "intra/inter deliver) and the dense-vs-routed wire "
                         "volume before the run")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="window-boundary SimState checkpoints through "
                         "checkpoint.AsyncWriter land here; enables the "
                         "resilient windowed run loop")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="checkpoint cadence in completed windows "
                         "(default 50)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="retain this many newest checkpoints (default 3)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from "
                         "--checkpoint-dir and continue -- bitwise-identical "
                         "to the uninterrupted run, elastically resharding "
                         "when the group count changed")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SPEC",
                    help="deterministic fault injection (repeatable): "
                         "'jitter:mu_ms=1.6,sigma_ms=0.3[,rho=R][,devices=N]"
                         "[,comm_mu_ms=M][,comm_sigma_ms=S]' per-device "
                         "compute jitter plus a per-window exchange "
                         "straggler, 'ckpt-io:fails=K' transient "
                         "checkpoint-write failures, 'preempt:window=W' "
                         "SIGTERM-style stop after W completed windows")
    ap.add_argument("--spikes-out", default=None,
                    help="write the final per-neuron spike_count to this "
                         ".npz (resume-equality checks)")
    ap.add_argument("--device", default=None,
                    help="where to run (default cuda, on a process group a "
                         "card a local rank; raises without a GPU); cpu runs "
                         "every rank on the host")
    args = ap.parse_args(argv)
    # --compare-overlap + a jitter-only fault spec is the one sanctioned
    # fault/compare combination: every leg sleeps through the same
    # deterministic draws, so the sequential and pipelined injected walls
    # are directly comparable (the paper's max-vs-sum claim).
    inject_compare = bool(args.inject_fault and args.compare_overlap)
    resilient = bool(args.checkpoint_dir or args.resume
                     or (args.inject_fault and not inject_compare))
    if resilient and (args.compare or args.compare_adaptive
                      or args.compare_overlap):
        raise SystemExit(
            "--checkpoint-dir/--resume/--inject-fault run one trajectory; "
            "they cannot be combined with --compare/--compare-adaptive/"
            "--compare-overlap (exception: --compare-overlap with a "
            "jitter-only --inject-fault spec)")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    compare_fault_cfg = None
    if inject_compare:
        if args.compare or args.compare_adaptive:
            raise SystemExit(
                "--inject-fault with --compare-overlap cannot also run "
                "--compare/--compare-adaptive legs")
        compare_fault_cfg = faults_lib.parse_fault_specs(
            args.inject_fault, seed=args.seed)
        if (compare_fault_cfg.preempt_after_window > 0
                or compare_fault_cfg.ckpt_write_failures > 0):
            raise SystemExit(
                "--compare-overlap only accepts jitter specs in "
                "--inject-fault; preempt/ckpt-io faults run one trajectory")
    wants_overlap = args.overlap or args.compare_overlap
    if wants_overlap and args.schedule == "conventional" and not args.compare:
        raise SystemExit(
            "--overlap/--compare-overlap need the structure-aware schedule "
            "(the conventional schedule has no window-end exchange to hide)")

    if args.model == "mam":
        spec = mam_spec(scale=args.scale)
        neuron = args.neuron or "lif"
    else:
        spec = mam_benchmark_spec(
            n_areas=args.areas, n_per_area=args.n_per_area,
            k_intra=args.k // 2, k_inter=args.k // 2)
        neuron = args.neuron or "ignore_and_fire"
    backend = args.backend or "scatter"
    needs_outgoing = backend == "event" or args.exchange == "routed"
    # The world this process joined (torch.distributed.run sets WORLD_SIZE).
    n_dev = int(os.environ.get("WORLD_SIZE", "1"))
    print(f"{args.model}: {spec.n_total:,} neurons / {spec.n_areas} areas, "
          f"K={spec.k_total}, D={spec.delay_ratio}, neuron={neuron}, "
          f"backend={backend}, exchange={args.exchange}, seed={args.seed}, "
          f"devices={n_dev}")

    n_pad_spec = spec.padded_area_size(1)
    if args.sharded_build:
        if backend != "event":
            raise SystemExit(
                "--sharded-build generates the event path's tables; run "
                "with --backend event")
        if args.replicated_inter_tables:
            raise SystemExit(
                "--sharded-build emits per-shard inbound slices; it cannot "
                "combine with --replicated-inter-tables")
        if n_dev <= 1:
            raise SystemExit(
                "--sharded-build needs a multi-device mesh (the single-host "
                "engine holds the whole network anyway)")
        if args.schedule == "conventional" and not args.compare:
            raise SystemExit(
                "--sharded-build targets the structure-aware placement; "
                "the conventional schedule slices a host-built network")
    runs_conventional = args.compare or args.schedule == "conventional"
    mesh = None
    if n_dev > 1:
        shape = _pick_mesh(n_dev, spec.n_areas, n_pad_spec)
        if shape is None:
            raise SystemExit(
                f"no (data, model) mesh over {n_dev} devices fits "
                f"A={spec.n_areas}, n_pad={n_pad_spec}")
        if runs_conventional and n_pad_spec % n_dev != 0:
            # The round-robin placement slices every area over all ranks.
            raise SystemExit(
                f"the conventional schedule needs n_pad={n_pad_spec} "
                f"divisible by {n_dev} devices (pick --n-per-area "
                "accordingly, or run --schedule structure_aware)")
        # Every refusal is behind us: join the world (the first collective).
        _join_world(args, n_dev)
        mesh = ProcessMesh(shape, ("data", "model"),
                           device="cpu" if args.device == "cpu" else None)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    # The global network: skipped when every leg builds its tables
    # host-free; the conventional --compare legs and the profiler need it.
    needs_host_net = not args.sharded_build or runs_conventional or args.profile
    net = (connectivity_lib.build_network(spec, seed=args.seed, outgoing=needs_outgoing,
                                          device=dev)
           if needs_host_net else None)
    if mesh is not None:
        print(f"mesh: {mesh.shape['data']} area groups x {mesh.shape['model']} "
              f"subgroup devices")

    base_cfg = EngineConfig(
        neuron_model=neuron, schedule=args.schedule,
        delivery_backend=backend, seed=42)
    if args.profile and (mesh is None or mesh.rank == 0):
        profile_phases(net, spec, base_cfg)
        n_groups, gsz = (
            (mesh.shape["data"], mesh.shape["model"]) if mesh is not None
            else _pick_mesh(8, net.n_areas, net.n_pad) or (1, 8))
        print_wire_volume(net, spec, base_cfg, n_groups, gsz)

    schedules = ([args.schedule] if not args.compare
                 else ["conventional", "structure_aware"])
    adaptives = [False, True] if args.compare_adaptive else [args.adaptive]
    n_dev = 1 if mesh is None else mesh.size
    spikes = {}
    injected = {}
    for sched in schedules:
        for adaptive in adaptives:
            overlaps = ([False, True]
                        if args.compare_overlap and sched == "structure_aware"
                        else [args.overlap and sched == "structure_aware"])
            for overlap_on in overlaps:
                # The routed exchange routes the structure-aware window's
                # lumped global pathway; the conventional schedule runs dense.
                exchange = args.exchange if sched == "structure_aware" else "dense"
                sharded_leg = (args.sharded_build and mesh is not None
                               and sched == "structure_aware")
                cfg = EngineConfig(
                    neuron_model=neuron, schedule=sched,
                    delivery_backend=backend,
                    exchange=exchange if mesh is not None else "", seed=42,
                    shard_inter_tables=not args.replicated_inter_tables,
                    subgroup_inter_tables=not args.no_subgroup_inter_tables,
                    adaptive_exchange=adaptive, overlap_exchange=overlap_on,
                    sharded_build=sharded_leg)
                leg_net = net
                if sharded_leg:
                    t0 = time.perf_counter()
                    eng = make_simulation(spec, cfg, mesh=mesh, build_seed=args.seed)
                    _sync(dev)
                    print(f"  sharded build: tables generated host-free in "
                          f"{time.perf_counter() - t0:.2f} s "
                          f"(no global tensors materialised)")
                    # The run loop reads the whole network's shapes only.
                    leg_net = dist_engine.shape_network(spec, device=dev)
                else:
                    eng = make_simulation(spec, cfg, net=net, mesh=mesh, device=dev)
                n_windows = spec.steps_for(args.t_ms) // spec.delay_ratio
                comm.reset_stats()
                if resilient:
                    st, wall, windows_run = _run_resilient(
                        args, eng, leg_net, exchange, n_windows)
                elif inject_compare:
                    # The same deterministic draws for every leg: the
                    # injected walls realize the sum-vs-max quantities the
                    # sync model prices.
                    injector = faults_lib.FaultInjector(
                        compare_fault_cfg, n_devices=n_dev, delay_ratio=eng.delay_ratio)
                    res = schedule_lib.run_windows(eng, eng.init(), n_windows,
                                                   faults=injector)
                    st = res.state
                    wall = float(res.window_times_s.sum())
                    windows_run = res.windows_done
                    injected[(sched, adaptive, overlap_on)] = res.injected_sleep_s
                else:
                    st, _ = eng.window(eng.init())  # the kernels' first use
                    _sync(dev)
                    t0 = time.perf_counter()
                    st, _ = eng.run(st, n_windows - 1)
                    _sync(dev)
                    wall = time.perf_counter() - t0
                    windows_run = n_windows - 1
                # The wire as counted by comm, over the windows this leg ran
                # (the warm-up window included); whole-state gathers apart.
                executed = windows_run if resilient or inject_compare else n_windows
                measured = 0.0 if mesh is None else _wire_received(mesh) / max(executed, 1)
                # The whole network's counts (a collective on a mesh).
                count = (st.spike_count if mesh is None
                         else eng.gather_state(st).spike_count).cpu().numpy()
                t_s = float(st.t) * spec.dt_ms / 1000.0
                rate = float(count.sum()) / (spec.n_total * t_s)
                rtf = wall / (max(windows_run, 1) * spec.delay_ratio * spec.dt_ms / 1000)
                overflow = int(st.overflow)
                wire = eng.wire_bytes or {}
                wire_s = (f", {wire['total_bytes']:,} wire B/window (static)"
                          if wire.get("total_bytes") else "")
                meas_s = f", {measured:,.0f} measured B/window" if measured else ""
                mode = ("adaptive" if adaptive else "static") + \
                       ("+overlap" if overlap_on else "")
                print(f"  {sched:16s} "
                      f"({exchange if mesh is not None else 'local'}/{mode}):"
                      f" {wall:6.2f} s wall, RTF {rtf:8.1f}, "
                      f"mean rate {rate:5.2f} Hz, "
                      f"{int(count.sum()):,} spikes{wire_s}{meas_s}"
                      + (f", OVERFLOW {overflow} (raise s_max!)"
                         if overflow else ""))
                if adaptive and overflow:
                    raise SystemExit(
                        "adaptive exchange reported nonzero overflow -- the "
                        "two-phase sizing is broken (this must be impossible)")
                spikes[(sched, adaptive, overlap_on)] = count
                if args.spikes_out and (mesh is None or mesh.rank == 0):
                    np.savez(args.spikes_out, spike_count=count, t=int(st.t))
                    print(f"  spike counts -> {args.spikes_out}")

    if args.compare:
        for adaptive in adaptives:
            ref = spikes[("conventional", adaptive, False)]
            for (sched, ad, ovl), spk in spikes.items():
                if sched == "conventional" or ad != adaptive:
                    continue
                same = np.array_equal(ref, spk)
                mode = ("adaptive" if ad else "static") + \
                       ("+overlap" if ovl else "")
                print(f"\nschedules produce identical spike counts "
                      f"({mode}): {same}")
                if not same:
                    raise SystemExit(1)
    if args.compare_adaptive:
        for sched in schedules:
            for ovl in sorted({o for (s, _, o) in spikes if s == sched}):
                same = np.array_equal(spikes[(sched, False, ovl)],
                                      spikes[(sched, True, ovl)])
                print(f"adaptive == static spike counts "
                      f"({sched}{'/overlap' if ovl else ''}): {same}")
                if not same:
                    raise SystemExit(1)
    if args.compare_overlap:
        for (sched, adaptive, ovl) in sorted(spikes):
            if not ovl:
                continue
            same = np.array_equal(spikes[(sched, adaptive, False)],
                                  spikes[(sched, adaptive, True)])
            mode = "adaptive" if adaptive else "static"
            print(f"overlapped == sequential spike counts "
                  f"({sched}/{mode}): {same}")
            if not same:
                raise SystemExit(1)
        if inject_compare and compare_fault_cfg.comm_enabled:
            for (sched, adaptive, ovl), pipe_wall in sorted(injected.items()):
                if not ovl:
                    continue
                seq_wall = injected[(sched, adaptive, False)]
                mode = "adaptive" if adaptive else "static"
                print(f"injected wall ({sched}/{mode}): sequential "
                      f"{seq_wall:.3f} s (sum) vs pipelined "
                      f"{pipe_wall:.3f} s (max) -- "
                      f"{(1 - pipe_wall / seq_wall) * 100:.1f}% hidden")
                if not pipe_wall < seq_wall:
                    raise SystemExit(
                        "pipelined injected wall failed to beat the "
                        "sequential wall under jitter -- the overlap is "
                        "not hiding the exchange")


if __name__ == "__main__":
    main()
