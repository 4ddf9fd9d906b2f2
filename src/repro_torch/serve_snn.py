"""Simulation-as-a-service: batched multi-tenant SNN trials.

The port of ``examples/serve_snn.py``, the SNN analogue of ``serve_lm.py``:
instead of prompts and tokens, tenants submit *trials* -- ``(seed, stimulus
scale, duration)`` -- against one shared multi-area network, and the server
folds up to ``--batch`` of them into a single block-diagonal super-network
dispatch (:mod:`repro_torch.launch.serve`). Each trial's spike train is
bitwise identical to running it alone. Submitter threads play the tenants:
they race submissions, stream per-window spike blocks as their trial
advances, and collect the full train at the end. Reports trials/s and
p50/p99 time-to-result, then cross-checks a sample trial against its
sequential reference. Runs on the GPU unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.serve_snn
    PYTHONPATH=src python -m repro_torch.serve_snn --device cpu --batch 8 --trials 24
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core.areas import mam_spec
from repro_torch.core.engine import EngineConfig
from repro_torch.core.neuron import LIFParams
from repro_torch.device import resolve_device
from repro_torch.launch.serve import SimServer, TrialRequest, sequential_reference

__all__ = ["main"]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.001,
                    help="MAM downscale factor")
    ap.add_argument("--batch", type=int, default=4,
                    help="trials folded per dispatch")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--windows", type=int, default=4,
                    help="trial duration in D-cycle windows")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; it raises when there is no GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = mam_spec(scale=args.scale)
    # Short-horizon demo regime: lowered LIF threshold so trials spike
    # within a window or two, per-area packet floor at the population
    # bound so nothing clips (overflow == 0 is the fold's exactness
    # condition; see repro_torch.launch.serve).
    cfg = EngineConfig(delivery_backend="event",
                       lif=LIFParams(v_th_mv=2.0),
                       s_max_floor=max(16, spec.padded_area_size(1)))

    rng = np.random.default_rng(0)
    requests = [
        TrialRequest(seed=int(rng.integers(1, 2**31)),
                     stim=float(rng.uniform(0.9, 1.1)),
                     windows=args.windows)
        for _ in range(args.trials)
    ]

    print(f"starting server: MAM x{args.scale} ({spec.n_areas} areas), "
          f"batch {args.batch}, on {dev}; warming the folded window...")
    results = {}
    with SimServer(spec, cfg, max_batch=args.batch,
                   max_windows=args.windows, device=dev) as server:
        server.install_sigterm()  # SIGTERM drains in-flight, rejects new

        def tenant(i: int, req: TrialRequest) -> None:
            windows_seen = []
            handle = server.submit(
                req, on_block=lambda w, rows: windows_seen.append(w))
            res = handle.result(timeout=1200)
            results[i] = res
            print(f"  tenant {i:2d}: seed={req.seed:<10d} "
                  f"stim={req.stim:.2f}  {res.spikes.sum():6d} spikes "
                  f"in {res.spikes.shape[0]} cycles  "
                  f"(streamed {len(windows_seen)} windows, "
                  f"latency {res.latency_s * 1e3:7.1f} ms)")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(i, r))
                   for i, r in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = server.stats()

    print(f"\nserved {stats['trials']} trials in {wall:.2f} s "
          f"({stats['trials']/wall:.2f} trials/s, "
          f"p50 {stats['p50_ms']:.0f} ms, p99 {stats['p99_ms']:.0f} ms)")

    # The bitwise claim, spot-checked: one served trial rerun alone.
    sample = results[0]
    assert sample.overflow == 0
    ref = sequential_reference(spec, cfg, sample.request, device=dev)
    assert np.array_equal(sample.spikes, ref), "served trial != solo rerun"
    print("spot check: served spike train == solo rerun, bitwise")


if __name__ == "__main__":
    main()
