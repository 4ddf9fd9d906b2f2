"""Quickstart: the paper's claim on the GPU, with the port's CUDA kernels.

Builds a small 4-area network, runs the conventional and the structure-aware
schedules side by side on the ``pallas`` backend (the CUDA ``lif_update`` and
``spike_deliver`` kernels), and checks that they produce *bit-identical*
spike trains while the structure-aware one makes 10x fewer global exchanges.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the GPU
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    EngineConfig, build_network, make_simulation, mam_benchmark_spec,
)
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--t-ms", type=float, default=200.0, help="model time")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = mam_benchmark_spec(n_areas=4, n_per_area=256, k_intra=32, k_inter=32)
    print(f"network: {spec.n_areas} areas x {spec.areas[0].n_neurons} neurons, "
          f"K={spec.k_total} synapses/neuron, D={spec.delay_ratio} "
          f"(d_min={spec.dt_ms} ms, d_min_inter={spec.d_min_inter_ms} ms), on {dev}")
    net = build_network(spec, seed=12, device=dev)

    n_windows = spec.steps_for(args.t_ms) // spec.delay_ratio
    spikes = {}
    for sched in ("conventional", "structure_aware"):
        eng = make_simulation(spec, EngineConfig(
            neuron_model="lif", schedule=sched, delivery_backend="pallas"),
            net=net, device=dev)
        st, blk = eng.window(eng.init())  # builds the kernels on first use
        blocks = [blk]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n_windows - 1):
            st, blk = eng.window(st)
            blocks.append(blk)
        spikes[sched] = torch.cat(blocks).cpu()
        wall = time.perf_counter() - t0
        rate = int(spikes[sched].sum()) / (spec.n_total * args.t_ms / 1000)
        n_globals = n_windows * (spec.delay_ratio if sched == "conventional" else 1)
        print(f"{sched:16s}: {wall:5.2f} s wall for {args.t_ms:.0f} ms model time | "
              f"rate {rate:4.1f} Hz | {n_globals:4d} global exchanges")

    identical = torch.equal(spikes["conventional"], spikes["structure_aware"])
    print(f"\nspike trains bit-identical: {identical}")
    assert identical, "the structure-aware schedule must be exact!"
    print("=> same physics, 10x fewer global synchronizations (paper §2.1)")


if __name__ == "__main__":
    main()
