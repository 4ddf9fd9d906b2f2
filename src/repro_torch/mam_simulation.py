"""End-to-end driver: simulate the (downscaled) multi-area model of macaque
visual cortex in its ground state -- the paper's real-world workload (§2.4.3).

The port of ``examples/mam_simulation.py``. Runs the full pipeline:
heterogeneous 32-area spec -> connectivity build with ghost-neuron padding
-> structure-aware engine -> 1 s of biological time -> per-area rate report
(V2 should be the most active area, network mean near 2.5 spikes/s). It
prints the reference's lines; only the wall time and the RTF differ.

    PYTHONPATH=src python -m repro_torch.mam_simulation --scale 0.002 --t-ms 1000
    PYTHONPATH=src python -m repro_torch.mam_simulation --device cpu

:func:`simulate` is the run itself, for callers that bring their own config
(another delivery backend, the fused window) or a network built once.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, build_network, make_simulation, mam_spec
from repro_torch.core.areas import MAM_AREA_NAMES, MultiAreaSpec
from repro_torch.core.connectivity import Network
from repro_torch.core.schedule import SimState
from repro_torch.device import resolve_device

__all__ = ["MamRun", "build_mam_network", "simulate", "report", "main"]


@dataclasses.dataclass
class MamRun:
    """One driver run: per-area spike counts and rates over the simulated
    ``t_s`` seconds, the final state, the spikes the event packets dropped
    and the wall time of the timed windows."""

    counts: np.ndarray   # [A] int64 spikes per area
    rates: np.ndarray    # [A] f64 Hz per area
    mean_rate: float     # Hz over the whole network
    t_s: float           # simulated seconds
    state: SimState
    overflow: int
    wall_s: float        # all windows but the first (untimed) one


def build_mam_network(spec: MultiAreaSpec, *, outgoing: bool = False, device=None) -> Network:
    """The driver's network: build seed 12, areas padded to a multiple of 8;
    ``outgoing`` adds the event backend's tables."""
    return build_network(spec, seed=12, size_multiple=8, outgoing=outgoing,
                         device=resolve_device(device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def simulate(spec: MultiAreaSpec, config: EngineConfig, *, device=None,
             net: Network | None = None, t_ms: float = 1000.0) -> MamRun:
    """Run ``spec`` under ``config`` for ``t_ms`` of model time on
    ``device`` (default ``"cuda"``): one untimed window, then the rest timed
    between two synchronizes. ``net`` (default :func:`build_mam_network`)
    must live on ``device``."""
    dev = resolve_device(device)
    if net is None:
        net = build_mam_network(spec, outgoing=config.backend == "event", device=dev)
    eng = make_simulation(spec, config, net=net, device=dev)
    st = eng.init()
    n_windows = spec.steps_for(t_ms) // spec.delay_ratio
    st, _ = eng.window(st)
    _sync(dev)
    t0 = time.perf_counter()
    st, _ = eng.run(st, n_windows - 1)
    _sync(dev)
    wall = time.perf_counter() - t0

    counts = st.spike_count.cpu().numpy().sum(axis=1)  # per area
    sizes = spec.area_sizes()
    t_s = float(st.t) * spec.dt_ms / 1000.0
    return MamRun(counts=counts, rates=counts / (sizes * t_s),
                  mean_rate=counts.sum() / (spec.n_total * t_s), t_s=t_s, state=st,
                  overflow=int(st.overflow), wall_s=wall)


def report(spec: MultiAreaSpec, res: MamRun) -> list[str]:
    """The driver's report of a run: wall time, RTF and network mean rate,
    the eight most active areas and the hottest one."""
    sizes = spec.area_sizes()
    t_s, wall, rates = res.t_s, res.wall_s, res.rates
    lines = [f"\nsimulated {t_s*1000:.0f} ms in {wall:.1f} s wall "
             f"(RTF {wall/t_s:.1f}); network mean rate {res.mean_rate:.2f} Hz "
             f"(ground state target ~2.5 Hz)",
             "\nper-area rates (top 8):"]
    order = np.argsort(-rates)
    for i in order[:8]:
        lines.append(f"  {MAM_AREA_NAMES[i]:5s} {rates[i]:5.2f} Hz "
                     f"({sizes[i]:,} neurons)")
    lines.append(f"\nhottest area: {MAM_AREA_NAMES[order[0]]} "
                 f"(paper: V2, ~68% above network mean)")
    return lines


def main(argv=None) -> MamRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.002,
                    help="model scale (1.0 = full 4.2M-neuron MAM)")
    ap.add_argument("--t-ms", type=float, default=1000.0)
    ap.add_argument("--schedule", default="structure_aware",
                    choices=["conventional", "structure_aware"])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = mam_spec(scale=args.scale)
    print(f"MAM @ scale {args.scale}: {spec.n_total:,} neurons in 32 areas, "
          f"K={spec.k_total}/neuron ({spec.k_inter} inter-area), "
          f"D={spec.delay_ratio}")
    net = build_mam_network(spec, device=dev)
    ghost = float((~net.alive.cpu().numpy()).mean())
    print(f"ghost-neuron padding (heterogeneous areas -> N_max): {ghost:.1%}")

    res = simulate(spec, EngineConfig(neuron_model="lif", schedule=args.schedule,
                                      delivery_backend="scatter"),
                   device=dev, net=net, t_ms=args.t_ms)
    print("\n".join(report(spec, res)))
    return res


if __name__ == "__main__":
    main()
