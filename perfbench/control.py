"""The control of a cell's comparison, run on the card at the cell's size.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --windows <n>

For each seed it computes the plain reference twice over ``n`` windows
(the warm-up's and the timed window's, as a run makes them): in float32,
the precision the configuration states, and in bfloat16, the precision
below it (the state and the ring held in bfloat16). It prints the counts of
disagreement between the two under the cell's comparison
(:func:`perfbench.judge.compare`), one JSON line a seed. The control has to
fail the comparison: some count over its limit of 0. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness, judge  # noqa: E402
from perfbench.reference import simulate  # noqa: E402
from perfbench.reference.network import NetDesc  # noqa: E402


def control_counts(desc: NetDesc, model: str, seed: int, n_windows: int, device) -> dict:
    """The control's counts of disagreement with the reference."""
    build, drive = harness.seeds(seed)
    block = simulate.Block(desc)
    if model == "lif":
        csr = simulate.build_csr(desc, build, device)
        ref = simulate.lif_replay(desc, csr, drive, n_windows, device)
        low = simulate.lif_replay(desc, csr, drive, n_windows, device, dtype=torch.bfloat16)
    else:
        ref = simulate.iaf_outputs(desc, build, block, n_windows, device)
        low = simulate.iaf_outputs(desc, build, block, n_windows, device, dtype=torch.bfloat16)
    return judge.compare(low, ref, desc.alive(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--windows", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, ROOT)
    desc = NetDesc.from_config(cell.config["network"])
    model = cell.traffic["engine"]["neuron_model"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        counts = control_counts(desc, model, seed, args.windows, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "windows": args.windows,
                          "control": counts, "fails": not judge.passed(counts),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
