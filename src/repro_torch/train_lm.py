"""Train a language model with the two-tier hierarchical trainer.

The port of ``examples/train_lm.py``: two emulated pods run local steps
every step and synchronise (int8-compressed, error feedback) every D = 5
steps; the loss falls below log(V) because the synthetic stream has planted
bigram structure. The run is a checkpointed first half, a simulated crash,
and a resume from the latest checkpoint for the second half, each a process
of ``python -m repro_torch.launch.train``:

    PYTHONPATH=src python -m repro_torch.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.train_lm            # GPU
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    base = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch, "--reduced",
        "--global-batch", "8", "--seq-len", "64", "--lr", "1e-3",
        "--pods", "2", "--sync-every", "5", "--compression", "int8",
        "--ckpt-dir", tmp, "--ckpt-every", "25",
    ]
    if args.device is not None:
        base += ["--device", args.device]
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))}
    try:
        # phase 1: train half the steps, checkpointing
        subprocess.run(base + ["--steps", str(args.steps // 2)], check=True, env=env)
        print("\n--- simulated crash; resuming from latest checkpoint ---\n", flush=True)
        # phase 2: resume and finish
        subprocess.run(base + ["--steps", str(args.steps), "--resume"], check=True, env=env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("\ndone: hierarchical (D=5, int8+EF) training with crash-resume.")


if __name__ == "__main__":
    main()
