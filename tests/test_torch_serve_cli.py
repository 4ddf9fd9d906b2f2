"""The port's serving entry points on the CPU: each asks for the GPU by
default; ``python -m repro_torch.launch.serve --selftest --device cpu``
(16 mixed trials folded 8 at a time, each bitwise its sequential
reference, overflow 0) as a subprocess; and ``repro_torch.serve_snn``.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

from repro_torch import serve_snn
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import SimServer, serve_simulation
from test_torch_serve import REPO, _cfg, _spec


ENTRY_POINTS = {
    "SimServer": lambda: SimServer(_spec(), _cfg(), max_batch=1, max_windows=2),
    "serve_simulation": lambda: serve_simulation(_spec(), _cfg(), max_batch=1,
                                                 max_windows=2),
    "cli": lambda: tserve.main(["--selftest", "--scale", "0.002"]),
    "serve_snn": lambda: serve_snn.main(["--trials", "1"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Without a device argument every entry point asks for the GPU, and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ENTRY_POINTS[entry]()


def test_cli_selftest_on_cpu():
    """``python -m repro_torch.launch.serve --selftest --device cpu``: 16
    mixed trials folded 8 at a time, each bitwise its sequential reference."""
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--selftest",
         "--device", "cpu", "--scale", "0.002"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "selftest OK: 16 trials bitwise-identical" in run.stdout


def test_serve_snn_on_cpu(capsys):
    """The serving example: submitter threads, streaming, stats and the
    spot check of one trial against its solo rerun."""
    try:
        serve_snn.main(["--device", "cpu", "--trials", "3", "--batch", "2",
                        "--windows", "2"])
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    out = capsys.readouterr().out
    assert "served 3 trials" in out
    assert "spot check: served spike train == solo rerun, bitwise" in out
    assert out.count("tenant ") == 3
