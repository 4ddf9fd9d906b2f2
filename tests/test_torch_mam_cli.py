"""The port's MAM driver CLI (``python -m repro_torch.mam_simulation``)
against the JAX package's (``examples/mam_simulation.py``), both as
subprocesses at ``--scale 0.002``, 100 ms: equal printed lines apart from
the wall time and the RTF; and the driver's default device.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import mam_simulation  # noqa: E402
from repro_torch.core import EngineConfig, mam_spec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALE, T_MS = 0.002, 100.0


def _config(schedule: str) -> EngineConfig:
    return EngineConfig(neuron_model="lif", schedule=schedule, delivery_backend="scatter")


WALL = re.compile(r"in [0-9.]+ s wall \(RTF [0-9.]+\)")


def _lines(cmd) -> list[str]:
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-3000:]
    return [WALL.sub("in <wall>", ln) for ln in run.stdout.splitlines()]


def test_cli_prints_the_jax_cli_lines():
    args = ["--scale", str(SCALE), "--t-ms", str(T_MS), "--schedule", "structure_aware"]
    port = _lines([sys.executable, "-m", "repro_torch.mam_simulation", "--device", "cpu",
                   *args])
    ref = _lines([sys.executable, "examples/mam_simulation.py", *args])
    assert port == ref
    assert sum("<wall>" in ln for ln in port) == 1
    assert any(ln.startswith("hottest area: ") for ln in port)


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mam_simulation.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mam_simulation.main([])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mam_simulation.simulate(mam_spec(scale=SCALE), _config("structure_aware"))
