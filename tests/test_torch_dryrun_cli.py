"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU:
the build peaks measured (``VmHWM``), the HBM gate's exit code and rows,
and the CLI's refusals.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_measure_build_rss_on_the_cpu():
    row = dryrun.measure_build_rss(device="cpu")  # 8 x 4096, K 256: tables dominate
    assert row["measured"] == "VmHWM"
    assert row["status"] == "OK", row
    assert 0 < row["sharded_peak_mib"] < row["host_peak_mib"]


def test_cli_exits_nonzero_on_a_failing_hbm_gate(tmp_path):
    out = tmp_path / "rows.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--hbm-gib", "2", "--mesh", "single", "--snn-schedule",
         "structure_aware", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 1, run.stdout + run.stderr
    rows = json.loads(out.read_text())
    assert [r["status"] for r in rows[:2]] == ["OK", "OK"]
    # The gate holds the priced peak (tables and state, 1.26 GiB, plus a
    # window's transient: the one-hot deposit's), not the held bytes alone.
    peak = rows[2]["rank_bytes"]["peak"] / 2**30
    assert rows[2]["rank_bytes"]["total"] / 2**30 < 2 < peak
    assert rows[2]["status"].startswith(f"FAIL(HBM: modelled {peak:.2f} GiB/rank exceeds")
    assert "1 FAIL" in run.stdout
    # The same cells within budget pass.
    budget = str(int(peak) + 1)
    assert dryrun.main(["--device", "cpu", "--hbm-gib", budget, "--mesh", "single"]) == 0


def test_cli_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1b", "--device", "cpu", "--hbm-gib", "16"])
    assert e.value.code == 2 and "unknown ['qwen2-1b']" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--device", "cpu"])
    assert e.value.code == 2 and "--hbm-gib must be given" in capsys.readouterr().err
    assert "XLA_FLAGS" not in Path(dryrun.__file__).read_text()
