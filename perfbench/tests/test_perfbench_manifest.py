"""``BENCHMARK.json`` against the benchmark's contract, every cell resolved
to its files, and the result line's shape."""

import json
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.tests import cells  # noqa: E402

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    reporting = {m["name"]: set(m.get("workloads", CELLS)) for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # every cell it lists reports the metric it moves
        assert set(m.get("workloads", [])) <= reporting[m["moves"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell.traffic["engine"]["neuron_model"] in ("lif", "ignore_and_fire")
    reported = {n for n, _ in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for metric, _ in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_metric(metric).read)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_the_configuration_file_is_the_program_spec(config):
    """The builder's spec is the network the file describes, and the file
    names the source and the keys it changed."""
    from repro_torch.core.engine import EngineConfig
    from perfbench.reference.network import NetDesc

    data = json.loads((ROOT / config["file"]).read_text())
    desc = NetDesc.from_config(data["network"])
    assert harness.spec_drift(harness.program_spec(data), desc, EngineConfig().lif) == []
    assert data["reduced"] == config["reduced"] and data["source"] == config["source"]
    assert all(data["args"][k] != data["published"][k] for k in data["reduced"])


def test_the_result_line_has_the_contract_keys():
    result = harness.run(cells.cell("iaf.event-fused"), seed=5, seconds=0.1, trace=False,
                         device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"rtf", "window_p95_ms", "setup_s"} <= set(result["metrics"])
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    json.dumps(result)


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    """On a machine with no CUDA device the command prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_py(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """A directory that holds only the benchmark (no program) gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
