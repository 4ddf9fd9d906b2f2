"""The plain reference against ``repro_torch`` on the CPU, through the
harness, on the routes of the benchmark's cells at small sizes: every
count of disagreement is 0, and the runs did spike."""

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness, judge  # noqa: E402
from perfbench.tests import cells  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be


def _report(cell, seed=SEED, seconds=0.25):
    return harness._body(cell, seed=seed, seconds=seconds, trace=False, device="cpu",
                         t_start=0.0)


@pytest.mark.parametrize("route,model,config", [
    ("iaf.pallas-fused", "ignore_and_fire", "bench"),
    ("iaf.event-fused", "ignore_and_fire", "bench"),
    ("iaf.pallas-fused", "ignore_and_fire", "mam"),
    ("iaf.pallas-fused", "lif", "bench"),
    ("iaf.pallas-fused", "lif", "mam"),
])
def test_reference_agrees_with_the_port(route, model, config):
    cfg = cells.bench_config() if config == "bench" else cells.mam_config()
    report = _report(cells.cell(route, cfg, neuron_model=model))
    assert report["area_counts"].sum() > 0, "the run fired no spike: the check would be empty"
    assert report["n_timed"] > 0
    assert all(report["checks"][name] == 0 for name in judge.NAMES), report["checks"]


def test_seeds_change_the_network_and_the_drive():
    a, b = harness.seeds(SEED), harness.seeds(SEED + 1)
    assert a != b and all(0 <= x < 2**32 for x in a + b)
    assert harness.seeds(SEED) == a
