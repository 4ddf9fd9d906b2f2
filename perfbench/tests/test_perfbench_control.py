"""The comparison fails what it must: the control (the reference computed
in bfloat16, the precision below the configuration's float32) and the
faults a cell can have, planted under the timed path while the harness
drives the rest of a run."""

import pytest

torch = pytest.importorskip("torch")

from perfbench import control, harness, judge  # noqa: E402
from perfbench.reference.network import NetDesc  # noqa: E402
from perfbench.tests import cells  # noqa: E402

SEED = 2**31 + 777


def _control_counts(model: str, n_windows: int = 30) -> dict:
    desc = NetDesc.from_config(cells.bench_config()["network"])
    return control.control_counts(desc, model, SEED, n_windows, "cpu")


@pytest.mark.parametrize("model", ["lif", "ignore_and_fire"])
def test_the_bfloat16_control_fails(model):
    counts = _control_counts(model)
    assert any(v > judge.LIMITS[k] for k, v in counts.items()), counts


FAULTS = ["state_unchanged", "half_left_out", "exchange_left_out", "spike_altered"]


def _keep_exchange(monkeypatch):
    """Let ``exchange_left_out`` patch the exchange, and undo it."""
    from repro_torch.core import exchange

    monkeypatch.setattr(exchange.LocalExchange, "window_end", exchange.LocalExchange.window_end)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("route,model", [("iaf.pallas-fused", "ignore_and_fire"),
                                         ("iaf.event-fused", "ignore_and_fire"),
                                         ("iaf.pallas-fused", "lif")])
def test_a_planted_fault_fails_the_run(route, model, fault, monkeypatch):
    _keep_exchange(monkeypatch)
    result = harness.run(cells.cell(route, neuron_model=model), seed=SEED, seconds=0.2,
                         trace=False, device="cpu", tamper=f"perfbench.tests.faults:{fault}")
    assert not result["correct"], result["checks"]
    assert result["failed"] == result["attempted"] > 0
