"""The port's MAM driver (``repro_torch.mam_simulation``) against the JAX
package's (``examples/mam_simulation.py``).

The driver function against the JAX driver's own steps (the same spec,
build and config through ``repro.core``) at ``--scale 0.002``, 100 ms, both
schedules; the scatter backend's row chunks (which let the driver run at
scale 0.2 on one card) against one whole-table pass. Tolerance: bitwise
spike counts, ``t``, rings, ``v`` and ``refrac``; ``i_syn`` bitwise once
its subnormals are flushed to zero, as the jitted reference flushes them
on the CPU. The CLIs: ``test_torch_mam_cli.py``.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import build_network as jax_build  # noqa: E402
from repro.core import make_simulation as jax_make  # noqa: E402
from repro.core import mam_spec as jax_mam_spec  # noqa: E402
from repro_torch import mam_simulation  # noqa: E402
from repro_torch.core import EngineConfig, delivery, mam_spec  # noqa: E402

SCALE, T_MS = 0.002, 100.0


def jax_driver(schedule: str):
    """``examples/mam_simulation.py``'s steps: build, one window, the rest."""
    spec = jax_mam_spec(scale=SCALE)
    net = jax_build(spec, seed=12, size_multiple=8)
    eng = jax_make(spec, JaxConfig(neuron_model="lif", schedule=schedule,
                                   delivery_backend="scatter"), net=net)
    st = eng.init()
    n_windows = spec.steps_for(T_MS) // spec.delay_ratio
    st, _ = eng.window(st)
    st, _ = eng.run(st, n_windows - 1)
    return st


def _config(schedule: str) -> EngineConfig:
    return EngineConfig(neuron_model="lif", schedule=schedule, delivery_backend="scatter")


@pytest.mark.parametrize("schedule", ["structure_aware", "conventional"])
def test_driver_equals_the_jax_driver(schedule):
    spec = mam_spec(scale=SCALE)
    got = mam_simulation.simulate(spec, _config(schedule), device="cpu", t_ms=T_MS)
    want = jax_driver(schedule)
    counts = np.asarray(want.spike_count).sum(axis=1)
    assert counts.sum() > 0
    np.testing.assert_array_equal(got.counts, counts)
    assert got.state.t == int(want.t)
    assert got.overflow == 0
    np.testing.assert_array_equal(got.state.ring.numpy(), np.asarray(want.ring))
    for leaf in ("v", "refrac"):
        np.testing.assert_array_equal(getattr(got.state.neuron, leaf).numpy(),
                                      np.asarray(getattr(want.neuron, leaf)))
    # The jitted reference flushes subnormal f32 results to zero on the CPU;
    # torch's CPU ops keep them. A silent neuron's decaying i_syn reaches
    # them within 100 ms: equal once they are flushed (no spike, ring or v
    # bit depends on them here).
    i_syn = got.state.neuron.i_syn.numpy()
    flushed = np.where(np.abs(i_syn) < np.finfo(np.float32).tiny, np.float32(0), i_syn)
    np.testing.assert_array_equal(flushed, np.asarray(want.neuron.i_syn))
    t_s = int(want.t) * spec.dt_ms / 1000.0
    np.testing.assert_array_equal(got.rates, counts / (spec.area_sizes() * t_s))


def test_scatter_row_chunks_equal_one_pass(monkeypatch):
    """The scatter backend's deposits in row chunks of a few hundred rows
    (the chunking the scale-0.2 run needs on the card) give the unchunked
    rings, ignore-and-fire spiking from the first window."""
    spec = mam_spec(scale=SCALE)
    cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="scatter")
    net = mam_simulation.build_mam_network(spec, device="cpu")
    whole = mam_simulation.simulate(spec, cfg, device="cpu", net=net, t_ms=10.0)
    monkeypatch.setattr(delivery, "SCATTER_CHUNK_SLOTS", 2000)
    chunked = mam_simulation.simulate(spec, cfg, device="cpu", net=net, t_ms=10.0)
    assert whole.counts.sum() > 0 and bool(whole.state.ring.any())
    np.testing.assert_array_equal(chunked.counts, whole.counts)
    assert torch.equal(chunked.state.ring, whole.state.ring)
