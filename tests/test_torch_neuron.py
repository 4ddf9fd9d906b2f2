"""The port's neuron models against the jitted JAX ``repro.core.neuron``.

Inputs from fixed numpy seeds; tolerance bitwise. The JAX functions run
under ``jax.jit``, as every JAX engine runs them: XLA contracts the LIF
propagator into FMAs there, and the port reproduces exactly that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import neuron as jneu  # noqa: E402
from repro_torch.core import neuron as tneu  # noqa: E402


@pytest.mark.parametrize("seed,t", [(42, 0), (7, 12345), (2**31 + 5, 99), (0, 2**31 - 1)])
def test_counter_uniform_and_poisson_drive(seed, t):
    gids = np.arange(50_000, dtype=np.int32)
    rate = np.random.default_rng(seed % 97).uniform(0, 30_000, gids.size).astype(np.float32)
    ju = jax.jit(lambda g: jneu.counter_uniform(seed, t, g))(jnp.asarray(gids))
    assert np.array_equal(tneu.counter_uniform(seed, t, torch.from_numpy(gids)).numpy(),
                          np.asarray(ju))
    jd = jax.jit(lambda g, r: jneu.poisson_drive(seed, t, g, r, 0.1, 282.0))(
        jnp.asarray(gids), jnp.asarray(rate))
    td = tneu.poisson_drive(seed, t, torch.from_numpy(gids), torch.from_numpy(rate), 0.1, 282.0)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert 0 < td.count_nonzero() < gids.size


def test_ignore_and_fire_matches_jax():
    rng = np.random.default_rng(5)
    n = 5000
    rate = rng.choice([0.0, 2.5, 7.3, 30.0, 1000.0], n).astype(np.float32)
    alive = rng.random(n) < 0.9
    gids = np.arange(n, dtype=np.int32)
    assert np.array_equal(
        tneu.iaf_interval(torch.from_numpy(rate), 0.1).numpy(),
        np.asarray(jax.jit(lambda r: jneu.iaf_interval(r, 0.1))(jnp.asarray(rate))))
    js = jax.jit(lambda a, r, g: jneu.ignore_and_fire_init(a, r, 0.1, g))(
        jnp.asarray(alive), jnp.asarray(rate), jnp.asarray(gids))
    ts = tneu.ignore_and_fire_init(torch.from_numpy(alive), torch.from_numpy(rate), 0.1,
                                   torch.from_numpy(gids))
    step = jax.jit(lambda s, a, r: jneu.ignore_and_fire_update(s, None, a, r, 0.1))
    fired = 0
    for _ in range(50):
        assert np.array_equal(ts.countdown.numpy(), np.asarray(js.countdown))
        js, jspk = step(js, jnp.asarray(alive), jnp.asarray(rate))
        ts, tspk = tneu.ignore_and_fire_update(ts, None, torch.from_numpy(alive),
                                               torch.from_numpy(rate), 0.1)
        assert np.array_equal(tspk.numpy(), np.asarray(jspk))
        fired += int(tspk.sum())
    assert fired > 0


def test_lif_propagators_match_jax():
    for kw in ({}, dict(dt_ms=0.25), dict(tau_syn_ms=10.0)):
        j, t = jneu.LIFParams(**kw), tneu.LIFParams(**kw)
        assert (j.p11, j.p21, j.p22, j.t_ref_steps) == (t.p11, t.p21, t.p22, t.t_ref_steps)


def test_lif_update_matches_jitted_jax():
    rng = np.random.default_rng(6)
    n = 40_000
    v = rng.normal(13.0, 3.0, n).astype(np.float32)
    i = rng.normal(0.0, 300.0, n).astype(np.float32)
    r = rng.integers(0, 5, n).astype(np.int32)
    i_in = rng.normal(0.0, 250.0, n).astype(np.float32)
    alive = rng.random(n) < 0.9
    p = jneu.LIFParams()
    js, jspk = jax.jit(lambda s, x, a: jneu.lif_update(s, x, a, p))(
        jneu.LIFState(jnp.asarray(v), jnp.asarray(i), jnp.asarray(r)),
        jnp.asarray(i_in), jnp.asarray(alive))
    ts, tspk = tneu.lif_update(
        tneu.LIFState(*(torch.from_numpy(x) for x in (v, i, r))),
        torch.from_numpy(i_in), torch.from_numpy(alive), tneu.LIFParams())
    for name in ("v", "i_syn", "refrac"):
        assert np.array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name))), name
    assert np.array_equal(tspk.numpy(), np.asarray(jspk))
    assert tspk.any()
