"""The port's fused superstep against the JAX package's, on the CPU.

Kernel level: the plain versions ``superstep_lif_plain`` /
``superstep_iaf_plain`` against the jitted JAX ``repro.kernels.ops``
wrappers, whose Pallas kernels run in interpret mode here, at the shapes of
``tests/test_kernels.py::test_superstep_kernels_match_unfused_window``.
Engine level: the port's ``superstep_kernel=True`` engine against the JAX
``superstep_kernel=True`` engine and against the port's conventional engine,
window by window. Tolerance: bitwise on every output -- the LIF step
reproduces the jitted reference's two FMAs and deposits lie on the 1/256
grid, so every sum is exact in any order. The JAX spikes (``[A, D, n]``
int8) are compared in the port's layout (``[D, A, n]`` bool).

One leaf is held elsewhere: the membrane potential ``v`` of a multi-cycle
JAX LIF window. Run on the CPU, XLA contracts ``v``'s propagator inside the
fused JAX kernel as ``fma(i, p21, v*p22)`` from the window's second cycle on,
where the unfused engine has ``fma(v, p22, i*p21)``; its ``v`` then drifts
from its own unfused engine's by a few ulps (spikes, rings, ``i_syn`` and
``refrac`` stay equal). The port keeps the unfused engine's FMAs in both
paths, so its ``v`` is held bitwise against the JAX kernel run one cycle per
call (kernel level) and against the JAX unfused engine (engine level).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import ConfigError as JaxConfigError  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.factory import make_simulation as jax_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import ConfigError, EngineConfig  # noqa: E402
from repro_torch.kernels import cycle as tcyc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_engine import (  # noqa: E402
    CASES, assert_same, jax_network, jax_trajectory, port_engine, snapshot,
)

LIF_KW = dict(p11=0.8187308, p21=3.617e-4, p22=0.9900498,
              v_th=15.0, v_reset=0.0, t_ref_steps=3)
A, N, K, D_WIN, LO, SPAN = 3, 96, 8, 5, 1, 6


def window_inputs(delay_dtype):
    """The shapes, seed and tables of tests/test_kernels.py's superstep test,
    with ``v`` and ``i_syn`` drawn so that every cycle spikes, plus an
    ignore-and-fire state whose phases spread over the window."""
    rng = np.random.default_rng(3)
    w_width = D_WIN + LO + SPAN - 1
    x = dict(
        src=rng.integers(0, N, (A, N, K)).astype(np.int32),
        w=(np.round(rng.normal(0, 64, (A, N, K))) / 256.0).astype(np.float32),
        delay=rng.integers(LO, LO + SPAN, (A, N, K)).astype(delay_dtype),
        alive=rng.random((A, N)) < 0.9,
        fut=(np.round(rng.normal(0, 512, (A, N, w_width))) / 256.0).astype(np.float32),
        gids=np.arange(A * N, dtype=np.int32).reshape(A, N),
        drive_p=np.full((A, N), 0.3, np.float32),
        v=rng.normal(12, 3, (A, N)).astype(np.float32),
        i_syn=rng.normal(3000, 2000, (A, N)).astype(np.float32),
        refrac=rng.integers(0, 3, (A, N)).astype(np.int32),
    )
    x["countdown"] = rng.integers(0, 2 * D_WIN, (A, N)).astype(np.int32)
    x["interval"] = rng.integers(1, D_WIN + 2, (A, N)).astype(np.int32)
    return x


def as_torch(x: dict, *names):
    return [torch.from_numpy(np.array(x[k])) for k in names]


def as_jax(x: dict, *names):
    return [jnp.asarray(x[k]) for k in names]


def assert_outputs_equal(got, want_jax, names):
    """Port outputs (torch) == JAX outputs, the spikes moved to [D, A, n] bool."""
    for name, g, w in zip(names, got, want_jax):
        w = np.asarray(w)
        if name == "spikes":
            assert w.dtype == np.int8, name
            w = np.moveaxis(w, 1, 0) != 0
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


LIF_IN = ("v", "i_syn", "refrac", "fut", "drive_p", "gids", "alive", "src", "w", "delay")
LIF_OUT = ("v", "i_syn", "refrac", "fut", "spikes")


def jax_lif_one_cycle_per_call(x, kw):
    """The JAX kernel with ``d_win=1`` over ``fut[..., s:]`` at ``t0 = s``, for
    each cycle ``s``: the same window, each cycle with the unfused FMAs."""
    v, i_syn, refrac, fut, *rest = as_jax(x, *LIF_IN)
    spikes = []
    for s in range(kw["d_win"]):
        v, i_syn, refrac, tail, spk = jops.superstep_lif(
            v, i_syn, refrac, fut[..., s:], *rest, jnp.int32(s), **dict(kw, d_win=1))
        fut = fut.at[..., s:].set(tail)
        spikes.append(spk)
    return v, i_syn, refrac, fut, jnp.concatenate(spikes, axis=1)


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
def test_superstep_lif_plain_matches_jax(delay_dtype):
    x = window_inputs(delay_dtype)
    kw = dict(d_win=D_WIN, steps_lo=LO, r_span=SPAN, seed=11, w_ext=88.0, **LIF_KW)
    got = tops.superstep_lif(*as_torch(x, *LIF_IN), 0, **kw)
    assert_outputs_equal(got, jax_lif_one_cycle_per_call(x, kw), LIF_OUT)
    # The whole window in one JAX call: every output but v (module docstring).
    want = jops.superstep_lif(*as_jax(x, *LIF_IN), jnp.int32(0), **kw)
    assert_outputs_equal(got[1:], want[1:], LIF_OUT[1:])
    assert got[4].sum() > 0 and got[4][1:].sum() > 0, "cycles after the first must spike"


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
def test_superstep_iaf_plain_matches_jax(delay_dtype):
    x = window_inputs(delay_dtype)
    names = ("countdown", "fut", "interval", "alive", "src", "w", "delay")
    kw = dict(d_win=D_WIN, steps_lo=LO, r_span=SPAN)
    want = jops.superstep_iaf(*as_jax(x, *names), **kw)
    got = tops.superstep_iaf(*as_torch(x, *names), **kw)
    assert_outputs_equal(got, want, ("countdown", "fut", "spikes"))
    per_cycle = got[2].sum(dim=(1, 2))
    assert bool((per_cycle > 0).all()), per_cycle


@pytest.mark.parametrize("regime", ["none_fire", "all_fire_every_cycle", "d_32"])
def test_superstep_iaf_plain_matches_jax_in_edge_regimes(regime):
    """The plain version the card tests hold the kernel against, in their
    edge regimes: no source fires (``fut`` unchanged, zero rows included);
    every alive source fires in every cycle (interval 1); a window of
    D = 32 cycles, so some sources have full 32-bit patterns."""
    x = window_inputs(np.int8)
    rng = np.random.default_rng(4)
    d_win = 32 if regime == "d_32" else D_WIN
    x["fut"] = (np.round(rng.normal(0, 512, (A, N, d_win + LO + SPAN - 1))) / 256.0
                + 0.0).astype(np.float32)  # + 0.0: no -0.0, which the plain sum clears
    x["fut"][0, :5] = 0.0
    if regime == "none_fire":
        x["countdown"] = rng.integers(D_WIN, 4 * D_WIN, (A, N)).astype(np.int32)
    elif regime == "all_fire_every_cycle":
        x["countdown"] = np.zeros((A, N), np.int32)
        x["interval"] = np.ones((A, N), np.int32)
    else:
        x["countdown"] = rng.integers(0, 40, (A, N)).astype(np.int32)
        x["interval"] = np.where(rng.random((A, N)) < 0.3, 1,
                                 rng.integers(2, 12, (A, N))).astype(np.int32)
    names = ("countdown", "fut", "interval", "alive", "src", "w", "delay")
    kw = dict(d_win=d_win, steps_lo=LO, r_span=SPAN)
    want = jops.superstep_iaf(*as_jax(x, *names), **kw)
    got = tops.superstep_iaf(*as_torch(x, *names), **kw)
    assert_outputs_equal(got, want, ("countdown", "fut", "spikes"))
    spikes, alive = got[2], torch.from_numpy(x["alive"])
    if regime == "none_fire":
        assert not bool(spikes.any())
        assert np.array_equal(got[1].numpy().view(np.uint8), x["fut"].view(np.uint8))
    elif regime == "all_fire_every_cycle":
        assert bool((spikes == alive).all())
    else:
        full = spikes.all(dim=0)
        assert bool(full.any()), "some source must fire in all 32 cycles"


def test_superstep_plain_updates_fut_in_place_and_checks_its_width():
    x = window_inputs(np.int8)
    names = ("countdown", "fut", "interval", "alive", "src", "w", "delay")
    args = as_torch(x, *names)
    fut = args[1]
    _, fut_out, _ = tcyc.superstep_iaf_plain(*args, d_win=D_WIN, steps_lo=LO, r_span=SPAN)
    assert fut_out is fut
    args[1] = fut[..., :-1]
    with pytest.raises(ValueError, match="W >= 11"):
        tcyc.superstep_iaf_plain(*args, d_win=D_WIN, steps_lo=LO, r_span=SPAN)


@functools.lru_cache(maxsize=None)
def jax_fused_trajectory(model):
    """Snapshots after every window of the JAX fused-superstep pallas engine."""
    spec, net = jax_network(model)
    eng = jax_make(spec, JaxConfig(neuron_model=model, schedule="structure_aware",
                                   delivery_backend="pallas", superstep_kernel=True),
                   net=net)
    st, snaps = eng.init(), []
    for _ in range(CASES[model][2]):
        st, blk = eng.window(st)
        snaps.append(snapshot(st, blk))
    return snaps


@pytest.mark.parametrize("model", list(CASES))
def test_fused_engine_matches_jax_and_the_conventional_engine(model):
    want = jax_fused_trajectory(model)
    unfused_v = ([s["v"] for s in jax_trajectory(model, "structure_aware")]
                 if model == "lif" else None)
    fused = port_engine(model, "structure_aware", superstep_kernel=True)
    conventional = port_engine(model, "conventional")
    st_f, st_c = fused.init(), conventional.init()
    for w, snap in enumerate(want):
        st_f, blk_f = fused.window(st_f)
        st_c, blk_c = conventional.window(st_c)
        got = snapshot(st_f, blk_f)
        if unfused_v is not None:  # see the module docstring
            snap = dict(snap, v=unfused_v[w])
        assert_same(got, snap, (model, "jax", w))
        assert_same(got, snapshot(st_c, blk_c), (model, "conventional", w))
    assert int(st_f.spike_count.sum()) > 0


@pytest.mark.parametrize("model", list(CASES))
@pytest.mark.parametrize("backend", ["scatter", "onehot"])
def test_fused_engine_on_the_dense_backends(backend, model):
    """The fused window's intra deposit is the kernel's whatever the backend;
    the backend still carries the lumped inter exchange."""
    fused = port_engine(model, "structure_aware", superstep_kernel=True,
                        delivery_backend=backend)
    unfused = port_engine(model, "structure_aware", delivery_backend=backend)
    st_f, st_u = fused.init(), unfused.init()
    for w in range(CASES[model][2]):
        st_f, blk_f = fused.window(st_f)
        st_u, blk_u = unfused.window(st_u)
        assert_same(snapshot(st_f, blk_f), snapshot(st_u, blk_u), (backend, w))
    assert int(st_f.spike_count.sum()) > 0


@pytest.mark.parametrize("fields", [
    dict(schedule="conventional", superstep_kernel=True),
    dict(superstep=False, superstep_kernel=True),
], ids=["conventional", "superstep_false"])
def test_superstep_kernel_rules_match_jax(fields):
    with pytest.raises(JaxConfigError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ConfigError) as err:
        EngineConfig(**fields)
    as_tuples = lambda e: [(v.field, v.problem, v.remedy)  # noqa: E731
                           for v in e.value.violations]
    assert as_tuples(err) == as_tuples(jerr)
    assert [v.field for v in err.value.violations] == ["superstep_kernel"]
    EngineConfig(schedule="structure_aware", superstep_kernel=True)
