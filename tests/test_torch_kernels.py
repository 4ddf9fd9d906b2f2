"""The port's kernels (plain versions, on the CPU) against the JAX kernels.

The JAX side runs its Pallas kernels through the jitted ``repro.kernels.ops``
wrappers (interpret mode on the CPU). Inputs are drawn with numpy from fixed
seeds. Tolerance: bitwise, floats included -- the plain LIF step emulates the
jitted reference's two FMAs in float64, and delivery weights lie on the 1/256
grid, so every sum is exact in any order.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.neuron import LIFParams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import lif_update as tlif  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import spike_deliver as tdlv  # noqa: E402

_P = LIFParams()
LIF_KW = dict(p11=_P.p11, p21=_P.p21, p22=_P.p22, v_th=_P.v_th_mv,
              v_reset=_P.v_reset_mv, t_ref_steps=_P.t_ref_steps)


def lif_inputs(seed: int, n: int):
    """State around threshold, with refractory, stale and ghost lanes."""
    rng = np.random.default_rng(seed)
    return (rng.normal(13.0, 3.0, n).astype(np.float32),
            rng.normal(0.0, 300.0, n).astype(np.float32),
            rng.integers(-1, 5, n).astype(np.int32),
            rng.normal(0.0, 250.0, n).astype(np.float32),
            rng.random(n) < 0.9)


def deliver_inputs(seed: int, n: int, k: int, n_src: int, lo: int, span: int):
    """Grid weights, int8 delays reaching past both ends of the window."""
    rng = np.random.default_rng(seed)
    spikes = (rng.random(n_src) < 0.2).astype(np.float32)
    src = rng.integers(0, n_src, (n, k)).astype(np.int32)
    w = (np.round(rng.normal(0.0, 60.0, (n, k)) * 256) / 256).astype(np.float32)
    delay = rng.integers(max(lo - 2, 0), lo + span + 2, (n, k)).astype(np.int8)
    return spikes, src, w, delay


def as_torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("n", [1000, 8192 + 77])
def test_lif_update_matches_jax(n):
    xs = lif_inputs(n, n)
    want = jops.lif_update(*(jnp.asarray(x) for x in xs), **LIF_KW)
    got = tops.lif_update(*as_torch(*xs), **LIF_KW)
    assert got[3].dtype == torch.bool and got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3].any() and (xs[2] > 0).any(), "inputs must cross threshold"


@pytest.mark.parametrize("lo,span", [(1, 30), (10, 91)], ids=["intra", "inter"])
def test_spike_deliver_matches_jax(lo, span):
    spikes, src, w, delay = deliver_inputs(lo, 300, 64, 1200, lo, span)
    want = jops.spike_deliver(*(jnp.asarray(x) for x in (spikes, src, w, delay)),
                              steps_lo=lo, r_span=span)
    got = tops.spike_deliver(*as_torch(spikes, src, w, delay), steps_lo=lo, r_span=span)
    assert got.shape == (300, span) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy()).sum() > 0


def test_spike_deliver_area_offset_matches_lifted_sources():
    """Per-area source offsets (the intra call) == sources lifted to global
    ids, on both packages."""
    a, n, k, lo, span = 3, 50, 16, 1, 30
    rng = np.random.default_rng(3)
    spikes = (rng.random(a * n) < 0.3).astype(np.float32)
    src = rng.integers(0, n, (a * n, k)).astype(np.int32)
    w = (np.round(rng.normal(0.0, 60.0, (a * n, k)) * 256) / 256).astype(np.float32)
    delay = rng.integers(lo, lo + span, (a * n, k)).astype(np.int8)
    lifted = src + (np.arange(a * n) // n * n)[:, None].astype(np.int32)
    want = jops.spike_deliver(*(jnp.asarray(x) for x in (spikes, lifted, w, delay)),
                              steps_lo=lo, r_span=span)
    got = tops.spike_deliver(*as_torch(spikes, src, w, delay), steps_lo=lo,
                             r_span=span, rows_per_area=n, src_stride=n)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_apply_contrib_matches_jax():
    rng = np.random.default_rng(4)
    ring = (np.round(rng.normal(0, 50, (40, 110)) * 256) / 256).astype(np.float32)
    contrib = (np.round(rng.normal(0, 50, (40, 91)) * 256) / 256).astype(np.float32)
    for t in (0, 37, 105):
        want = jops.apply_contrib(jnp.asarray(ring), jnp.asarray(contrib), t, 10)
        got = tops.apply_contrib(torch.from_numpy(ring.copy()),
                                 torch.from_numpy(contrib), t, 10)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_oracles_match_plain_versions():
    xs = as_torch(*lif_inputs(7, 3000))
    for g, w in zip(tlif.lif_update_plain(*xs, **LIF_KW), tref.lif_update_ref(*xs, **LIF_KW)):
        assert torch.equal(g, w)
    spikes, src, w, delay = as_torch(*deliver_inputs(8, 200, 48, 500, 10, 91))
    assert torch.equal(
        tdlv.spike_deliver_plain(spikes, src, w, delay, steps_lo=10, r_span=91),
        tref.spike_deliver_ref(spikes, src, w, delay, steps_lo=10, r_span=91))


def test_plain_deliver_row_chunks(monkeypatch):
    """The plain version's row chunking does not change its result."""
    spikes, src, w, delay = as_torch(*deliver_inputs(9, 300, 32, 900, 1, 30))
    src = src % 300  # indices within each of the 3 areas of 300 sources
    whole = tdlv.spike_deliver_plain(spikes, src, w, delay, steps_lo=1, r_span=30,
                                     rows_per_area=100, src_stride=300)
    monkeypatch.setattr(tdlv, "PLAIN_CHUNK_ROWS", 64)
    chunked = tdlv.spike_deliver_plain(spikes, src, w, delay, steps_lo=1, r_span=30,
                                       rows_per_area=100, src_stride=300)
    assert torch.equal(whole, chunked)


def test_dispatch_raises_off_cpu_and_cuda():
    """Tensors on a device with no kernel raise (meta tensors, the dry run's,
    take the kernel's meta rule); the CUDA wrappers refuse CPU tensors
    instead of falling back to the plain version."""
    v = torch.zeros(8, device="meta")
    out = tops.lif_update(v, v, v.int(), v, v.bool(), **LIF_KW)
    assert [(x.device.type, x.dtype) for x in out] == [
        ("meta", torch.float32), ("meta", torch.float32), ("meta", torch.int32),
        ("meta", torch.bool)]
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.lif_update(SimpleNamespace(device=torch.device("xpu")), v, v.int(), v, v.bool(),
                        **LIF_KW)
    xs = as_torch(*lif_inputs(1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tlif.lif_update_cuda(*xs, **LIF_KW)
    spikes, src, w, delay = as_torch(*deliver_inputs(2, 8, 4, 8, 1, 30))
    with pytest.raises(ValueError, match="spike_deliver kernel"):
        tdlv.spike_deliver_cuda(spikes, src, w, delay, steps_lo=1, r_span=30)
