"""The port's ``build_network`` against the JAX package's, table for table.

The three fixtures are the delivery benchmark's networks
(``benchmarks/bench_delivery.py``): the quickstart network, the laptop-scale
32-area MAM (heterogeneous area sizes) and a sparse ring area graph. Every
table must be bitwise equal, dtypes included, and every static field equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import areas as jareas  # noqa: E402
from repro.core.connectivity import build_network as jbuild  # noqa: E402
from repro_torch.core import areas as tareas  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402

TABLES = ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra",
          "src_inter", "w_inter", "delay_inter")
STATIC = ("n_pad", "n_areas", "ring_len", "delay_ratio", "dt_ms",
          "steps_lo_intra", "r_span_intra", "steps_lo_inter", "r_span_inter")
DERIVED = ("live_window", "k_intra", "k_inter", "n_total_padded", "bytes_per_synapse",
           "synapse_count")


def fixture_specs(name):
    """The same spec in both packages."""
    if name == "quickstart":
        kw = dict(n_areas=4, n_per_area=256, k_intra=32, k_inter=32)
        return jareas.mam_benchmark_spec(**kw), tareas.mam_benchmark_spec(**kw)
    if name == "mam_x0.001":
        return jareas.mam_spec(scale=0.001), tareas.mam_spec(scale=0.001)
    kw = dict(n_areas=8, n_per_area=256, k_intra=32, k_inter=32)
    return (jareas.mam_benchmark_spec(**kw, area_adjacency=jareas.ring_area_adjacency(8, 2)),
            tareas.mam_benchmark_spec(**kw, area_adjacency=tareas.ring_area_adjacency(8, 2)))


def derived(net, name):
    value = getattr(net, name)
    return value() if callable(value) else value


@pytest.mark.parametrize("name", ["quickstart", "mam_x0.001", "quickstart_sparse"])
def test_build_network_matches_jax(name):
    jspec, tspec = fixture_specs(name)
    for f in jspec.__dataclass_fields__:
        if f == "areas":
            assert [dataclasses.astuple(a) for a in tspec.areas] == [
                dataclasses.astuple(a) for a in jspec.areas]
        else:
            assert getattr(tspec, f) == getattr(jspec, f), f
    jnet = jbuild(jspec, seed=12)
    # Small chunks, so chunk edges fall inside areas and across them.
    tnet = tconn.build_network(tspec, seed=12, device="cpu", chunk_rows=100)
    for f in TABLES:
        want, got = np.asarray(getattr(jnet, f)), getattr(tnet, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    for f in STATIC + DERIVED:
        assert derived(tnet, f) == derived(jnet, f), f


def test_draw_pathway_rows_subset_identity():
    _, tspec = fixture_specs("mam_x0.001")
    net = tconn.build_network(tspec, seed=654, device="cpu")
    rows = torch.tensor([5, 0, 4000, 131, 2 * net.n_pad + 3], dtype=torch.int64)
    for pathway in ("intra", "inter"):
        src, w, d = tconn.draw_pathway_rows(tspec, 654, rows, pathway=pathway)
        a, n = rows // net.n_pad, rows % net.n_pad
        assert torch.equal(src, getattr(net, f"src_{pathway}")[a, n])
        assert torch.equal(w, getattr(net, f"w_{pathway}")[a, n])
        assert torch.equal(d, getattr(net, f"delay_{pathway}")[a, n])


def test_network_from_numpy_carries_a_jax_network():
    jspec, tspec = fixture_specs("quickstart")
    jnet = jbuild(jspec, seed=91856)
    carried = tconn.network_from_numpy(
        {f: np.asarray(getattr(jnet, f)) for f in TABLES}, device="cpu",
        **{f: getattr(jnet, f) for f in STATIC})
    built = tconn.build_network(tspec, seed=91856, device="cpu")
    for f in TABLES:
        assert torch.equal(getattr(carried, f), getattr(built, f)), f
    for f in STATIC + DERIVED:
        assert derived(carried, f) == derived(built, f), f


def test_build_network_defaults_to_cuda(monkeypatch):
    """No device given means CUDA; without a GPU that raises, never falls back."""
    _, tspec = fixture_specs("quickstart")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconn.build_network(tspec, seed=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconn.build_network(tspec, seed=12, outgoing=True)
