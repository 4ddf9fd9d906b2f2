"""The port's dry-run tooling against the JAX package's.

``connectivity.network_sds`` (meta tensors) against the JAX stand-ins
(``ShapeDtypeStruct`` leaves) over the flag grid: the same fields, dtypes,
static fields and shapes but the bound widths, which are the draw rule's
(``_drawn_k_bound``; held against the reference's and against instantiated
tables in ``test_torch_dryrun_bounds.py``). Then
``construction_cost_model``, the dry run's verify and construction rows,
and each priced ``dryrun_snn_cell`` row's wire bytes (against the JAX
accounting on the JAX stand-in of the same cell) and receive-table report
(against the JAX accounting on a JAX stand-in carrying the port's widths),
at the production scale (1.0). The JAX dry-run module forces 512 host
devices when it is imported, so its rows are taken in a subprocess.
Tolerance: equal shapes, dtypes, dicts and floats (the same arithmetic).
The CLI and the measured build peaks: ``test_torch_dryrun_cli.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import connectivity as jconn  # noqa: E402
from repro.core import delivery as jdelivery  # noqa: E402
from repro.core import exchange as jexchange  # noqa: E402
from repro.core.areas import mam_benchmark_spec as jax_bench_spec  # noqa: E402
from repro.core.areas import mam_spec as jax_mam_spec  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import delivery as tdelivery  # noqa: E402
from repro_torch.core import exchange as texchange  # noqa: E402
from repro_torch.core.areas import mam_benchmark_spec, mam_spec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = {
    "bench 4x48": (lambda: jax_bench_spec(n_areas=4, n_per_area=48, k_intra=8, k_inter=8),
                   lambda: mam_benchmark_spec(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)),
    "mam x0.002": (lambda: jax_mam_spec(scale=0.002), lambda: mam_spec(scale=0.002)),
    "mam x1.0": (lambda: jax_mam_spec(scale=1.0), lambda: mam_spec(scale=1.0)),
}
STATIC = ("n_pad", "n_areas", "ring_len", "delay_ratio", "dt_ms", "steps_lo_intra",
          "r_span_intra", "steps_lo_inter", "r_span_inter", "inter_shard_mode", "area_adj")
# (outgoing, inter_shards, inter_shard_mode, subgroup, size_multiple)
SDS_GRID = [(o, s, m, g, mult) for o in (False, True) for s in (0, 2, 4)
            for m in ("group", "window") for g in (1, 2) for mult in (1, 8)]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor) \
        else str(np.dtype(x.dtype))


BOUNDED = ("tgt_intra", "wout_intra", "dout_intra", "tgt_inter", "wout_inter", "dout_inter",
           "tgt_inter_in", "wout_inter_in", "dout_inter_in")


def _same_stand_ins(jnet, tnet) -> bool:
    """Equal fields, dtypes, static fields and shapes, the bound widths at
    least the reference's; whether those widths are equal too."""
    equal = True
    for f in dataclasses.fields(tnet):
        j, t = getattr(jnet, f.name), getattr(tnet, f.name)
        if f.name in STATIC:
            assert j == t, f.name
        elif j is None or t is None:
            assert j is None and t is None, f.name
        else:
            assert t.device.type == "meta", f.name
            assert _dtype(j) == _dtype(t), f.name
            if f.name in BOUNDED:
                assert tuple(j.shape[:-1]) == tuple(t.shape[:-1]), f.name
                assert t.shape[-1] >= j.shape[-1], f.name
                equal &= t.shape[-1] == j.shape[-1]
            else:
                assert tuple(j.shape) == tuple(t.shape), f.name
    return equal


@pytest.mark.parametrize("spec_name", list(SPECS))
def test_network_sds_matches_the_jax_stand_ins_over_the_flag_grid(spec_name):
    jspec, tspec = (make() for make in SPECS[spec_name])
    for outgoing, shards, mode, sub, mult in SDS_GRID:
        kw = dict(size_multiple=mult, outgoing=outgoing, inter_shards=shards,
                  inter_shard_mode=mode, subgroup=sub)
        try:
            jnet = jconn.network_sds(jspec, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split("(")[0].strip()):
                tconn.network_sds(tspec, **kw)
            continue
        tnet = tconn.network_sds(tspec, **kw)
        _same_stand_ins(jnet, tnet)
        assert tnet.k_intra == jnet.k_intra and tnet.k_inter == jnet.k_inter
        assert tnet.live_window == jnet.live_window
        assert tnet.bytes_per_synapse() == jnet.bytes_per_synapse()


@pytest.mark.parametrize("scale", [0.002, 1.0])
@pytest.mark.parametrize("cut", [(16, 16, 16), (16, 1, 1), (32, 16, 16), (2, 2, 8)])
def test_construction_cost_model_equals_the_reference(scale, cut):
    n_shards, subgroup, mult = cut
    kw = dict(n_shards=n_shards, subgroup=subgroup, size_multiple=mult)
    assert tconn.construction_cost_model(mam_spec(scale=scale), **kw) == \
        jconn.construction_cost_model(jax_mam_spec(scale=scale), **kw)


def test_the_accounting_reads_a_meta_network():
    """The repair behind the priced rows: the packet rule falls back to the
    2.5 Hz ground state on a stand-in, and the adjacency to the spec's, as
    the reference's do; the wire reports read shapes only."""
    tspec, jspec = mam_spec(scale=1.0), jax_mam_spec(scale=1.0)
    tnet = tconn.network_sds(tspec, size_multiple=16, outgoing=True, inter_shards=16,
                             subgroup=16)
    jnet = jconn.network_sds(jspec, size_multiple=16, outgoing=True, inter_shards=16,
                             subgroup=16)
    assert tdelivery.expected_area_spikes(tnet) == jdelivery.expected_area_spikes(jnet)
    np.testing.assert_array_equal(tconn.area_adjacency(tnet, tspec),
                                  jconn.area_adjacency(jnet, jspec))
    np.testing.assert_array_equal(tconn.area_adjacency(tnet), jconn.area_adjacency(jnet))
    for backend in ("event", "scatter"):
        kw = dict(backend=backend, n_groups=16, gsz=16)
        assert texchange.dense_wire_bytes(tnet, schedule="structure_aware", **kw) == \
            jexchange.dense_wire_bytes(jnet, schedule="structure_aware", **kw)
        assert texchange.adaptive_wire_bytes(tnet, **kw) == \
            jexchange.adaptive_wire_bytes(jnet, **kw)
    # An event-sized network with real rates keeps its own mean.
    real = tconn.build_network(mam_benchmark_spec(n_areas=2, n_per_area=16, k_intra=2,
                                                  k_inter=2), device="cpu")
    assert tdelivery.expected_area_spikes(real) != tdelivery.expected_area_spikes(tnet)


def test_priced_report_refuses_a_meta_network_without_inbound_slices():
    net = tconn.network_sds(mam_spec(scale=1.0), size_multiple=16, outgoing=True)
    with pytest.raises(ValueError, match="network_sds\\(inter_shards=...\\)"):
        texchange.priced_inter_table_report(net, n_groups=16, gsz=16)


INBOUND = ("tgt_inter_in", "wout_inter_in", "dout_inter_in")
REPLICATED = ("tgt_inter", "wout_inter", "dout_inter")


def _jax_cell(schedule, multi_pod, backend="", exchange="", shard_tables=True,
              subgroup_tables=True, adaptive=False):
    """The JAX dry run's accounting of the cell: its network_sds, routing,
    priced report and the engine's wire_bytes, on the JAX functions; the
    report's stand-in carries the port's bound widths."""
    spec = jax_mam_spec(scale=1.0)
    n_dev, gsz = (512 if multi_pod else 256), 16
    n_groups = n_dev // gsz
    sa = schedule == "structure_aware"
    mult = 16 if sa else 512
    needs_outgoing = backend == "event" or exchange == "routed"
    n_shards = n_groups if sa else n_dev
    mode = "group" if sa else "window"
    sub = gsz if shard_tables and subgroup_tables and sa else 1
    net = jconn.network_sds(spec, size_multiple=mult, outgoing=needs_outgoing,
                            inter_shards=n_shards if needs_outgoing and shard_tables else 0,
                            inter_shard_mode=mode, subgroup=sub)
    cfg = JaxConfig(neuron_model="lif", schedule=schedule, delivery_backend=backend,
                    exchange=exchange, shard_inter_tables=shard_tables,
                    subgroup_inter_tables=subgroup_tables, adaptive_exchange=adaptive)
    kw = dict(headroom=cfg.s_max_headroom, floor=cfg.s_max_floor)
    routing = None
    if exchange == "routed":
        routing = jexchange.build_routing(
            jconn.area_adjacency(net, spec), n_groups,
            exp_area_spikes=jdelivery.expected_area_spikes(net), **kw)
    out = {}
    if needs_outgoing:
        # Both layouts, as the port's cell prices them: the inbound slices at
        # the cell's cut and the replicated outgoing tables, each JAX
        # stand-in carrying the port's bound widths.
        import jax

        cut = dict(size_multiple=mult, outgoing=True, inter_shards=n_shards,
                   inter_shard_mode=mode, subgroup=sub)
        jsliced, jrep = (jconn.network_sds(spec, **cut),
                         jconn.network_sds(spec, size_multiple=mult, outgoing=True))
        tsliced, trep = (tconn.network_sds(mam_spec(scale=1.0), **cut),
                         tconn.network_sds(mam_spec(scale=1.0), size_multiple=mult,
                                           outgoing=True))
        widths = {f: jax.ShapeDtypeStruct(tuple(getattr(t, f).shape), getattr(j, f).dtype)
                  for j, t, names in ((jsliced, tsliced, INBOUND), (jrep, trep, REPLICATED))
                  for f in names}
        out["inter_tables"] = jexchange.priced_inter_table_report(
            dataclasses.replace(jsliced, **widths), n_groups=n_groups, gsz=gsz,
            schedule=schedule, routing=routing, subgroup=sub, **kw)
    if needs_outgoing and net.tgt_inter_in is not None:
        import jax
        s = jax.ShapeDtypeStruct
        k_e = net.k_inter
        net = dataclasses.replace(
            net, src_inter=s((0, 0, k_e), net.src_inter.dtype),
            w_inter=s((0, 0, k_e), net.w_inter.dtype),
            delay_inter=s((0, 0, k_e), net.delay_inter.dtype))
    wkw = dict(backend=cfg.backend, gsz=gsz, **kw)
    if routing is not None:
        wire = jexchange.routed_wire_bytes(net, routing, **wkw)
        wire["adaptive"] = jexchange.adaptive_wire_bytes(
            net, schedule="structure_aware", n_groups=n_groups, routing=routing, **wkw)
    else:
        wire = jexchange.dense_wire_bytes(net, schedule=schedule, n_groups=n_groups, **wkw)
        wire["adaptive"] = jexchange.adaptive_wire_bytes(
            net, schedule=schedule, n_groups=n_groups, **wkw)
    wire["adaptive_on"] = adaptive
    out["wire_bytes_window"] = wire
    return out


CELLS = {
    "s-a event (static)": ("structure_aware", False, dict(backend="event")),
    "s-a event adaptive": ("structure_aware", False, dict(backend="event", adaptive=True)),
    "s-a event routed": ("structure_aware", False, dict(backend="event", exchange="routed")),
    "s-a routed, two pods": ("structure_aware", True, dict(exchange="routed", adaptive=True)),
    "s-a event replicated tables": ("structure_aware", False,
                                    dict(backend="event", shard_tables=False)),
    "s-a event no subgroup": ("structure_aware", True,
                              dict(backend="event", subgroup_tables=False)),
    "conventional event": ("conventional", False, dict(backend="event")),
    "conventional default backend, two pods": ("conventional", True, {}),
    "s-a pallas": ("structure_aware", False, dict(backend="pallas")),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_priced_cell_equals_the_jax_accounting(cell):
    schedule, multi_pod, kw = CELLS[cell]
    row = dryrun.dryrun_snn_cell(schedule, multi_pod, 1.0, **kw)
    want = _jax_cell(schedule, multi_pod, **kw)
    assert row["status"] == "OK"
    assert row["wire_bytes_window"] == want["wire_bytes_window"]
    assert row.get("inter_tables") == want.get("inter_tables")
    assert row["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert row["n_neurons"] == mam_spec(scale=1.0).n_total
    assert row["rank_bytes"]["total"] == row["rank_bytes"]["tables"] + row["rank_bytes"]["state"]


def test_rank_bytes_are_the_cut_of_the_stand_in():
    """One rank's bytes divide the whole network's as dist_engine's cut does:
    the structure-aware block is a 1/256 of every incoming table and of the
    state; the sharded inbound slice is one of the 16 x 16."""
    row = dryrun.dryrun_snn_cell("structure_aware", False, 1.0, backend="event")
    spec = mam_spec(scale=1.0)
    net = tconn.network_sds(spec, size_multiple=16, outgoing=True, inter_shards=16,
                            subgroup=16)
    whole = sum(getattr(net, f).numel() * getattr(net, f).element_size()
                for f in ("alive", "rate_hz", "src_intra", "w_intra", "delay_intra"))
    intra = net.tgt_intra.numel() * (4 + 4 + 1)
    inbound = net.tgt_inter_in.numel() * (4 + 4 + 1)
    assert row["rank_bytes"]["tables"] == whole // 256 + intra // 256 + inbound // 256
    a, n = spec.n_areas // 16, net.n_pad // 16
    assert row["rank_bytes"]["state"] == a * n * (16 + 4 * net.ring_len) + 12


def test_verify_and_construction_rows_equal_the_jax_rows():
    """The construction rows equal; the verify row instantiates the same
    slice and prices it at the port's bound, which brackets it as the
    reference's does at this size."""
    code = ("import json\n"
            "from repro.launch.dryrun import verify_inter_table_bounds, construction_cost_row\n"
            "print(json.dumps([verify_inter_table_bounds(), construction_cost_row(1.0), "
            "construction_cost_row(0.002)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = dryrun.verify_inter_table_bounds(device="cpu")
    assert [dryrun.construction_cost_row(1.0), dryrun.construction_cost_row(0.002)] == want[1:]
    modelled = ("bytes_per_device_modelled", "bound_slack", "intra_bound_slack")
    assert {k: v for k, v in got.items() if k not in modelled} == \
        {k: v for k, v in want[0].items() if k not in modelled}
    assert got["status"] == "OK"
    sds = tconn.network_sds(mam_benchmark_spec(n_areas=4, n_per_area=64, k_intra=8,
                                               k_inter=12),
                            size_multiple=8, outgoing=True, inter_shards=2, subgroup=2)
    assert got["bytes_per_device_modelled"] == 4 * 64 * sds.tgt_inter_in.shape[-1] * 9
    assert got["bytes_per_device_modelled"] >= got["bytes_per_device_instantiated"]


def test_verify_inter_table_bounds_fails_on_a_bound_too_narrow(monkeypatch):
    monkeypatch.setattr(tconn, "_drawn_k_bound", lambda *args: 1)
    with pytest.raises(AssertionError, match="under-price the tables"):
        dryrun.verify_inter_table_bounds(device="cpu")
