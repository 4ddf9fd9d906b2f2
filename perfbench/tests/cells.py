"""Cells of the benchmark's routes at sizes a CPU test holds: the cells'
own traffic files with a small network in place of the configuration's."""

from __future__ import annotations

import copy
import json

from perfbench import harness

BENCH_CONFIG = harness.HERE / "configs" / "mam-benchmark-4x130k.json"
TRAFFIC = harness.HERE / "traffic"
E2E = [("rtf", "x"), ("window_p95_ms", "ms"), ("peak_gib", "GiB"), ("setup_s", "s")]
PER_LAYER = [("device_idle_pct", "%"), ("window_mfu", "%"), ("launches_per_window", "1"),
             ("build_s", "s"), ("tables_gib", "GiB")]
# The routes of the benchmark's cells, each its traffic file. The harness
# also runs the LIF model (``neuron_model="lif"`` in place of the file's).
ROUTES = ("iaf.pallas-fused", "iaf.event-fused")


def bench_config(n_areas=4, n=64, k=(8, 8), rate=30.0) -> dict:
    """The MAM-benchmark configuration at a small size."""
    cfg = json.loads(BENCH_CONFIG.read_text())
    net = dict(cfg["network"], sizes=[n] * n_areas, rates_hz=[rate] * n_areas,
               k_intra=k[0], k_inter=k[1])
    return dict(cfg, args=dict(n_areas=n_areas, n_per_area=n, k_intra=k[0], k_inter=k[1],
                               rate_hz=rate), network=net)


def mam_config(scale=0.001) -> dict:
    """The 32-area MAM's builder at a small ``scale`` (uneven areas and rates)."""
    from repro_torch.core.areas import mam_spec

    spec = mam_spec(scale=scale)
    cfg = json.loads((harness.HERE / "configs" / "mam-32area-n0.2.json").read_text())
    net = dict(cfg["network"], sizes=[int(x) for x in spec.area_sizes()],
               rates_hz=[a.rate_hz for a in spec.areas], k_intra=spec.k_intra,
               k_inter=spec.k_inter)
    return dict(cfg, args=dict(scale=scale), network=net)


def cell(route: str, config: dict | None = None, *, warmup: int = 25, trace_windows: int = 3,
         **engine) -> harness.Cell:
    """A small cell on ``route`` (one of :data:`ROUTES`); ``engine``
    overrides the traffic's engine settings. The warm-up's windows are
    compared too, and fix a number of windows in which the small LIF
    networks have begun to fire, however slow the machine."""
    traffic = copy.deepcopy(json.loads((TRAFFIC / f"{route}.json").read_text()))
    traffic["engine"].update(engine)
    traffic.update(warmup_windows=warmup, trace_windows=trace_windows)
    return harness.Cell(name=f"small.{route}", config=config or bench_config(),
                        traffic=traffic, chips=1, end_to_end=list(E2E),
                        per_layer=list(PER_LAYER))
