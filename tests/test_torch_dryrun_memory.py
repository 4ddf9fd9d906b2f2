"""The dry run's working set: the live-bytes tracker
(``repro_torch.launch.memory.LiveBytes``), the kernels' meta rules, and the
``transient`` / ``output`` / ``peak`` bytes of the priced LM and SNN calls.

* The tracker on hand-made sequences, on ``meta`` and on the CPU: fresh
  storages count once (views and in-place ops add nothing), a freed
  temporary leaves the count, autograd's saved tensors leave it during the
  backward, tensors made before the tracker starts and tensors on another
  device never count. Each case has an exact expected peak.
* Each kernel's meta rule (``kernels.ops`` on ``meta`` tensors) allocates
  exactly what its CUDA wrapper's allocation helper gives, by shape and
  dtype, and launches nothing.
* ``price_lm`` on a ``MeshLayout`` (meta tensors) prices, byte for byte,
  what the tracker counts when the same rank runs the same call on real
  CPU tensors in a gloo world: a training step, a prefill and a decode of
  reduced qwen2 on (1, 1) and (2, 2); and ``dryrun.price_window`` one
  window of the distributed engine on ``scatter`` and ``onehot`` (no kernel
  runs in any of these calls on the CPU).
* On an FSDP cell ``transient >= gathered``, and stacking the FLOP counter
  changes nothing; a production SNN row whose held bytes fit the budget
  but whose peak does not FAILs the gate.

The transient is eager PyTorch's live set, not XLA's buffer assignment, so
nothing here is held to the reference's ``temp_bytes``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core import connectivity as connectivity_lib
from repro_torch.core import dist_engine as dist_engine_lib
from repro_torch.core.areas import mam_benchmark_spec
from repro_torch.core.engine import EngineConfig
from repro_torch.core.mesh import MeshLayout
from repro_torch.data.pipeline import host_batch
from repro_torch.kernels import cuda, ops
from repro_torch.kernels import cycle as kcycle
from repro_torch.kernels import event_deliver as kevent
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import lif_update as klif
from repro_torch.kernels import spike_deliver as kdeliver
from repro_torch.launch import dryrun
from repro_torch.launch.memory import LiveBytes
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.steps import make_serve_artifacts, make_train_artifacts
from test_torch_comm import run_world

ARCH = "qwen2-0.5b"
REMAT = {"remat": "dots"}  # as the published config: the recomputed activations count
SEQ = 16
SERVE = ShapeSpec("serve", "decode", 32, 4)
PROMPT = 20
SPEC = dict(n_areas=4, n_per_area=32, k_intra=8, k_inter=8)
BACKENDS = ("scatter", "onehot")

# ---------------------------------------------------------------------------
# the tracker on hand-made sequences


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_views_in_place_ops_and_a_freed_temporary(device):
    w = torch.ones(64, 64, device=device)  # made before: never counted
    with LiveBytes(device) as live:
        h = torch.empty(16, 64, device=device)  # 4096
        t = h @ w                               # 8192
        t.relu_()                               # in place: + 0
        v = t.view(-1)[:100]                    # a view: + 0
        del h                                   # 4096
        u = torch.cat([t, t])                   # 12288, the peak
        del t, u                                # v keeps t's storage alive: 4096
        host = torch.empty(1 << 20, device="cpu" if device == "meta" else "meta")
    assert live.transient == 12288
    assert live.output == 4096
    del v, host
    assert live.live == 0  # the last view's death frees t's storage


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_saved_tensors_leave_the_count_during_the_backward(device):
    x = torch.ones(1000, device=device, requires_grad=True)
    with LiveBytes(device) as live:
        a = torch.exp(x)     # 4000, saved by its backward
        b = torch.exp(a)     # 4000, saved by its backward
        loss = b.sum()       # 4
        del a, b             # the graph still holds both
        assert live.live == 8004
        loss.backward()
    # The backward's seed (4) and b's gradient (4000) on top of the saved
    # tensors: 12008. The engine then frees b, the seed, a and b's gradient
    # as their nodes finish; the loss and x's gradient are left.
    assert live.transient == 12008
    assert live.output == 4004


# ---------------------------------------------------------------------------
# the kernels' meta rules against their wrappers' allocation helpers


def _meta(*shapes_dtypes):
    return [torch.empty(s, dtype=d, device="meta") for s, d in shapes_dtypes]


def _nbytes(xs) -> int:
    return sum(x.untyped_storage().nbytes() for x in xs if isinstance(x, torch.Tensor))


LIF_KW = dict(p11=0.9, p21=0.1, p22=0.95, v_th=15.0, v_reset=0.0, t_ref_steps=20)


def _kernel_case(name):
    """``(call the ops wrapper on meta inputs at a small shape, what its
    CUDA wrapper allocates (its helper's tensors), what it returns, the
    returned tensors the launch made)``."""
    f32, i32, i8, b = torch.float32, torch.int32, torch.int8, torch.bool
    a, n, k, d_win = 3, 40, 6, 4
    if name == "lif_update":
        v, i_syn, refrac, i_in, alive = _meta(((a, n), f32), ((a, n), f32), ((a, n), i32),
                                              ((a, n), f32), ((a, n), b))
        allocs = list(klif.allocations(v, i_syn, refrac, alive))
        return (lambda: ops.lif_update(v, i_syn, refrac, i_in, alive, **LIF_KW)), \
            allocs, allocs, allocs
    if name == "spike_deliver":
        spikes, src, w, delay = _meta(((a * n,), f32), ((a * n, k), i32), ((a * n, k), f32),
                                      ((a * n, k), i8))
        out, mask = kdeliver.allocations(spikes, src, 7)
        return (lambda: ops.spike_deliver(spikes, src, w, delay, steps_lo=1, r_span=7)), \
            [out, mask], [out], [out]
    if name in ("superstep_lif", "superstep_iaf"):
        fut, src, w, delay = _meta(((a, n, d_win + 8), f32), ((a, n, k), i32),
                                   ((a, n, k), f32), ((a, n, k), i8))
        span = dict(d_win=d_win, steps_lo=1, r_span=8)
        if name == "superstep_lif":
            v, i_syn, refrac, drive_p, gids, alive = _meta(
                ((a, n), f32), ((a, n), f32), ((a, n), i32), ((a, n), f32), ((a, n), i32),
                ((a, n), b))
            al = kcycle.lif_allocations(v, i_syn, refrac, d_win)
            made = [al["v"], al["i_syn"], al["refrac"], al["spikes"]]
            return (lambda: ops.superstep_lif(
                v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, 0, **span,
                **LIF_KW, seed=1, w_ext=0.1)), made + [al["masks"], al["sync"]], \
                made[:3] + [fut, al["spikes"]], made
        countdown, interval, alive = _meta(((a, n), i32), ((a, n), i32), ((a, n), b))
        al = kcycle.iaf_allocations(countdown, d_win)
        made = [al["countdown"], al["spikes"]]
        return (lambda: ops.superstep_iaf(countdown, fut, interval, alive, src, w, delay,
                                          **span)), list(al.values()), \
            [al["countdown"], fut, al["spikes"]], made
    if name == "event_deliver":
        ring, ids, tgt, w, delay = _meta(((a * n, 16), f32), ((d_win, 9), i32),
                                         ((a * n, k), i32), ((a * n, k), f32), ((a * n, k), i8))
        numel = kevent.scratch_numel(ring, ids, tgt)
        assert numel == 2 + d_win * 9
        return (lambda: ops.event_deliver_block(ring, ids, tgt, w, delay, 0)), \
            _meta(((numel,), torch.int64)), [ring], []
    q, kv = _meta(((2, 64, 4, 16), torch.bfloat16), ((2, 64, 2, 16), torch.bfloat16))
    out = kflash.allocations(q)
    return (lambda: ops.flash_attention(q, kv, kv, 0, 64)), [out], [out], [out]


@pytest.mark.parametrize("name", ["lif_update", "spike_deliver", "superstep_lif",
                                  "superstep_iaf", "event_deliver", "flash_attention"])
def test_a_kernels_meta_rule_allocates_what_its_wrapper_allocates(name):
    call, allocs, returned, made = _kernel_case(name)
    before = dict(cuda.launches)
    with LiveBytes("meta") as live:
        got = call()
    got = list(got) if isinstance(got, tuple) else [got]
    assert [(tuple(x.shape), x.dtype, x.device.type) for x in got] == \
        [(tuple(x.shape), x.dtype, x.device.type) for x in returned]
    # the outputs and the scratch alive at once; the scratch freed on return
    assert live.transient == _nbytes(allocs) > 0
    assert live.output == _nbytes(made)
    assert cuda.launches == before


# ---------------------------------------------------------------------------
# the priced LM calls and SNN windows against the tracker's count on the CPU


def _tracked(fn):
    with LiveBytes("cpu") as live:
        out = fn()
    del out
    return {"transient": live.transient, "output": live.output}


def _window_net():
    spec = mam_benchmark_spec(**SPEC)
    return spec, connectivity_lib.build_network(spec, seed=12, size_multiple=8, device="cpu")


def memory_rank(mesh, payload):
    """On this rank of a gloo world, the tracker's count of a training
    step, a prefill, a decode and one window on each backend of
    :data:`BACKENDS`, on real CPU tensors."""
    out = {}
    bundle = get_arch(ARCH, reduced=True, **REMAT)
    art = make_train_artifacts(bundle, mesh=mesh, batch_axes=("data",))
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    opt = adamw_init(params, AdamWConfig(moment_dtype=bundle.moment_dtype))
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    toks = np.random.default_rng(5).integers(0, bundle.cfg.vocab, (mesh.shape["data"], SEQ))
    batch = host_batch({"tokens": toks, "labels": toks}, mesh, ("data",))
    out["train"] = _tracked(lambda: art.step_fn(params, opt, batch))

    bundle = get_arch(ARCH, reduced=True)
    art = make_serve_artifacts(bundle, SERVE, mesh)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(5).integers(0, bundle.cfg.vocab,
                                             (SERVE.global_batch, PROMPT + 1))
    batch = host_batch({"tokens": toks}, mesh, art.batch_axes)
    prompt = {"tokens": batch["tokens"][:, :PROMPT]}
    out["prefill"] = _tracked(lambda: art.prefill_fn(params, prompt))
    _, state = art.prefill_fn(params, prompt)
    out["decode"] = _tracked(lambda: art.decode_fn(params, state, batch["tokens"][:, PROMPT:],
                                                   PROMPT))

    spec, net = _window_net()
    for backend in BACKENDS:
        engine = dist_engine_lib._make_dist_engine(net, spec, mesh,
                                                   EngineConfig(delivery_backend=backend))
        st = engine.init()
        out[backend] = _tracked(lambda: engine.window(st))
    return out


def _priced(layout) -> dict:
    """The dry run's prices of the calls :func:`memory_rank` counts."""
    out = {"train": dryrun.price_lm(get_arch(ARCH, reduced=True, **REMAT),
                                    ShapeSpec("t", "train", SEQ, 1), layout,
                                    count_flops=False)["rank_bytes"]}
    bundle = get_arch(ARCH, reduced=True)
    prefill = ShapeSpec(SERVE.name, "prefill", SERVE.seq_len, SERVE.global_batch)
    out["prefill"] = dryrun.price_lm(bundle, prefill, layout, prompt_len=PROMPT,
                                     count_flops=False)["rank_bytes"]
    out["decode"] = dryrun.price_lm(bundle, SERVE, layout, cache_index=PROMPT,
                                    count_flops=False)["rank_bytes"]
    spec, net = _window_net()
    net = dataclasses.replace(net, **{
        f.name: torch.empty_like(getattr(net, f.name), device="meta")
        for f in dataclasses.fields(net) if isinstance(getattr(net, f.name), torch.Tensor)})
    for backend in BACKENDS:
        out[backend] = dryrun.price_window(net, spec, layout,
                                           EngineConfig(delivery_backend=backend))
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_the_meta_price_equals_the_count_on_cpu_tensors(tmp_path, shape):
    names = ("data", "model")
    ranks = run_world(tmp_path, shape, names, "test_torch_dryrun_memory:memory_rank")
    for r, got in enumerate(ranks):
        priced = _priced(MeshLayout(shape, names, r))
        for call, counted in got.items():
            assert counted["transient"] > 0, (shape, r, call)
            assert {k: priced[call][k] for k in ("transient", "output")} == counted, \
                (shape, r, call)
        train = priced["train"]
        assert train["peak"] == train["held"] - train["grad_accum"] + train["transient"]
        prefill = priced["prefill"]
        assert prefill["peak"] == prefill["params"] + prefill["batch"] + prefill["transient"]
        assert prefill["output"] >= prefill["cache"]  # the cache it returns
        decode = priced["decode"]
        assert decode["peak"] == decode["held"] + decode["transient"]


# ---------------------------------------------------------------------------
# the rows


def test_an_fsdp_cells_transient_holds_its_gathered_units_and_the_flop_pass_agrees():
    layout = MeshLayout((2, 2), ("data", "model"))
    bundle = get_arch("grok-1-314b", reduced=True, remat="full")
    shape = ShapeSpec("t", "train", SEQ, 1)
    rb = dryrun.price_lm(bundle, shape, layout, n_micro=2, count_flops=False)["rank_bytes"]
    assert 0 < rb["gathered"] <= rb["transient"]
    assert rb["transient"] >= rb["grad_accum"]  # the step makes its accumulator
    stacked = dryrun.price_lm(bundle, shape, layout, n_micro=2)["rank_bytes"]
    assert {k: stacked[k] for k in ("transient", "output", "peak")} == \
        {k: rb[k] for k in ("transient", "output", "peak")}


def test_a_row_whose_held_bytes_fit_but_whose_peak_does_not_fails_the_gate():
    row = dryrun.dryrun_snn_cell("structure_aware", False)  # onehot, 16 x 16
    rb = row["rank_bytes"]
    assert rb["peak"] == rb["total"] + rb["transient"]
    budget = (rb["total"] / 2**30 + rb["peak"] / 2**30) / 2
    gated = dryrun.enforce_hbm_budget(dict(row, rank_bytes=dict(rb)), budget)
    assert gated["status"].startswith("FAIL(HBM: modelled"), gated["status"]
    assert gated["hbm_gib_modelled"] == round(rb["peak"] / 2**30, 3)
    # the same held bytes alone, as the gate read them before, would pass
    assert rb["total"] / 2**30 < budget
    ok = dryrun.enforce_hbm_budget(dict(row, rank_bytes=dict(rb)), rb["peak"] / 2**30 + 1)
    assert ok["status"] == "OK"
