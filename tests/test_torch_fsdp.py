"""FSDP on a process mesh, one unit at a time (``repro_torch.models.fsdp``):
what a rank holds gathered, its gradient accumulator, and the reduce-scatter
that sums the gradients, in gloo CPU worlds.

Reduced qwen2-0.5b (tied embeddings) and reduced grok-1 (MoE), weights
drawn by the port from seed 0, batches from ``SyntheticLM``, AdamW lr 1e-3:

* a ``(data, model)`` = (2, 1) world runs the sync trainer with FSDP over
  ``data`` and two microbatches a rank for 2 steps, and a ``(pod, data,
  model)`` = (2, 2, 1) world the hierarchical int8 trainer alike (2 local
  steps). In every step the peak of the gathered parameter bytes alive on
  a rank (``comm.gathered``) is the largest unit's bytes (a layer, the
  embedding, the head, the final norm), far below the rank's whole model,
  and none is alive after the step; the step's accumulator is f32 of
  exactly the rank's shards' shapes; and the step is within
  ``tests/test_torch_train.py``'s bars (losses 1e-4 relative; per element
  ``2 * lr * steps``, 99% within 1e-5 of the largest) of the one-device
  trainer at ``n_micro`` 4 (the microbatches' gradients are summed in
  another order: each over the batch ranks first);
* the (2, 2, 1) world also serves on a ``(data, model)`` = (2, 2) mesh
  (FSDP over ``data``, the compute over ``model``): a prefill and 2 decode
  steps, whose logits are within 1e-4 (prefill) and 5e-4 (decode) of the
  largest of the one-device serving of the rank's batch slice, with a peak
  gathered of the largest unit's model shard;
* on the (2, 1) world a step of 1, 2 and 4 microbatches a rank counts
  what ``dryrun.price_lm`` prices on a ``MeshLayout``: every collective,
  the gathered peak and the accumulator's bytes;
* ``comm.reduce_scatter_in_order`` is bitwise this rank's block of
  ``comm.sum_in_order``'s sum over group sizes 2 (``data``) and 4 (``pod,
  data``, blocks over ``data``, and over both), in bf16 and f32, blocks
  along either dimension; the bytes it counts are ``n - 1`` blocks, and a
  ``MeshLayout`` prices the same.
"""

import numpy as np
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core import comm
from repro_torch.core.mesh import MeshLayout, ProcessMesh
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_serve_artifacts, make_train_artifacts
from test_torch_comm import run_world

ARCHS = ("qwen2-0.5b", "grok-1-314b")
LR = 1e-3
SEQ, STEPS, MICRO = 16, 2, 2
SERVE = ShapeSpec("serve", "decode", 32, 4)
PROMPT, DECODE_STEPS = 12, 2
PREFILL_BAR, DECODE_BAR = 1e-4, 5e-4
PRICED_MICRO = (1, 2, 4)  # microbatches a rank of the steps held counted == priced


def _opt():
    return AdamWConfig(lr=LR, warmup_steps=2)


def _init(bundle):
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    return params, adamw_init(params, _opt())


def _np(tree) -> dict:
    return {n: x.detach().numpy().copy() for n, x in named_leaves(tree).items()}


def _units(art, mesh) -> dict:
    """The bytes of each unit as a rank computes on it: its leaves whole
    over every axis but ``model``, keyed ``layers.i`` or the top-level
    name."""
    out = {}
    sds = art.params_sds if getattr(art, "hier", None) is None else art.hier.pod(art.params_sds, 0)
    for n, x in named_leaves(sds).items():
        parts = n.split(".")
        key = ".".join(parts[:2]) if parts[0] == "layers" else parts[0]
        numel = x.numel()
        for e in art.model_specs.get(n, ()):
            if e is not None:
                numel //= mesh.extent(e)
        out[key] = out.get(key, 0) + numel * x.element_size()
    return out


class _Recorder(layers.FSDP):
    """The trainer's gather point, kept for the test to read."""
    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recorder.made.append(self)


def _train(bundle, art, mesh, batch_of, steps, hier):
    """``steps`` steps on this rank; each step's gathered peak (and what
    stayed alive after it) and its accumulator's dtypes and shapes."""
    params, opt = _init(bundle)
    if hier:
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    peaks, live, accs, losses = [], [], [], []
    orig, layers.FSDP = layers.FSDP, _Recorder
    try:
        for step in range(steps):
            _Recorder.made.clear()
            comm.reset_stats()
            params, opt, m = art.step_fn(params, opt, batch_of(step))
            peaks.append(comm.gathered["peak"])
            live.append(comm.gathered["live"])
            (fsdp,) = _Recorder.made
            accs.append({n: (str(g.dtype), tuple(g.shape)) for n, g in fsdp.acc.items()})
            accs[-1]["bytes"] = art.accumulator_bytes(params)
            losses.append(m["loss"].detach().numpy().copy())
            del fsdp
            _Recorder.made.clear()
    finally:
        layers.FSDP = orig
    shards = {n: tuple(x.shape[1:] if hier else x.shape)
              for n, x in named_leaves(params).items()}
    return dict(peaks=peaks, live=live, accs=accs, shards=shards, losses=losses,
                units=_units(art, mesh), params=_np(art.gather(params, "params")))


def sync_rank(mesh, payload):
    out = {}
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",), n_micro=MICRO)
        ds = SyntheticLM(bundle.cfg.vocab, SEQ, 2 * MICRO, seed=1)
        out[arch] = _train(bundle, art, mesh, lambda s: host_batch(ds.batch(s), mesh, ("data",)),
                           STEPS, False)
    out["priced"] = {n: _counted_and_priced(mesh, n) for n in PRICED_MICRO}
    return out


def _counted_and_priced(mesh, n_micro):
    """One step of ``n_micro`` microbatches a rank (one sequence each,
    reduced qwen2 with remat as published): what comm counted and the
    gathered peak and accumulator bytes, beside ``price_lm``'s."""
    bundle = get_arch("qwen2-0.5b", reduced=True, remat="dots")
    art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",), n_micro=n_micro)
    params, opt = _init(bundle)
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, 2 * n_micro, seed=3)
    comm.reset_stats()
    art.step_fn(params, opt, host_batch(ds.batch(0), mesh, ("data",)))
    counted = (dryrun._table(), comm.gathered["peak"], art.accumulator_bytes(params))
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    row = dryrun.price_lm(bundle, ShapeSpec("t", "train", SEQ, 1), layout, n_micro=n_micro,
                          count_flops=False)
    return counted, (row["collectives"], row["rank_bytes"]["gathered"],
                     row["rank_bytes"]["grad_accum"])


def _serve_case(bundle, mesh, toks):
    """A prefill and ``DECODE_STEPS`` decode steps of ``toks`` on ``mesh``
    (this rank's slice) or on one device: the logits and each call's
    gathered peak."""
    art = make_serve_artifacts(bundle, SERVE if mesh else ShapeSpec(
        "serve", "decode", SERVE.seq_len, toks.shape[0]), mesh)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(toks)
    logits, peaks = [], []
    comm.reset_stats()
    out, state = art.prefill_fn(params, {"tokens": toks[:, :PROMPT]})
    logits.append(out.numpy().copy())
    peaks.append(comm.gathered["peak"])
    for i in range(PROMPT, PROMPT + DECODE_STEPS):
        comm.reset_stats()
        out, state = art.decode_fn(params, state, toks[:, i:i + 1], i)
        logits.append(out.numpy().copy())
        peaks.append(comm.gathered["peak"])
    return logits, peaks, art


def _serve_toks(bundle):
    rng = np.random.default_rng(7)
    return rng.integers(0, bundle.cfg.vocab, (SERVE.global_batch, PROMPT + DECODE_STEPS))


def _blocks_case(mesh, axes, spec, dtype, shape, seed):
    """``reduce_scatter_in_order`` against ``sum_in_order`` cut to the
    block, on this rank's draw; and what each counted."""
    x = torch.from_numpy(np.random.default_rng(seed + mesh.rank).normal(
        size=shape).astype(np.float32)).to(dtype)
    comm.reset_stats()
    got = comm.reduce_scatter_in_order(x, mesh, axes, spec)
    counted = dict(comm.received)
    want = mesh.shard(comm.sum_in_order(x, mesh, axes), spec)
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    comm.reset_stats()
    priced = comm.reduce_scatter_in_order(x.to("meta"), layout, axes, spec)
    return dict(bitwise=got.dtype == want.dtype and torch.equal(got, want)
                and got.shape == want.shape, counted=counted, priced=dict(comm.received),
                meta_shape=tuple(priced.shape), block=want.numel() * x.element_size())


BLOCK_CASES = [  # (axes, spec, dtype, shape)
    (("data",), ("data", None), torch.bfloat16, (6, 5)),
    (("data",), (None, "data"), torch.float32, (3, 8)),
    (("pod", "data"), ("data", None), torch.bfloat16, (4, 7)),
    (("pod", "data"), (None, "data"), torch.float32, (5, 6)),
    (("pod", "data"), (("pod", "data"), None), torch.float32, (8, 3)),
]


def hier_rank(mesh, payload):
    out = {"coords": mesh.coords, "train": {}, "serve": {}}
    hier_cfg = HierarchicalConfig(sync_every=10, compression="int8")
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",), n_micro=MICRO,
                                   hier_cfg=hier_cfg)
        ds = SyntheticLM(bundle.cfg.vocab, SEQ, 4 * MICRO, seed=1)
        out["train"][arch] = _train(bundle, art, mesh,
                                    lambda s: host_batch(ds.batch(s), mesh, ("data",), "pod"),
                                    STEPS, True)
    out["blocks"] = [_blocks_case(mesh, *case, seed=i) for i, case in enumerate(BLOCK_CASES)]
    serve_mesh = ProcessMesh((2, 2), ("data", "model"), device="cpu")
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        toks = host_batch({"t": _serve_toks(bundle)}, serve_mesh, ("data",))["t"].numpy()
        logits, peaks, art = _serve_case(bundle, serve_mesh, toks)
        out["serve"][arch] = dict(logits=logits, peaks=peaks, units=_units(art, serve_mesh),
                                  data=serve_mesh.axis_index("data"))
    return out


def _ref_train(arch, hier):
    bundle = get_arch(arch, reduced=True)
    if hier:
        art = make_train_artifacts(bundle, _opt(), hier_cfg=HierarchicalConfig(
            sync_every=10, compression="int8"), n_pods=2, n_micro=2 * MICRO)
    else:
        art = make_train_artifacts(bundle, _opt(), n_micro=2 * MICRO)
    params, opt = _init(bundle)
    if hier:
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, (4 if hier else 2) * MICRO, seed=1)
    losses = []
    for step in range(STEPS):
        batch = host_batch(ds.batch(step), "cpu", n_pods=2 if hier else None)
        params, opt, m = art.step_fn(params, opt, batch)
        losses.append(m["loss"].detach().numpy().copy())
    return _np(params), losses


def _assert_within_bars(got, want, losses, want_losses, what):
    wl = np.asarray(want_losses, dtype=np.float64)
    gl = np.asarray(losses, dtype=np.float64).reshape(wl.shape)
    assert np.abs(gl - wl).max() <= 1e-4 * np.abs(wl).max(), what
    top = max(np.abs(w).max() for w in want.values())
    close = total = 0
    for n, w in want.items():
        d = np.abs(got[n].astype(np.float64) - w)
        assert d.max() <= 2 * LR * STEPS, (what, n)
        close += int((d <= 1e-5 * top).sum())
        total += d.size
    assert close >= 0.99 * total, what


def _assert_train(run, what):
    largest = max(run["units"].values())
    assert all(p == largest for p in run["peaks"]), (what, run["peaks"], run["units"])
    assert largest < sum(run["units"].values()) // 2, what  # a unit, never the whole model
    assert run["live"] == [0] * STEPS, what
    for acc in run["accs"]:
        assert acc.pop("bytes") == 4 * sum(np.prod(s) for s in run["shards"].values()), what
        assert acc == {n: ("torch.float32", s) for n, s in run["shards"].items()}, what


def test_sync_trainer_gathers_one_unit_and_accumulates_the_shard(tmp_path):
    ranks = run_world(tmp_path, (2, 1), ("data", "model"), "test_torch_fsdp:sync_rank")
    for arch in ARCHS:
        want, want_losses = _ref_train(arch, False)
        for r, got in enumerate(ranks):
            _assert_train(got[arch], (arch, r))
            _assert_within_bars(got[arch]["params"], want, got[arch]["losses"], want_losses,
                                (arch, r))
    # counted == priced at 1, 2 and 4 microbatches a rank (the dry run prices
    # 4 from steps of 2 and 3): every collective, the gathered peak, the
    # accumulator; the gradients' reduce-scatter and the norm's gathers among them
    for r, got in enumerate(ranks):
        for n, (counted, priced) in got["priced"].items():
            assert counted == priced, (r, n, counted, priced)
            assert {"reduce_scatter_in_order data", "norm_gather data", "all_gather data",
                    "sum_in_order data"} <= set(counted[0]), (r, n, counted[0])


def test_hierarchical_trainer_serving_and_reduce_scatter_on_a_pod_data_model_world(tmp_path):
    ranks = run_world(tmp_path, (2, 2, 1), ("pod", "data", "model"), "test_torch_fsdp:hier_rank")
    for arch in ARCHS:
        want, want_losses = _ref_train(arch, True)
        for r, got in enumerate(ranks):
            run = got["train"][arch]
            _assert_train(run, (arch, r))
            pod = got["coords"]["pod"]
            _assert_within_bars({n: x[pod] for n, x in run["params"].items()},
                                {n: x[pod] for n, x in want.items()}, run["losses"],
                                [x[pod:pod + 1] for x in want_losses], (arch, r))
    # serving on (2, 2): each rank's slice against one device
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        toks = _serve_toks(bundle)
        refs = {d: _serve_case(bundle, None, toks[2 * d:2 * d + 2])[0] for d in range(2)}
        for r, got in enumerate(ranks):
            case = got["serve"][arch]
            largest = max(case["units"].values())
            assert case["peaks"] == [largest] * (1 + DECODE_STEPS), (arch, r, case["peaks"])
            for call, (g, w) in enumerate(zip(case["logits"], refs[case["data"]])):
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= (PREFILL_BAR if call == 0 else DECODE_BAR), (arch, r, call, err)
    # the reduce-scatter: bitwise sum_in_order's block, n - 1 blocks in, priced alike
    for r, got in enumerate(ranks):
        for (axes, *_), case in zip(BLOCK_CASES, got["blocks"]):
            n = 2 * len(axes)
            key = ("reduce_scatter_in_order", axes)
            assert case["bitwise"], (r, axes)
            assert case["counted"] == case["priced"] == {key: (n - 1) * case["block"]}, (r, axes)
