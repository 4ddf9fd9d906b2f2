"""The training step's compute split over the model axis (``TPSplit``) on
gloo CPU worlds, against one process, the port's one-device trainer and
JAX's sync trainer on a mesh of forced host devices.

* **The collectives that carry gradients** (``comm.enter_split``,
  ``sum_partials``, ``gather_split``, ``own_slice``, ``max_over``) over
  ``model`` of a ``(data, model)`` = (2, 2) world: forward and gradient
  against the same sums and slices in one process, every sum bitwise the
  f32 sum in rank order; what ``comm`` counts equals its price on meta
  tensors over a ``MeshLayout`` of the same rank.
* **The split sync trainer** on the same world, reduced configs in f32,
  weights drawn by the port from seed 0 (the JAX mesh gets the same
  weights through ``params_to_numpy``), batches from ``SyntheticLM``
  (global batch 4, S 16), AdamW lr 1e-3, 2 steps: qwen2 with head-parallel
  attention (``remat="dots"``), qwen2 context-parallel
  (``attn_sharding="seq"``, the JAX step pinned and run inside
  ``jax.set_mesh``), grok-1 with ``"tp"`` experts (``remat="full"``) and
  llama4-maverick with ``"ep"`` experts and a shared expert. Each rank's
  losses and gathered parameters are within ``tests/test_torch_train.py``'s
  bars (losses 1e-4 relative; per element ``2 * lr * steps``, 99% within
  1e-5 of the largest parameter) of JAX's trainer on a (2, 2) ``Auto`` mesh
  (``n_micro`` 2: each microbatch a data rank's slice, the tokens an MoE
  aux loss is taken over) and of the port's one-device trainer at
  ``n_micro`` 2, and so are its
  moments of the one-device trainer's. The leaves replicated over
  ``model`` (norm scales, the router, biases) are bitwise alike on the
  model ranks. A MoE routing flip against the one-device forward of the
  first step is logged with its gate margin and fails above 1e-5.
* **The split hierarchical trainer** on (pod, data, model) = (2, 1, 2):
  4 local steps, an int8 sync, 1 more, on qwen2 and grok-1, within the
  same bars of the one-device trainer (after the sync, one step of the
  int8 grid more, as there).
* **The routed experts under "ep"** with ``top_k`` 2 and no shared expert:
  the MoE layer's output bitwise the one-device layer's (the ranks add
  exact zeros).
* **Refusals**, without a world: a model extent that does not divide the
  KV heads (head-parallel asked for), the columns, the experts, the
  sequence, mamba2's SSM heads or whisper's heads raises ``ValueError``
  naming it.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core import comm
from repro_torch.core.mesh import MeshLayout
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.launch import dryrun
from repro_torch.models import moe as moe_lib
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts, tp_split
from test_torch_comm import ROOT, run_world

LR = 1e-3
SEQ, BATCH = 16, 4
STEPS = 2
HIER_STEPS, SYNC_AT = 5, 4
MARGIN = 1e-5
# name: (arch, config overrides, the JAX step pinned under jax.set_mesh)
CASES = {
    "qwen2-heads": ("qwen2-0.5b", {"remat": "dots"}, False),
    "qwen2-seq": ("qwen2-0.5b", {"act_batch_axes": ("data",), "attn_sharding": "seq"}, True),
    "grok-tp": ("grok-1-314b", {"remat": "full"}, False),
    "llama4-ep": ("llama4-maverick-400b-a17b", {}, False),
}
HIER_CASES = ("qwen2-0.5b", "grok-1-314b")


def _opt():
    return AdamWConfig(lr=LR, warmup_steps=2)


def _bundle(case):
    arch, overrides, _ = CASES[case]
    return get_arch(arch, reduced=True, **overrides)


def _np(tree) -> dict:
    return {n: x.detach().numpy().copy() for n, x in named_leaves(tree).items()}


class _Routes:
    """Records every ``moe.route`` call's top-k choice and sorted gates."""

    def __init__(self):
        self.calls, self.on = [], False
        self._route = moe_lib.route

    def __enter__(self):
        def route(p, x, cfg):
            out = self._route(p, x, cfg)
            if self.on:
                gates = torch.sort(out[0].detach(), dim=-1, descending=True).values
                self.calls.append((out[2].numpy().copy(), gates[..., :cfg.top_k + 1].numpy()))
            return out
        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        moe_lib.route = self._route


def _train(bundle, art, batch_of, steps=STEPS, hier_cfg=None):
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    opt = adamw_init(params, _opt())
    sync = None
    if hier_cfg is not None:
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
        sync = art.shard(sync, "sync")
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    losses, norms = [], []
    with _Routes() as routes:
        for step in range(steps):
            if hier_cfg is not None and step == SYNC_AT:
                params, sync = art.sync_fn(params, sync)
            routes.on = step == 0
            params, opt, m = art.step_fn(params, opt, batch_of(step))
            losses.append(m["loss"].detach().numpy().copy())
            norms.append(m["grad_norm"].detach().numpy().copy())
    return params, opt, losses, norms, routes.calls


# ---------------------------------------------------------------------------
# the ranks


def _collectives(mesh) -> dict:
    """Each collective's forward and gradient on this rank, and what comm
    counted against its price on meta tensors."""
    r = mesh.axis_index("model")
    rng = np.random.default_rng(7)
    common = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    mine = torch.from_numpy(rng.normal(size=(2, 2, 6)).astype(np.float32))[r]
    out = {}
    ops = {
        # name: (input, forward, rank-specific weight of the loss)
        "enter_split": (common, lambda x: comm.enter_split(x, mesh, "model"), mine),
        "sum_partials": (mine, lambda x: comm.sum_partials(x, mesh, "model"), common),
        "gather_split": (mine, lambda x: comm.gather_split(x, mesh, "model", dim=1),
                         torch.cat([common, common], dim=1)),
        "own_slice": (common, lambda x: comm.own_slice(x, mesh, "model", dim=1), mine[:, :3]),
    }
    comm.reset_stats()
    for name, (x, fn, w) in ops.items():
        x = x.clone().requires_grad_()
        y = fn(x)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    out["max_over"] = comm.max_over(mine, mesh, "model").numpy()
    out["bf16_sum"] = comm.sum_partials(mine.bfloat16(), mesh, "model").float().numpy()
    counted = dryrun._table()
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    comm.reset_stats()
    for name, (x, fn, w) in ops.items():
        fn_meta = {"enter_split": lambda t: comm.enter_split(t, layout, "model"),
                   "sum_partials": lambda t: comm.sum_partials(t, layout, "model"),
                   "gather_split": lambda t: comm.gather_split(t, layout, "model", dim=1),
                   "own_slice": lambda t: comm.own_slice(t, layout, "model", dim=1)}[name]
        xm = x.to("meta").requires_grad_()
        torch.autograd.grad((fn_meta(xm) * w.to("meta")).sum(), xm)
    comm.max_over(mine.to("meta"), layout, "model")
    comm.sum_partials(mine.bfloat16().to("meta"), layout, "model")
    out["counted"], out["priced"] = counted, dryrun._table()
    return out


def _replicated_shards(art, params) -> dict:
    """This rank's shards of the leaves no spec splits over ``model``."""
    return {n: x for n, x in _np(params).items()
            if all(e is None for e in art.model_specs[n])}


def sync_rank(mesh, payload):
    """One rank of the (data, model) = (2, 2) world."""
    out = {"coords": mesh.coords, "collectives": _collectives(mesh)}
    for case in CASES:
        bundle = _bundle(case)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",))
        ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
        params, opt, losses, norms, routes = _train(
            bundle, art, lambda s: host_batch(ds.batch(s), mesh, ("data",)))
        out[case] = {"attn": art.split.attn, "losses": losses, "norms": norms,
                     "replicated": _replicated_shards(art, params), "routes": routes,
                     "params": _np(art.gather(params, "params")),
                     "opt": _np(art.gather(opt, "opt"))}
    return out


def _hier_cfg():
    return HierarchicalConfig(sync_every=SYNC_AT, compression="int8")


def hier_rank(mesh, payload):
    """One rank of the (pod, data, model) = (2, 1, 2) world."""
    out = {"coords": mesh.coords}
    for arch in HIER_CASES:
        bundle = get_arch(arch, reduced=True)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",),
                                   hier_cfg=_hier_cfg())
        ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
        params, opt, losses, _, _ = _train(
            bundle, art, lambda s: host_batch(ds.batch(s), mesh, ("data",), "pod"),
            HIER_STEPS, _hier_cfg())
        out[arch] = {"losses": losses, "replicated": _replicated_shards(art, params),
                     "params": _np(art.gather(params, "params", ("data", "model")))}
    return out


# ---------------------------------------------------------------------------
# the references


def _one_device(case):
    bundle = _bundle(case)
    art = make_train_artifacts(bundle, _opt(), n_micro=2)
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
    params, opt, losses, norms, routes = _train(bundle, art,
                                                lambda s: host_batch(ds.batch(s), "cpu"))
    return _np(params), _np(opt), losses, norms, routes


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def _jax_sync(tmp_path) -> subprocess.Popen:
    """JAX's sync trainer for every case on a (2, 2) ``Auto`` mesh of forced
    host devices (FSDP over data, TP over model), in a subprocess, from the
    port's initial weights; the pinned cases run inside ``jax.set_mesh``.
    It takes the global batch in 2 microbatches: each is a data rank's
    slice, so an MoE aux loss is taken over the tokens the port's rank
    takes it over (the mean over the whole batch is another function)."""
    for case in CASES:
        bundle = _bundle(case)
        init = bundle.model.init_params(torch.Generator().manual_seed(0))
        np.savez(tmp_path / f"init-{case}.npz",
                 **{"/".join(k): v for k, v in _flat(bundle.model.params_to_numpy(init)).items()})
    code = textwrap.dedent(f"""
        import contextlib
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.registry import get_arch
        from repro.data.pipeline import SyntheticLM, host_batch
        from repro.optim.adamw import AdamWConfig, adamw_init
        from repro.train.steps import make_train_artifacts

        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        cfg = AdamWConfig(lr={LR}, warmup_steps=2)
        for case, (arch, overrides, pinned) in {CASES!r}.items():
            b = get_arch(arch, reduced=True, **overrides)
            art = make_train_artifacts(b, cfg, mesh=mesh, batch_axes=("data",), n_micro=2,
                                       donate=False)
            params = {{}}
            for key, v in np.load(f"{tmp_path}/init-{{case}}.npz").items():
                node = params
                *head, last = key.split("/")
                for k in head:
                    node = node.setdefault(k, {{}})
                node[last] = jnp.asarray(v)
            opt = adamw_init(params, cfg)
            put = lambda t, s: jax.tree.map(
                lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s,
                is_leaf=lambda x: isinstance(x, P))
            params, opt = put(params, art.params_specs), put(opt, art.opt_specs)
            ds = SyntheticLM(b.cfg.vocab, {SEQ}, {BATCH}, seed=1)
            losses = []
            with jax.set_mesh(mesh) if pinned else contextlib.nullcontext():
                for s in range({STEPS}):
                    params, opt, m = art.step_fn(params, opt,
                                                 host_batch(ds.batch(s), mesh, ("data",)))
                    losses.append(float(m["loss"]))
            out = {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
                   for path, x in jax.tree_util.tree_leaves_with_path(params)}}
            np.savez(f"{tmp_path}/jax-{{case}}.npz", losses=np.asarray(losses), **out)
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


# ---------------------------------------------------------------------------
# the bars


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def assert_within_bars(got: dict, want: dict, steps: int, what, grid: float = 0.0) -> None:
    """``tests/test_torch_train.py``'s bars on parameters: per element
    ``2 * lr * steps``, 99% within 1e-5 of the largest (plus ``grid``)."""
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    close = total = 0
    for key, w in want.items():
        d = np.abs(got[key].astype(np.float64) - w)
        assert d.max() <= 2 * LR * steps, (what, key, d.max())
        close += int((d <= 1e-5 * top + grid).sum())
        total += d.size
    assert close >= 0.99 * total, (what, close / total)


def assert_moments_close(got: dict, want: dict, what) -> None:
    """AdamW's moments: 99% of the elements within 1e-5 of each moment's
    largest, the counts equal."""
    assert got.keys() == want.keys(), what
    for part in ("m", "v"):
        keys = [k for k in want if k.startswith(part + ".")]
        top = max(np.abs(want[k]).max() for k in keys)
        close = sum(int((np.abs(got[k] - want[k]) <= 1e-5 * top).sum()) for k in keys)
        assert close >= 0.99 * sum(want[k].size for k in keys), (what, part)
    assert np.array_equal(got["count"], want["count"]), what


def assert_no_routing_flip(got_calls, want_calls, what) -> list:
    """The top-k choices of the split forward against the one-device
    forward's, call by call; a token whose choice differs is logged with
    the reference's smallest gap between its top-(k + 1) gates and fails
    above ``MARGIN``."""
    assert len(got_calls) == len(want_calls), what
    flips = []
    for i, ((gi, _), (wi, wg)) in enumerate(zip(got_calls, want_calls)):
        for b, s in zip(*np.nonzero((gi != wi).any(-1))):
            margin = float(np.abs(np.diff(wg[b, s])).min())
            flips.append((what, i, int(b), int(s), margin))
    print(f"routing flips {what}: {flips}")
    assert all(f[-1] <= MARGIN for f in flips), flips
    return flips


def _model_peers(ranks):
    """Pairs of ranks that differ only along ``model``."""
    return [(a, b) for a in range(len(ranks)) for b in range(a + 1, len(ranks))
            if {k: v for k, v in ranks[a]["coords"].items() if k != "model"}
            == {k: v for k, v in ranks[b]["coords"].items() if k != "model"}]


# ---------------------------------------------------------------------------
# the tests


def test_collectives_and_split_sync_trainer_on_a_data_model_world(tmp_path):
    jax_run = _jax_sync(tmp_path)
    try:
        ranks = run_world(tmp_path / "world", (2, 2), ("data", "model"), "test_torch_tp:sync_rank")
        refs = {case: _one_device(case) for case in CASES}
        jout, _ = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, jout[-3000:]

    # the collectives against one process
    rng = np.random.default_rng(7)
    common = rng.normal(size=(2, 6)).astype(np.float32)
    mine = rng.normal(size=(2, 2, 6)).astype(np.float32)
    for got in ranks:
        r = got["coords"]["model"]
        c = got["collectives"]
        total = np.zeros((2, 6), np.float32)
        for part in mine:
            total += part
        assert np.array_equal(c["enter_split"][0], common)
        assert np.array_equal(c["enter_split"][1], total)
        assert np.array_equal(c["sum_partials"][0], total)
        assert np.array_equal(c["sum_partials"][1], common)
        assert np.array_equal(c["gather_split"][0], np.concatenate(list(mine), axis=1))
        assert np.array_equal(c["gather_split"][1], common)
        assert np.array_equal(c["own_slice"][0], common[:, 3 * r:3 * r + 3])
        assert np.array_equal(c["own_slice"][1], np.concatenate([m[:, :3] for m in mine], 1))
        assert np.array_equal(c["max_over"], mine.max(axis=0))
        b16 = torch.from_numpy(mine).bfloat16().float().numpy()
        assert np.array_equal(c["bf16_sum"], torch.from_numpy(b16[0] + b16[1]).bfloat16()
                              .float().numpy())
        assert c["counted"] == c["priced"]
        assert {k.split()[0] for k in c["counted"]} == {
            "split_grad_sum", "partial_sum", "split_gather", "slice_grad_gather", "split_max"}

    for case, (arch, overrides, _) in CASES.items():
        params, opt, losses, norms, routes = refs[case]
        want_attn = "seq" if case == "qwen2-seq" else "heads"
        jax_out = dict(np.load(tmp_path / f"jax-{case}.npz"))
        jl = jax_out.pop("losses")
        bundle = _bundle(case)
        for r, got in enumerate(ranks):
            g = got[case]
            assert g["attn"] == want_attn, case
            # the port's one-device trainer: losses, grad norms, parameters, moments
            for i in range(STEPS):
                assert _rel(g["losses"][i], losses[i]) < 1e-4, (case, r, i)
                assert _rel(g["norms"][i], norms[i]) < 1e-4, (case, r, i)
            assert_within_bars(g["params"], params, STEPS, (case, r))
            assert_moments_close(g["opt"], opt, (case, r))
            # JAX's trainer on a mesh
            assert _rel([float(x) for x in g["losses"]], jl) < 1e-4, (case, r)
            as_jax = {"/".join(k): v for k, v in _flat(bundle.model.params_to_numpy(
                _as_module(bundle, g["params"]))).items()}
            assert_within_bars(as_jax, jax_out, STEPS, (case, r, "jax"))
            if bundle.cfg.moe is not None:
                want_calls = [c for i, c in enumerate(routes)
                              if i // (len(routes) // 2) == got["coords"]["data"]]
                assert_no_routing_flip(g["routes"], want_calls, (case, r))
        for a, b in _model_peers(ranks):
            ga, gb = ranks[a][case]["replicated"], ranks[b][case]["replicated"]
            assert ga.keys() == gb.keys() and ga, case
            bad = [n for n in ga if ga[n].tobytes() != gb[n].tobytes()]
            assert not bad, (case, a, b, bad[:4])


def _as_module(bundle, named: dict):
    params = bundle.model.init_params(None, device="meta")
    params.load_state_dict({n: torch.from_numpy(v) for n, v in named.items()}, assign=True)
    return params


def _one_device_hier(arch):
    bundle = get_arch(arch, reduced=True)
    art = make_train_artifacts(bundle, _opt(), hier_cfg=_hier_cfg(), n_pods=2)
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
    params, _, losses, _, _ = _train(bundle, art,
                                     lambda s: host_batch(ds.batch(s), "cpu", n_pods=2),
                                     HIER_STEPS, _hier_cfg())
    return _np(params), losses


def test_split_hierarchical_trainer_on_a_pod_data_model_world(tmp_path):
    ranks = run_world(tmp_path, (2, 1, 2), ("pod", "data", "model"), "test_torch_tp:hier_rank")
    for arch in HIER_CASES:
        params, losses = _one_device_hier(arch)
        for r, got in enumerate(ranks):
            pod = got["coords"]["pod"]
            g = got[arch]
            for i in range(HIER_STEPS):
                assert _rel(g["losses"][i], losses[i][pod:pod + 1]) < 1e-4, (arch, r, i)
            want = {n: w[pod:pod + 1] for n, w in params.items()}
            assert_within_bars(g["params"], want, HIER_STEPS, (arch, r),
                               grid=2 * LR * HIER_STEPS / 127)
        for a, b in _model_peers(ranks):
            ga, gb = ranks[a][arch]["replicated"], ranks[b][arch]["replicated"]
            assert ga and all(ga[n].tobytes() == gb[n].tobytes() for n in ga), (arch, a, b)


def moe_rank(mesh, payload):
    """The routed experts of one "ep" layer under a split of ``model``."""
    from repro_torch.models import layers

    cfg = moe_lib.MoEConfig(n_experts=4, top_k=2, d_ff=32, expert_sharding="ep")
    p = moe_lib.moe_init(16, cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 12, 16)).astype(np.float32))
    r, n = mesh.block("model")
    e = cfg.n_experts // n
    for name in ("gate_w", "up_w", "down_w"):
        getattr(p, name).data = getattr(p, name).data[r * e:(r + 1) * e].clone()
    out, aux = moe_lib.moe_apply(p, x, cfg, layers.TPSplit(mesh, "model", "heads"))
    return out.numpy(), aux.numpy()


def test_ep_experts_without_a_shared_one_are_bitwise_one_device(tmp_path):
    cfg = moe_lib.MoEConfig(n_experts=4, top_k=2, d_ff=32, expert_sharding="ep")
    p = moe_lib.moe_init(16, cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 12, 16)).astype(np.float32))
    want, want_aux = moe_lib.moe_apply(p, x, cfg)
    for out, aux in run_world(tmp_path, (1, 2), ("data", "model"), "test_torch_tp:moe_rank"):
        assert out.tobytes() == want.numpy().tobytes()
        assert aux.tobytes() == want_aux.numpy().tobytes()


@pytest.mark.parametrize("arch,extent,overrides,what", [
    ("qwen2-0.5b", 4, {"attn_sharding": "heads"}, "KV heads: 2 do not divide"),
    ("qwen2-0.5b", 3, {}, "query columns: 64 do not divide"),
    ("llama4-maverick-400b-a17b", 8, {}, "experts: 4 do not divide"),
    ("qwen2-0.5b", 32, {"attn_sharding": "seq"}, "sequence positions: 16 do not divide"),
    ("mamba2-2.7b", 3, {}, "SSM heads: 8 do not divide"),
    ("zamba2-1.2b", 8, {"attn_sharding": "heads"}, "KV heads: 4 do not divide"),
    ("whisper-medium", 8, {}, "heads: 4 do not divide"),
])
def test_an_extent_that_does_not_divide_is_refused(arch, extent, overrides, what):
    """No world: the split is chosen when the artifacts are made, and the
    sequence at the step; both on a ``MeshLayout`` (meta tensors)."""
    bundle = get_arch(arch, reduced=True, **overrides)
    layout = MeshLayout((1, extent), ("data", "model"))
    with pytest.raises(ValueError, match=what):
        tp_split(bundle, layout)
        dryrun.price_lm(bundle, ShapeSpec("t", "train", SEQ, 1), layout, count_flops=False)
