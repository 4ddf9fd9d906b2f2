"""The trainer on a mesh of gloo CPU processes against the port's one-device
trainer, and the sync trainer against JAX on forced host devices.

Reduced qwen2-0.5b and reduced grok-1 (MoE), weights drawn by the port
from seed 0, batches from ``SyntheticLM`` (global batch 4, S 16), AdamW
lr 1e-3. Both worlds have a model extent of 1, where the split of the
compute over ``model`` is the identity, so the bar is bitwise; with a model
extent above 1 a row-split product sums partial products over the ranks
and the split trainers are held to ``tests/test_torch_train.py``'s bars
instead (``tests/test_torch_tp.py``):

* a ``(pod, data, model)`` = (2, 2, 1) world runs the hierarchical trainer
  (FSDP over ``data``), int8 on both models and uncompressed on qwen2: 4
  local steps, a sync, 1 more step. Every rank's gathered parameters,
  moments, counts, anchor and residuals, and its losses, are bitwise the
  one-device trainer's at ``n_micro`` 2 (one microbatch a rank, summed in
  the same order); the bytes over ``pod`` equal the accounting;
* a ``(data, model)`` = (2, 1) world runs the sync trainer for 2 steps,
  bitwise the one-device trainer at ``n_micro`` 2; qwen2's parameters are
  also held against JAX's ``make_train_artifacts(mesh=...)`` on a (2, 2)
  mesh of 4 forced host devices within ``tests/test_torch_train.py``'s
  bars (losses 1e-4 relative; per element ``2 * lr * steps``, 99% within
  1e-5 of the largest parameter). The JAX mesh is made with ``Auto`` axes,
  the default of the JAX versions the package was written for.

Each world also checks ``host_batch`` (the ranks' slices, concatenated,
are the global batch in order), ``shard_state`` -> ``gather_state``
(bitwise, numpy and torch) and the error for an extent that does not
divide.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import comm
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.models.jax_layout import P
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import gather_state, make_train_artifacts, shard_state
from test_torch_comm import ROOT, run_world

ARCHS = ("qwen2-0.5b", "grok-1-314b")
# (arch, slow-tier compression) of the hierarchical world
HIER_CASES = (("qwen2-0.5b", "int8"), ("grok-1-314b", "int8"), ("qwen2-0.5b", "none"))
LR = 1e-3
SEQ, BATCH = 16, 4
HIER_STEPS, SYNC_AT, SYNC_STEPS = 5, 4, 2


def _opt():
    return AdamWConfig(lr=LR, warmup_steps=2)


def _init(bundle):
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    return params, adamw_init(params, _opt())


def _np(tree) -> dict:
    """Named numpy leaves (the port's layout)."""
    return {n: x.detach().numpy().copy() for n, x in named_leaves(tree).items()}


def _hier_cfg(compression="int8"):
    return HierarchicalConfig(sync_every=SYNC_AT, compression=compression)


def _run_hier(bundle, art, batch_of):
    params, opt = _init(bundle)
    sync = art.hier.init_sync_state(params)
    params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    params, opt, sync = art.shard(params, "params"), art.shard(opt, "opt"), art.shard(sync, "sync")
    losses = []
    for step in range(HIER_STEPS):
        if step == SYNC_AT:
            params, sync = art.sync_fn(params, sync)
        params, opt, m = art.step_fn(params, opt, batch_of(step))
        losses.append(m["loss"].numpy().copy())
    return params, opt, sync, losses


def _run_sync(bundle, art, batch_of):
    params, opt = _init(bundle)
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    losses = []
    for step in range(SYNC_STEPS):
        params, opt, m = art.step_fn(params, opt, batch_of(step))
        losses.append(m["loss"].numpy().copy())
    return params, opt, losses


def _data(bundle):
    return SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)


def hier_rank(mesh, payload):
    """One rank of the (2, 2, 1) world."""
    out = {"coords": mesh.coords}
    for arch, compression in HIER_CASES:
        bundle = get_arch(arch, reduced=True)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",),
                                   hier_cfg=_hier_cfg(compression))
        ds = _data(bundle)
        comm.reset_stats()
        params, opt, sync, losses = _run_hier(
            bundle, art, lambda s: host_batch(ds.batch(s), mesh, ("data",), "pod"))
        received = dict(comm.received)
        shard_elems = sum(x.numel() for x in named_leaves(params).values())
        out[arch, compression] = {
            "losses": losses, "received": received, "wire": art.hier.wire_bytes,
            "shard_elems": shard_elems, "n_leaves": len(named_leaves(params)),
            "params": _np(art.gather(params, "params")), "opt": _np(art.gather(opt, "opt")),
            "sync": _np(art.gather(sync, "sync")),
        }
    out["batch"] = host_batch(_data(get_arch("qwen2-0.5b", reduced=True)).batch(0), mesh,
                              ("data",), "pod")["tokens"].numpy()
    return out


def _trees(bundle):
    """A JAX-layout tree of numpy and one of torch leaves, and its specs."""
    rng = np.random.default_rng(3)
    tree = {"embed": rng.normal(size=(8, 6)).astype(np.float32),
            "layers": {"w": rng.normal(size=(3, 4, 6)).astype(np.float32)},
            "count": np.arange(2, dtype=np.int32)}
    specs = {"embed": P("model", "data"), "layers": {"w": P(None, "data", "model")},
             "count": P(None)}
    return tree, specs


def sync_rank(mesh, payload):
    """One rank of the (2, 1) world."""
    out = {"coords": mesh.coords}
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",))
        ds = _data(bundle)
        params, opt, losses = _run_sync(bundle, art,
                                        lambda s: host_batch(ds.batch(s), mesh, ("data",)))
        out[arch] = {"losses": losses, "params": _np(art.gather(params, "params")),
                     "opt": _np(art.gather(opt, "opt"))}
    tree, specs = _trees(bundle)
    shards = shard_state(tree, specs, mesh)
    back = gather_state(shards, specs, mesh)
    tback = gather_state(shard_state({k: (torch.from_numpy(v) if k != "layers" else
                                          {"w": torch.from_numpy(v["w"])})
                                      for k, v in tree.items()}, specs, mesh), specs, mesh)
    out["roundtrip"] = (back, {"embed": tback["embed"].numpy(),
                               "layers": {"w": tback["layers"]["w"].numpy()},
                               "count": tback["count"].numpy()})
    out["shard_shape"] = shards["layers"]["w"].shape
    try:
        shard_state({"x": np.zeros((3, 2))}, {"x": P("data")}, mesh)
    except ValueError as e:
        out["error"] = str(e)
    out["batch"] = host_batch(_data(get_arch("qwen2-0.5b", reduced=True)).batch(0), mesh,
                              ("data",))["tokens"].numpy()
    return out


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Same dtype, shape and bytes (-0.0 is not +0.0)."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _ref_hier(arch, compression):
    bundle = get_arch(arch, reduced=True)
    art = make_train_artifacts(bundle, _opt(), hier_cfg=_hier_cfg(compression), n_pods=2,
                               n_micro=2)
    ds = _data(bundle)
    params, opt, sync, losses = _run_hier(
        bundle, art, lambda s: host_batch(ds.batch(s), "cpu", n_pods=2))
    return _np(params), _np(opt), _np(sync), losses


def _ref_sync(arch):
    bundle = get_arch(arch, reduced=True)
    art = make_train_artifacts(bundle, _opt(), n_micro=2)
    ds = _data(bundle)
    params, opt, losses = _run_sync(bundle, art, lambda s: host_batch(ds.batch(s), "cpu"))
    return _np(params), _np(opt), losses


def test_hierarchical_trainer_on_a_pod_data_model_world_is_bitwise_one_device(tmp_path):
    ranks = run_world(tmp_path, (2, 2, 1), ("pod", "data", "model"),
                      "test_torch_train_mesh:hier_rank")
    for arch, compression in HIER_CASES:
        params, opt, sync, losses = _ref_hier(arch, compression)
        for r, got in enumerate(ranks):
            pod = got["coords"]["pod"]
            g = got[arch, compression]
            for want, have in ((params, g["params"]), (opt, g["opt"]), (sync, g["sync"])):
                assert want.keys() == have.keys()
                bad = [n for n in want if not _same(have[n], want[n])]
                assert not bad, (arch, compression, r, bad[:5])
            assert all(_same(h, w[pod:pod + 1]) for h, w in zip(g["losses"], losses)), (arch, r)
            # the slow tier, once, from the other pod: this rank's int8 shards
            # and one f32 scale a leaf, or its f32 shards uncompressed;
            # nothing over pod in a local step
            over_pod = g["received"][("all_gather", ("pod",))]
            if compression == "int8":
                wire = g["shard_elems"] + 4 * g["n_leaves"]
                assert g["wire"] == wire and over_pod == wire
            else:
                assert over_pod == 4 * g["shard_elems"]
            assert not any("pod" in axes for (op, axes) in g["received"]
                           if op != "all_gather" or axes != ("pod",))
            assert g["received"][("sum_in_order", ("data",))] > 0
        assert losses[SYNC_AT - 1][0] != losses[SYNC_AT - 1][1]  # the pods had diverged
    full = _data(get_arch("qwen2-0.5b", reduced=True)).batch(0)["tokens"]
    parts = [g["batch"] for g in ranks if g["coords"]["model"] == 0]
    assert all(p.shape == (1, 1, SEQ) for p in parts)
    assert np.array_equal(np.concatenate(parts).reshape(full.shape), full)


def _jax_sync(tmp_path, jax_tree) -> subprocess.Popen:
    """JAX's sync trainer on a (2, 2) mesh of forced host devices, started
    in a subprocess (FSDP over data, TP over model), from ``jax_tree``."""
    np.savez(tmp_path / "init.npz", **{"/".join(k): v for k, v in _flat(jax_tree).items()})
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.registry import get_arch
        from repro.data.pipeline import SyntheticLM, host_batch
        from repro.optim.adamw import AdamWConfig, adamw_init
        from repro.train.steps import make_train_artifacts

        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        b = get_arch("qwen2-0.5b", reduced=True)
        cfg = AdamWConfig(lr={LR}, warmup_steps=2)
        art = make_train_artifacts(b, cfg, mesh=mesh, batch_axes=("data",), donate=False)
        flat = dict(np.load({str(tmp_path / 'init.npz')!r}))
        params = {{}}
        for key, v in flat.items():
            node = params
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {{}})
            node[last] = jnp.asarray(v)
        opt = adamw_init(params, cfg)
        put = lambda t, s: jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                                        t, s, is_leaf=lambda x: isinstance(x, P))
        params, opt = put(params, art.params_specs), put(opt, art.opt_specs)
        ds = SyntheticLM(b.cfg.vocab, {SEQ}, {BATCH}, seed=1)
        losses = []
        for s in range({SYNC_STEPS}):
            params, opt, m = art.step_fn(params, opt, host_batch(ds.batch(s), mesh, ("data",)))
            losses.append(float(m["loss"]))
        out = {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
               for path, x in jax.tree_util.tree_leaves_with_path(params)}}
        np.savez({str(tmp_path / 'jax.npz')!r}, losses=np.asarray(losses), **out)
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def test_sync_trainer_on_a_data_model_world_is_bitwise_one_device_and_near_jax(tmp_path):
    bundle = get_arch("qwen2-0.5b", reduced=True)
    init, _ = _init(bundle)
    jax_run = _jax_sync(tmp_path, bundle.model.params_to_numpy(init))
    try:
        ranks = run_world(tmp_path / "world", (2, 1), ("data", "model"),
                          "test_torch_train_mesh:sync_rank")
        out, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, out[-3000:]
    for arch in ARCHS:
        params, opt, losses = _ref_sync(arch)
        for r, got in enumerate(ranks):
            g = got[arch]
            for want, have in ((params, g["params"]), (opt, g["opt"])):
                assert want.keys() == have.keys()
                bad = [n for n in want if not _same(have[n], want[n])]
                assert not bad, (arch, r, bad[:5])
            assert all(_same(h, w) for h, w in zip(g["losses"], losses)), (arch, r)
    # against JAX on a mesh: test_torch_train.py's bars
    jax_out = dict(np.load(tmp_path / "jax.npz"))
    jl = jax_out.pop("losses")
    ql = np.asarray([float(x) for x in ranks[0]["qwen2-0.5b"]["losses"]])
    assert np.abs(ql - jl).max() <= 1e-4 * np.abs(jl).max()
    got = {"/".join(k): v for k, v in _flat(bundle.model.params_to_numpy(
        _as_module(bundle, ranks[0]["qwen2-0.5b"]["params"]))).items()}
    assert got.keys() == jax_out.keys()
    top = max(np.abs(w).max() for w in jax_out.values())
    close = total = 0
    for key, w in jax_out.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * LR * SYNC_STEPS, key
        close += int((d <= 1e-5 * top).sum())
        total += d.size
    assert close >= 0.99 * total
    # host_batch, the round trip and the error
    full = _data(bundle).batch(0)["tokens"]
    parts = [g["batch"] for g in ranks if g["coords"]["model"] == 0]
    assert np.array_equal(np.concatenate(parts), full)
    tree, _ = _trees(bundle)
    for g in ranks:
        assert g["shard_shape"] == (3, 2, 6)
        for back in g["roundtrip"]:
            assert all(_same(back_leaf, want) for back_leaf, want in zip(
                _flat(back).values(), _flat(tree).values()))
        assert "x: dimension 0 of shape (3, 2) does not divide over data (extent 2)" in g["error"]


def _as_module(bundle, named: dict):
    params = bundle.model.init_params(None, device="meta")
    params.load_state_dict({n: torch.from_numpy(v) for n, v in named.items()}, assign=True)
    return params


def _positions(shape, names):
    """A mesh's positions and extents without a world (rank 0's)."""
    from repro_torch.core.mesh import ProcessMesh

    mesh = ProcessMesh.__new__(ProcessMesh)
    mesh.axis_names, mesh.shape = tuple(names), dict(zip(names, shape))
    mesh.coords = {a: 0 for a in names}
    return mesh


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_batch_specs_name_the_batch_axes(axes):
    """No world: the batch specs the ranks slice by, the identity without
    a mesh, and the refusal of a hierarchical batch split over the pod
    axis (a local step sums within its pod)."""
    bundle = get_arch("qwen2-0.5b", reduced=True)
    art = make_train_artifacts(bundle, batch_axes=axes)
    assert art.batch_specs["tokens"] == P(axes, None)
    assert art.shard({"x": torch.zeros(1)}, "params")["x"].shape == (1,)
    mesh = _positions((2, 2, 1), ("pod", "data", "model"))
    if "pod" in axes:
        with pytest.raises(ValueError, match="name the pod axis"):
            make_train_artifacts(bundle, mesh=mesh, batch_axes=axes,
                                 hier_cfg=HierarchicalConfig())
    else:
        art = make_train_artifacts(bundle, mesh=mesh, batch_axes=axes,
                                   hier_cfg=HierarchicalConfig())
        assert art.hier.n_pods == 2 and art.named_specs["opt"]["count"] == ("pod",)
