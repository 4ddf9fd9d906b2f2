"""The compute split over ``model`` of mamba2, zamba2 and whisper on one
gloo CPU world of four ranks, in training and serving, against the port's
one-device path, JAX's trainer and serving on a mesh of forced host
devices, and the dry run's price.

Reduced configs in f32, weights drawn by the port from seed 0 (JAX gets
the same weights through ``params_to_numpy``), batches from
``SyntheticLM`` (seed 1; global batch 4, S 16) and the stub frontends'
inputs from numpy (seed 100 + step), AdamW lr 1e-3. The world holds three
process meshes:

* ``(data, model)`` = (2, 2): the sync trainer, 2 steps of microbatches of
  one sequence a rank (two), on all three families; and a
  prefill (20 tokens, B 4) and 2 decode steps of ``make_serve_artifacts``
  with an f32 cache of 32 positions (the KV heads and the SSM heads over
  ``model``);
* (1, 4): mamba2's sync trainer (four microbatches), where its 296
  ``in_proj`` columns (74 a rank) and 160 conv channels (40 a rank)
  straddle its 16-wide heads, and its serving (its 8 SSM heads over 4);
* ``(pod, data, model)`` = (2, 1, 2): zamba2's hierarchical int8 trainer,
  4 local steps, a sync, 1 more.

Bars: each rank's losses and grad norms within 1e-4 relative, its first
step's gradients (AdamW's first ``m`` over ``1 - b1``, gathered) each
within 1e-4 of the leaf's largest (``tests/test_torch_train_families.py``'s
bar, a 1e-8 floor), its gathered parameters and moments within
``tests/test_torch_train.py``'s bars
(``tests/test_torch_tp.py``'s ``assert_within_bars``) of the one-device
trainer at ``n_micro`` 2 (hierarchical: at 2 pods, with one int8 grid step
more after the sync) and of JAX's sync trainer on a (2, 2) ``Auto`` mesh
at ``n_micro`` 2; serving's prefill logits within 1e-4 and its decode
logits within 5e-4 of the largest logit of the one-device serving of the
rank's batch slice and of JAX's ``make_serve_artifacts(mesh=...)`` on the
same (2, 2) mesh (the f32 cache keeps a bf16 rounding of the cache, which
a reordered sum can flip, out of the comparison:
``tests/test_torch_serve_mesh.py`` serves these families over a bf16
cache). In every step and call: no ``all_gather`` over ``model`` (no
parameter gathered over it), and what comm counts equals
``dryrun.price_lm``'s price on a ``MeshLayout`` of the same rank (the
training steps at their ``n_micro``). Every held parameter and cache leaf has
its shard's shape; the leaves replicated over ``model`` and mamba's conv
state are bitwise alike on the ranks that differ only along ``model``.
"""

import dataclasses
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
from repro_torch.core.mesh import MeshLayout, ProcessMesh
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_serve_artifacts, make_train_artifacts
from test_torch_comm import ROOT, run_world
from test_torch_serve_mesh import _flat, named_leaves_specs
from test_torch_tp import (BATCH, HIER_STEPS, LR, SEQ, STEPS, SYNC_AT, _as_module, _hier_cfg, _np,
                           _opt, _rel, assert_moments_close, assert_within_bars)

ARCHS = {"mamba2": "mamba2-2.7b", "zamba2": "zamba2-1.2b", "whisper": "whisper-medium"}
SERVE = ShapeSpec("serve", "decode", 32, BATCH)
PROMPT, SERVE_STEPS = 20, 2
PREFILL_BAR, DECODE_BAR = 1e-4, 5e-4
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((1, 4), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model"))}


def _bundle(name):
    return get_arch(ARCHS[name], reduced=True)


def _batch(bundle, step: int) -> dict:
    """A global batch (numpy): ``SyntheticLM``'s tokens and labels (seed 1)
    and the stub frontends' inputs (seed 100 + step)."""
    out = dict(SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1).batch(step))
    rng = np.random.default_rng(100 + step)
    for name, make in bundle.extra_inputs.items():
        out[name] = rng.normal(size=tuple(make(BATCH, SEQ).shape)).astype(np.float32)
    return out


def _serve_inputs(bundle) -> tuple:
    """Tokens for the prompt and the decode steps, and the stub frontends'
    inputs, of the whole batch (numpy, seed 7)."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, bundle.cfg.vocab, (BATCH, PROMPT + SERVE_STEPS)).astype(np.int64)
    extra = {name: rng.normal(size=tuple(make(BATCH, PROMPT).shape)).astype(np.float32)
             for name, make in bundle.extra_inputs.items()}
    return toks, extra


# ---------------------------------------------------------------------------
# the ranks


def _train(bundle, art, batch_of, steps, hier_cfg=None):
    """``steps`` steps from the seed-0 weights: the state, the losses, the
    grad norms, what comm counted in each step and (sync) the first step's
    clipped gradient, whole (AdamW's first ``m`` over ``1 - b1``)."""
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    opt = adamw_init(params, _opt())
    sync = None
    if hier_cfg is not None:
        sync = art.shard(art.hier.init_sync_state(params), "sync")
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    losses, norms, tables, grads = [], [], [], None
    for step in range(steps):
        if hier_cfg is not None and step == SYNC_AT:
            params, sync = art.sync_fn(params, sync)
        comm.reset_stats()
        params, opt, m = art.step_fn(params, opt, batch_of(step))
        tables.append(dryrun._table())
        losses.append(m["loss"].detach().numpy().copy())
        norms.append(m["grad_norm"].detach().numpy().copy())
        if step == 0 and hier_cfg is None:
            grads = {n[2:]: x / (1 - _opt().b1) for n, x in _np(art.gather(opt, "opt")).items()
                     if n.startswith("m.")}
    return params, opt, losses, norms, tables, grads


def _replicated(art, params) -> dict:
    """This rank's shards of the leaves no spec splits over ``model``."""
    return {n: x.tobytes() for n, x in _np(params).items()
            if all(e is None for e in art.model_specs[n])}


def _train_rank(mesh, name, hier: bool = False) -> dict:
    """A family's sync (or hierarchical) trainer on this rank's shards, and
    the dry run's price of its step."""
    bundle = _bundle(name)
    hier_cfg = _hier_cfg() if hier else None
    n_micro = 1 if hier else BATCH // mesh.extent("data")  # one sequence a microbatch
    art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",), hier_cfg=hier_cfg,
                               n_micro=n_micro)
    pod = "pod" if hier else None
    params, opt, losses, norms, tables, grads = _train(
        bundle, art, lambda s: host_batch(_batch(bundle, s), mesh, ("data",), pod),
        HIER_STEPS if hier else STEPS, hier_cfg)
    out = {"losses": losses, "norms": norms, "tables": tables, "grads": grads,
           "replicated": _replicated(art, params)}
    if hier:
        out["params"] = _np(art.gather(params, "params", ("data", "model")))
        return out
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    out["priced"] = dryrun.price_lm(bundle, ShapeSpec("t", "train", SEQ, 1), layout,
                                    n_micro=n_micro, count_flops=False)["collectives"]
    out["params"] = _np(art.gather(params, "params"))
    out["opt"] = _np(art.gather(opt, "opt"))
    return out


def _serve(bundle, shape, toks, extra, mesh=None):
    """A prefill and ``SERVE_STEPS`` decode steps over an f32 cache on
    ``mesh`` (this rank's shards and inputs as given) or one device: each
    call's logits and what comm counted, the artifacts, the parameters and
    the state held."""
    art = make_serve_artifacts(bundle, shape, mesh, cache_dtype=torch.float32)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.from_numpy(toks[:, :PROMPT]),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    logits, tables = [], []
    comm.reset_stats()
    out, state = art.prefill_fn(params, batch)
    logits.append(out.numpy())
    tables.append(dryrun._table())
    for i in range(PROMPT, PROMPT + SERVE_STEPS):
        comm.reset_stats()
        out, state = art.decode_fn(params, state, torch.from_numpy(toks[:, i:i + 1]), i)
        logits.append(out.numpy())
        tables.append(dryrun._table())
    return logits, tables, art, params, state


def _serve_rank(mesh, name) -> dict:
    """A family's serving on this rank against the one-device serving of
    its batch slice and the dry run's price."""
    bundle = _bundle(name)
    toks, extra = _serve_inputs(bundle)
    cut = host_batch({"toks": toks, **extra}, mesh, ("data",))
    toks, extra = cut.pop("toks").numpy(), {k: v.numpy() for k, v in cut.items()}
    logits, tables, art, params, state = _serve(bundle, SERVE, toks, extra, mesh)
    local = dataclasses.replace(SERVE, global_batch=toks.shape[0])
    ref = _serve(bundle, local, toks, extra)[0]
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    prefill = ShapeSpec("serve", "prefill", SERVE.seq_len, SERVE.global_batch)
    priced = [dryrun.price_lm(bundle, prefill, layout, prompt_len=PROMPT,
                              count_flops=False)["collectives"]]
    priced += [dryrun.price_lm(bundle, SERVE, layout, cache_index=i,
                               count_flops=False)["collectives"]
               for i in range(PROMPT, PROMPT + SERVE_STEPS)]
    shapes_ok = all(tuple(x.shape) == tuple(mesh.shard(w, art.named_specs[n]).shape)
                    for (n, x), w in zip(named_leaves(params).items(),
                                         named_leaves(art.params_sds).values()))
    shapes_ok &= all(tuple(x.shape) == tuple(mesh.shard(w, sp).shape) for x, w, sp in zip(
        named_leaves(state["cache"]).values(), named_leaves(art.state_sds["cache"]).values(),
        named_leaves_specs(art.state_specs["cache"])))
    errs = [float(np.abs(got - want).max() / np.abs(want).max())
            for got, want in zip(logits, ref)]
    conv = state["cache"].get("conv")
    return {"logits": logits, "errs": errs, "tables": tables, "priced": priced,
            "shapes_ok": shapes_ok, "kv": art.split.kv,
            "conv": None if conv is None else conv.numpy().tobytes()}


def world_rank(mesh, payload):
    """Every leg on this rank; the (1, 4) and (2, 1, 2) meshes are made
    over the same world."""
    torch.manual_seed(0)
    out = {"coords": {"dm": mesh.coords}}
    for name in ARCHS:
        out[("train", "dm", name)] = _train_rank(mesh, name)
        out[("serve", "dm", name)] = _serve_rank(mesh, name)
    m4 = ProcessMesh(*MESHES["m4"], device="cpu")
    out["coords"]["m4"] = m4.coords
    out[("train", "m4", "mamba2")] = _train_rank(m4, "mamba2")
    out[("serve", "m4", "mamba2")] = _serve_rank(m4, "mamba2")
    pod = ProcessMesh(*MESHES["pod"], device="cpu")
    out["coords"]["pod"] = pod.coords
    out[("train", "pod", "zamba2")] = _train_rank(pod, "zamba2", hier=True)
    return out


# ---------------------------------------------------------------------------
# the references


def _one_device_train(name, hier: bool = False):
    bundle = _bundle(name)
    if hier:
        art = make_train_artifacts(bundle, _opt(), hier_cfg=_hier_cfg(), n_pods=2)
        batch_of = lambda s: host_batch(_batch(bundle, s), "cpu", n_pods=2)  # noqa: E731
    else:
        art = make_train_artifacts(bundle, _opt(), n_micro=2)
        batch_of = lambda s: host_batch(_batch(bundle, s), "cpu")  # noqa: E731
    params, opt, losses, norms, _, grads = _train(bundle, art, batch_of,
                                                  HIER_STEPS if hier else STEPS,
                                                  _hier_cfg() if hier else None)
    return {"params": _np(params), "opt": _np(opt), "losses": losses, "norms": norms,
            "grads": grads}


_JAX = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.common import ShapeSpec
    from repro.configs.registry import get_arch
    from repro.data.pipeline import host_batch
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.steps import make_serve_artifacts, make_train_artifacts

    tmp, lr, steps, cache, batch, prompt, n_steps = sys.argv[1:8]
    archs = sys.argv[8:]
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)

    def load(path):
        params = {}
        for key, v in np.load(path).items():
            node = params
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(v)
        return params

    def put(t, s):
        return jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s,
                            is_leaf=lambda x: isinstance(x, P))

    for name in archs:
        arch = name.split(":")[1]
        name = name.split(":")[0]
        b = get_arch(arch, reduced=True)
        # the sync trainer, n_micro 2, from the port's weights and batches
        cfg = AdamWConfig(lr=float(lr), warmup_steps=2)
        art = make_train_artifacts(b, cfg, mesh=mesh, batch_axes=("data",), n_micro=2,
                                   donate=False)
        params = put(load(f"{tmp}/init-{name}.npz"), art.params_specs)
        opt = put(adamw_init(params, cfg), art.opt_specs)
        losses = []
        for s in range(int(steps)):
            data = dict(np.load(f"{tmp}/batch-{name}-{s}.npz"))
            params, opt, m = art.step_fn(params, opt, host_batch(data, mesh, ("data",)))
            losses.append(float(m["loss"]))
        out = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
               for path, x in jax.tree_util.tree_leaves_with_path(params)}
        np.savez(f"{tmp}/jax-train-{name}.npz", losses=np.asarray(losses), **out)
        # serving over an f32 cache: every call's logits of the whole batch
        art = make_serve_artifacts(b, ShapeSpec("serve", "decode", int(cache), int(batch)), mesh,
                                   cache_dtype=jnp.float32)
        params = put(load(f"{tmp}/init-{name}.npz"), art.params_specs)
        data = dict(np.load(f"{tmp}/serve-{name}.npz"))
        toks = data.pop("toks").astype(np.int32)
        p = int(prompt)
        logits, state = art.prefill_fn(params, {"tokens": jnp.asarray(toks[:, :p]),
                                                **{k: jnp.asarray(v) for k, v in data.items()}})
        got = [np.asarray(logits)]
        for i in range(p, p + int(n_steps)):
            logits, state = art.decode_fn(params, state, jnp.asarray(toks[:, i:i + 1]),
                                          jnp.int32(i))
            got.append(np.asarray(logits))
        np.save(f"{tmp}/jax-serve-{name}.npy", np.stack(got))
        print("done", name, flush=True)
""")


def _jax(tmp_path, names) -> subprocess.Popen:
    """JAX's sync trainer and serving of ``names`` on a (2, 2) ``Auto`` mesh
    of forced host devices, in a subprocess, from the port's weights,
    batches and prompts."""
    for name in names:
        bundle = _bundle(name)
        tree = bundle.model.params_to_numpy(
            bundle.model.init_params(torch.Generator().manual_seed(0)))
        np.savez(tmp_path / f"init-{name}.npz",
                 **{"/".join(k): v for k, v in _flat(tree).items()})
        for s in range(STEPS):
            np.savez(tmp_path / f"batch-{name}-{s}.npz", **_batch(bundle, s))
        toks, extra = _serve_inputs(bundle)
        np.savez(tmp_path / f"serve-{name}.npz", toks=toks, **extra)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    args = [str(tmp_path), str(LR), str(STEPS), str(SERVE.seq_len), str(BATCH), str(PROMPT),
            str(SERVE_STEPS), *(f"{n}:{ARCHS[n]}" for n in names)]
    return subprocess.Popen([sys.executable, "-c", _JAX, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's ranks, JAX's results and the one-device trainers,
    computed once for the tests of this module."""
    tmp = tmp_path_factory.mktemp("tp_ssm_audio")
    jax_run = _jax(tmp, list(ARCHS))
    try:
        ranks = run_world(tmp / "world", *MESHES["dm"], "test_torch_tp_ssm_audio:world_rank")
        refs = {name: _one_device_train(name) for name in ARCHS}
        refs["hier"] = _one_device_train("zamba2", hier=True)
        jout, _ = jax_run.communicate(timeout=900)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, jout[-3000:]
    jax = {}
    for name in ARCHS:
        train = dict(np.load(tmp / f"jax-train-{name}.npz"))
        jax[name] = {"losses": train.pop("losses"), "params": train,
                     "serve": np.load(tmp / f"jax-serve-{name}.npy")}
    return {"ranks": ranks, "refs": refs, "jax": jax}


def assert_grads_close(got: dict, want: dict, what) -> None:
    """Every gradient leaf within 1e-4 of that leaf's largest magnitude, with
    an absolute floor of 1e-8 (``tests/test_torch_train_families.py``'s
    bar: whisper's key biases have an exact gradient of zero)."""
    assert got.keys() == want.keys(), what
    for n, g in want.items():
        bar = max(1e-4 * np.abs(g).max(), 1e-8)
        assert np.abs(got[n] - g).max() <= bar, (what, n, np.abs(got[n] - g).max(), bar)


def _peers(ranks, mesh: str):
    """Pairs of ranks that differ only along ``model`` of ``mesh``."""
    def off(r):
        return {k: v for k, v in ranks[r]["coords"][mesh].items() if k != "model"}
    return [(a, b) for a in range(len(ranks)) for b in range(a + 1, len(ranks))
            if off(a) == off(b)]


# ---------------------------------------------------------------------------
# the tests


@pytest.mark.parametrize("name", list(ARCHS))
def test_split_training_within_the_one_device_trainers_bars(world, name):
    want = world["refs"][name]
    for r, got in enumerate(world["ranks"]):
        g = got[("train", "dm", name)]
        for i in range(STEPS):
            assert _rel(g["losses"][i], want["losses"][i]) < 1e-4, (name, r, i)
            assert _rel(g["norms"][i], want["norms"][i]) < 1e-4, (name, r, i)
        assert_grads_close(g["grads"], want["grads"], (name, r))
        assert_within_bars(g["params"], want["params"], STEPS, (name, r))
        assert_moments_close(g["opt"], want["opt"], (name, r))


@pytest.mark.parametrize("name", list(ARCHS))
def test_split_training_within_the_bars_of_jax_on_a_mesh(world, name):
    bundle = _bundle(name)
    want = world["jax"][name]
    for r, got in enumerate(world["ranks"]):
        g = got[("train", "dm", name)]
        assert _rel([float(x) for x in g["losses"]], want["losses"]) < 1e-4, (name, r)
        as_jax = {"/".join(k): v for k, v in _flat(bundle.model.params_to_numpy(
            _as_module(bundle, g["params"]))).items()}
        assert_within_bars(as_jax, want["params"], STEPS, (name, r, "jax"))


def test_mamba2_heads_straddled_by_its_stored_blocks_on_a_one_by_four_mesh(world):
    """(1, 4): 74 ``in_proj`` columns and 40 conv channels a rank against
    heads of 16 columns; the trainer within the bars, the serving too."""
    want = world["refs"]["mamba2"]
    for r, got in enumerate(world["ranks"]):
        g = got[("train", "m4", "mamba2")]
        for i in range(STEPS):
            assert _rel(g["losses"][i], want["losses"][i]) < 1e-4, (r, i)
            assert _rel(g["norms"][i], want["norms"][i]) < 1e-4, (r, i)
        assert_grads_close(g["grads"], want["grads"], r)
        assert_within_bars(g["params"], want["params"], STEPS, r)
        assert_moments_close(g["opt"], want["opt"], r)
        s = got[("serve", "m4", "mamba2")]
        assert s["shapes_ok"], r
        for call, err in enumerate(s["errs"]):
            assert err <= (PREFILL_BAR if call == 0 else DECODE_BAR), (r, call, err)


def test_split_hierarchical_trainer_of_zamba2_on_a_pod_data_model_mesh(world):
    want = world["refs"]["hier"]
    for r, got in enumerate(world["ranks"]):
        pod = got["coords"]["pod"]["pod"]
        g = got[("train", "pod", "zamba2")]
        for i in range(HIER_STEPS):
            assert _rel(g["losses"][i], want["losses"][i][pod:pod + 1]) < 1e-4, (r, i)
        assert_within_bars(g["params"], {n: w[pod:pod + 1] for n, w in want["params"].items()},
                           HIER_STEPS, r, grid=2 * LR * HIER_STEPS / 127)


@pytest.mark.parametrize("name", list(ARCHS))
def test_split_serving_within_the_bars_of_one_device_and_jax(world, name):
    for r, got in enumerate(world["ranks"]):
        s = got[("serve", "dm", name)]
        assert s["shapes_ok"], (name, r)
        assert s["kv"] == (None if name == "mamba2" else "heads"), (name, r)
        d = got["coords"]["dm"]["data"]
        want = world["jax"][name]["serve"][:, 2 * d:2 * d + 2]
        for call, (logits, err) in enumerate(zip(s["logits"], s["errs"])):
            bar = PREFILL_BAR if call == 0 else DECODE_BAR
            assert err <= bar, (name, r, call, err)
            jerr = np.abs(logits - want[call]).max() / np.abs(want[call]).max()
            assert jerr <= bar, (name, r, call, jerr)


def test_no_weight_gathered_over_model_and_counted_equals_priced(world):
    for r, got in enumerate(world["ranks"]):
        for key, leg in got.items():
            if key == "coords":
                continue
            # the hierarchical step's price is held in tests/test_torch_dryrun_lm.py
            priced = (None if key[1] == "pod" else leg["priced"] if key[0] == "serve"
                      else [leg["priced"]] * len(leg["tables"]))
            for i, table in enumerate(leg["tables"]):
                assert priced is None or table == priced[i], (r, key, i, table, priced[i])
                assert not [k for k in table if k.split()[0] == "all_gather"
                            and "model" in k.split()[1]], (r, key, i, table)
                assert any(k.split()[1] == "model" for k in table), (r, key, i)


def test_replicated_leaves_and_the_conv_state_bitwise_alike_over_model(world):
    ranks = world["ranks"]
    for key in [k for k in ranks[0] if k != "coords"]:
        for a, b in _peers(ranks, key[1]):
            ga, gb = ranks[a][key], ranks[b][key]
            if key[0] == "train":
                assert ga["replicated"] and ga["replicated"] == gb["replicated"], (key, a, b)
            elif ga["conv"] is not None:
                assert ga["conv"] == gb["conv"], (key, a, b)
                assert all(x.tobytes() == y.tobytes() for x, y in zip(ga["logits"], gb["logits"]))
