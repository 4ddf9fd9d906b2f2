"""The bf16 compute split against its own one-device step, held to the
departure JAX's mesh trainer shows against its own.

Reduced grok-1 (MoE, its experts' d_ff over ``model``) in bf16 weights
and bf16 compute, weights drawn by the port from seed 0 (f32, rounded to
bf16 alike on both sides), batches from ``SyntheticLM`` (global batch 4,
S 16), AdamW lr 1e-3, 2 steps:

* JAX's sync trainer (``make_train_artifacts(mesh=...)``) on a (data,
  model) = (2, 2) mesh of forced host devices with ``Auto`` axes against
  the same trainer without a mesh, in a subprocess: how far the mesh's
  parameters depart from one device's, as the share of elements within
  1e-5 of the largest parameter and the largest difference;
* the port's trainer on a (2, 2) gloo world (FSDP over ``data``, the
  compute split over ``model``) against the port's one-device trainer
  (``n_micro`` 1): its parameters depart by no more than JAX's do, in
  both measures. In bf16 a row-split product rounds each rank's partial
  product before the sum (GSPMD's partial sums round alike), so neither
  is bitwise its one device.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts
from test_torch_comm import ROOT, run_world

ARCH = "grok-1-314b"
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
LR, SEQ, BATCH, STEPS = 1e-3, 16, 4, 2


def _opt():
    return AdamWConfig(lr=LR, warmup_steps=2)


def _init(bundle):
    """The port's seed-0 weights of the f32 config, rounded to bf16."""
    f32 = get_arch(ARCH, reduced=True).model.init_params(torch.Generator().manual_seed(0))
    params = bundle.model.init_params(None, device="meta")
    params.load_state_dict({n: x.detach().to(torch.bfloat16)
                            for n, x in named_leaves(f32).items()}, assign=True)
    return params.requires_grad_(), f32


def _train(art, bundle, batch_of):
    params, _ = _init(bundle)
    opt = adamw_init(params, _opt())
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    for step in range(STEPS):
        params, opt, _ = art.step_fn(params, opt, batch_of(step))
    return params


def split_rank(mesh, payload):
    bundle = get_arch(ARCH, reduced=True, **BF16)
    art = make_train_artifacts(bundle, _opt(), mesh, batch_axes=("data",))
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
    params = _train(art, bundle, lambda s: host_batch(ds.batch(s), mesh, ("data",)))
    return {n: x.detach().float().numpy() for n, x in
            named_leaves(art.gather(params, "params")).items()}


def _departure(got: dict, want: dict) -> tuple[float, float]:
    """(the share of elements within 1e-5 of the largest of ``want``, the
    largest difference), over every leaf."""
    top = max(np.abs(w).max() for w in want.values())
    close = total = 0
    worst = 0.0
    for n, w in want.items():
        d = np.abs(got[n].astype(np.float64) - w.astype(np.float64))
        close += int((d <= 1e-5 * top).sum())
        total += d.size
        worst = max(worst, float(d.max()))
    return close / total, worst


def _jax_departure(tmp_path, tree) -> subprocess.Popen:
    """JAX's mesh trainer against its one device, in a subprocess that
    writes ``jax.json``: (share, largest)."""
    np.savez(tmp_path / "init.npz", **{"/".join(k): v for k, v in _flat(tree).items()})
    code = textwrap.dedent(f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.registry import get_arch
        from repro.data.pipeline import SyntheticLM, host_batch
        from repro.optim.adamw import AdamWConfig, adamw_init
        from repro.train.steps import make_train_artifacts

        b = get_arch({ARCH!r}, reduced=True, **{BF16!r})
        cfg = AdamWConfig(lr={LR}, warmup_steps=2)
        flat = dict(np.load({str(tmp_path / 'init.npz')!r}))

        def run(mesh):
            art = make_train_artifacts(b, cfg, mesh=mesh, batch_axes=("data",), donate=False)
            params = {{}}
            for key, v in flat.items():
                node = params
                *head, last = key.split("/")
                for k in head:
                    node = node.setdefault(k, {{}})
                node[last] = jnp.asarray(v, dtype=jnp.bfloat16)
            opt = adamw_init(params, cfg)
            if mesh is not None:
                put = lambda t, s: jax.tree.map(
                    lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s,
                    is_leaf=lambda x: isinstance(x, P))
                params, opt = put(params, art.params_specs), put(opt, art.opt_specs)
            ds = SyntheticLM(b.cfg.vocab, {SEQ}, {BATCH}, seed=1)
            for s in range({STEPS}):
                params, opt, _ = art.step_fn(params, opt, host_batch(ds.batch(s), mesh,
                                                                       ("data",)))
            return [np.asarray(x, dtype=np.float64) for x in jax.tree.leaves(params)]

        one = run(None)
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        split = run(mesh)
        top = max(np.abs(w).max() for w in one)
        d = [np.abs(g - w) for g, w in zip(split, one)]
        share = sum(int((x <= 1e-5 * top).sum()) for x in d) / sum(x.size for x in d)
        with open({str(tmp_path / 'jax.json')!r}, "w") as f:
            json.dump([share, max(float(x.max()) for x in d)], f)
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def test_bf16_split_departs_from_one_device_no_more_than_jax(tmp_path):
    bundle = get_arch(ARCH, reduced=True, **BF16)
    _, f32 = _init(bundle)
    jax_run = _jax_departure(tmp_path, get_arch(ARCH, reduced=True).model.params_to_numpy(f32))
    try:
        ranks = run_world(tmp_path / "world", (2, 2), ("data", "model"),
                          "test_torch_split_bf16:split_rank")
        out, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, out[-3000:]
    jax_share, jax_worst = json.loads((tmp_path / "jax.json").read_text())
    art = make_train_artifacts(bundle, _opt())
    ds = SyntheticLM(bundle.cfg.vocab, SEQ, BATCH, seed=1)
    one = {n: x.detach().float().numpy() for n, x in named_leaves(
        _train(art, bundle, lambda s: host_batch(ds.batch(s), "cpu"))).items()}
    for r, got in enumerate(ranks):
        share, worst = _departure(got, one)
        print(f"rank {r}: port share {share:.5f} largest {worst:.3g}; "
              f"JAX share {jax_share:.5f} largest {jax_worst:.3g}")
        assert share >= jax_share and worst <= jax_worst, (r, share, worst, jax_share,
                                                           jax_worst)
