"""Serving's compute split over ``model`` on gloo CPU worlds: a call of the
transformer-backbone families gathers no parameter over ``model`` and
computes only the rank's share, against the port's one-device serving of
the rank's batch slice, JAX's mesh serving, and the dry run's price.

``make_serve_artifacts(bundle, shape, mesh)`` with reduced configs, weights
drawn by the port from seed 0, prompts and the stub frontends' inputs from
numpy (seed 7, ``tests/test_torch_serve_mesh.py``'s ``_inputs``), a bf16
cache, FSDP over ``data`` (the default), a prefill and 2 decode steps:

* a ``(data, model)`` = (2, 2) world at B 4, a cache of 32 and a 20-token
  prompt: qwen2 (its 2 KV heads over ``model``: ``"heads"``), grok-1 (its
  experts' ``d_ff`` over ``model``: ``"tp"``), llama4-maverick (its experts
  over ``model``, ``"ep"``, and a shared expert), internvl2 (the connector's
  columns and the backbone), and qwen2 as the ``long_500k`` cell (a cache
  of 64 with its sequence over ``model``: ``"seq"``, a 40-token prompt);
* a (1, 4) world, qwen2 at B 1 and a cache of 64 (its 2 KV heads do not
  divide 4: ``"seq"``), once with a 40-token prompt, whose queries split
  over the four ranks, and once with a 42-token one, which does not divide
  and attends whole.

Bars: the prefill logits within 1e-4 and the decode logits within 5e-4 of
the largest logit of the one-device serving of the rank's batch slice
(row-split products reorder sums: not bitwise), on the sequences whose MoE
expert choices agree with the reference's at every call; a token whose
choice flips is counted and printed, and fails above a 1e-5 gate margin
(``tests/test_torch_tp.py``'s rule). qwen2 ``"heads"`` and grok-1 are also
held within the same bars to JAX's ``make_serve_artifacts(mesh=...)`` on a
(2, 2) mesh of forced host devices with ``Auto`` axes. In every case:
``comm`` counts no ``all_gather`` over ``model``, so a rank's gathered
parameter bytes are its model shard's gather over ``data``; what each call
counts equals ``dryrun.price_lm``'s price on a ``MeshLayout`` of the same
rank; every held parameter and cache leaf has its shard's shape; the logits
and the routing, computed alike on every model rank, are bitwise equal
across the ranks that differ only along ``model``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core import comm
from repro_torch.core.mesh import MeshLayout
from repro_torch.launch import dryrun
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_serve_artifacts
from test_torch_comm import ROOT, run_world
from test_torch_serve_mesh import (_flat, _inputs, _param_gather_bytes, _rank_inputs,
                                   named_leaves_specs)
from test_torch_tp import MARGIN, _Routes

DECODE = ShapeSpec("serve", "decode", 32, 4)
LONG = ShapeSpec("long_500k", "decode", 64, 1)
SEQ = ShapeSpec("serve", "decode", 64, 1)
STEPS = 2
PREFILL_BAR, DECODE_BAR = 1e-4, 5e-4
# name: (arch, shape, prompt, the attention split)
DATA_MODEL = {
    "qwen2-heads": ("qwen2-0.5b", DECODE, 20, "heads"),
    "grok-tp": ("grok-1-314b", DECODE, 20, "heads"),
    "llama4-ep": ("llama4-maverick-400b-a17b", DECODE, 20, "heads"),
    "internvl2": ("internvl2-76b", DECODE, 20, "heads"),
    "qwen2-long": ("qwen2-0.5b", LONG, 40, "seq"),
}
ONE_BY_FOUR = {
    "qwen2-seq": ("qwen2-0.5b", SEQ, 40, "seq"),
    "qwen2-seq-whole": ("qwen2-0.5b", SEQ, 42, "seq"),
}
JAX_CASES = ("qwen2-heads", "grok-tp")


def _serve(bundle, shape, toks, batch, mesh=None):
    """A prefill of ``batch`` and ``STEPS`` decode steps of ``toks`` on
    ``mesh`` (this rank's shards) or one device: each call's logits and
    what comm counted, the routes, the artifacts, the parameters and the
    serve state held."""
    art = make_serve_artifacts(bundle, shape, mesh)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    prompt = batch["tokens"].shape[1]
    logits, tables = [], []
    with _Routes() as routes:
        routes.on = True
        comm.reset_stats()
        out, state = art.prefill_fn(params, batch)
        logits.append(out)
        tables.append(dryrun._table())
        for i in range(prompt, prompt + STEPS):
            comm.reset_stats()
            out, state = art.decode_fn(params, state, torch.from_numpy(toks[:, i:i + 1]), i)
            logits.append(out)
            tables.append(dryrun._table())
    return logits, tables, routes.calls, art, params, state


def _case(mesh, arch, shape, prompt) -> dict:
    """One case on this rank, against the one-device serving of its batch
    slice and the dry run's price."""
    bundle = get_arch(arch, reduced=True)
    toks, batch = _rank_inputs(bundle, shape, prompt, mesh)
    logits, tables, routes, art, params, state = _serve(bundle, shape, toks, batch, mesh)
    local = dataclasses.replace(shape, global_batch=toks.shape[0])
    ref_logits, _, ref_routes, _, _, _ = _serve(bundle, local, toks, batch)
    # the expert choices against the reference's, sequence by sequence
    flips, flipped = [], set()
    for i, ((got, _), (want, gates)) in enumerate(zip(routes, ref_routes)):
        for b, s in zip(*np.nonzero((got != want).any(-1))):
            flips.append((i, int(b), int(s), float(np.abs(np.diff(gates[b, s])).min())))
            flipped.add(int(b))
    keep = [b for b in range(toks.shape[0]) if b not in flipped]
    errs = [float((got[keep] - want[keep]).abs().max() / want[keep].abs().max())
            for got, want in zip(logits, ref_logits)]
    # the dry run's price of a prefill and a decode call on this rank
    layout = MeshLayout(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)
    prefill = ShapeSpec(shape.name, "prefill", shape.seq_len, shape.global_batch)
    priced = [dryrun.price_lm(bundle, prefill, layout, prompt_len=prompt,
                              count_flops=False)["collectives"]]
    priced += [dryrun.price_lm(bundle, shape, layout, cache_index=i,
                               count_flops=False)["collectives"]
               for i in range(prompt, prompt + STEPS)]
    # every held leaf is its shard
    shapes_ok = all(tuple(x.shape) == tuple(mesh.shard(w, art.named_specs[n]).shape)
                    for (n, x), w in zip(named_leaves(params).items(),
                                         named_leaves(art.params_sds).values()))
    shapes_ok &= all(tuple(x.shape) == tuple(mesh.shard(w, sp).shape) for x, w, sp in zip(
        named_leaves(state["cache"]).values(), named_leaves(art.state_sds["cache"]).values(),
        named_leaves_specs(art.state_specs["cache"])))
    # the parameters' gathers: the model shards' over data, from the specs
    # (a prefill's, then a decode step's)
    gathers, decode_gathers = ({f"{op} {','.join(axes)}": n for (op, axes), n in
                                _param_gather_bytes(art, mesh, bundle, prefill).items()}
                               for prefill in (True, False))
    gathers_ok = all({k: v["bytes"] for k, v in t.items() if k.startswith("all_gather ")}
                     == (gathers if call == 0 else decode_gathers)
                     for call, t in enumerate(tables))
    return {"attn": art.split.attn, "kv": art.split.kv, "errs": errs, "flips": flips,
            "tables": tables, "priced": priced, "shapes_ok": shapes_ok,
            "gathers_ok": gathers_ok, "gathers": gathers,
            "logits": [x.numpy() for x in logits],
            "routes": [got.tobytes() for got, _ in routes]}


def data_model_rank(mesh, payload):
    torch.manual_seed(0)
    return {"coords": mesh.coords,
            **{name: _case(mesh, *case[:3]) for name, case in DATA_MODEL.items()}}


def one_by_four_rank(mesh, payload):
    torch.manual_seed(0)
    return {"coords": mesh.coords,
            **{name: _case(mesh, *case[:3]) for name, case in ONE_BY_FOUR.items()}}


def _jax_serving(tmp_path) -> subprocess.Popen:
    """JAX's serving of :data:`JAX_CASES` on a (2, 2) ``Auto`` mesh of
    forced host devices from the port's weights, in a subprocess: every
    call's logits of the whole batch."""
    for name in JAX_CASES:
        arch, shape, prompt, _ = DATA_MODEL[name]
        bundle = get_arch(arch, reduced=True)
        tree = bundle.model.params_to_numpy(
            bundle.model.init_params(torch.Generator().manual_seed(0)))
        np.savez(tmp_path / f"w-{name}.npz",
                 **{"/".join(k): v for k, v in _flat(tree).items()})
        np.save(tmp_path / f"toks-{name}.npy", _inputs(bundle, shape, prompt)[0])
    cases = {n: (DATA_MODEL[n][0], DATA_MODEL[n][1].seq_len, DATA_MODEL[n][1].global_batch,
                 DATA_MODEL[n][2]) for n in JAX_CASES}
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.common import ShapeSpec
        from repro.configs.registry import get_arch
        from repro.train.steps import make_serve_artifacts

        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        for name, (arch, cache, batch, prompt) in {cases!r}.items():
            b = get_arch(arch, reduced=True)
            art = make_serve_artifacts(b, ShapeSpec("serve", "decode", cache, batch), mesh)
            params = {{}}
            for key, v in dict(np.load(f"{tmp_path}/w-{{name}}.npz")).items():
                node = params
                *head, last = key.split("/")
                for k in head:
                    node = node.setdefault(k, {{}})
                node[last] = jnp.asarray(v)
            params = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                                  params, art.params_specs, is_leaf=lambda x: isinstance(x, P))
            toks = np.load(f"{tmp_path}/toks-{{name}}.npy").astype(np.int32)
            out = []
            logits, state = art.prefill_fn(params, {{"tokens": jnp.asarray(toks[:, :prompt])}})
            out.append(np.asarray(logits))
            for i in range(prompt, prompt + {STEPS}):
                logits, state = art.decode_fn(params, state, jnp.asarray(toks[:, i:i + 1]),
                                              jnp.int32(i))
                out.append(np.asarray(logits))
            np.save(f"{tmp_path}/jax-{{name}}.npy", np.stack(out))
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _assert_case(case, attn, what):
    assert case["attn"] == attn and case["kv"] == attn, what
    print(f"routing flips {what}: {case['flips']}")
    assert all(margin <= MARGIN for *_, margin in case["flips"]), (what, case["flips"])
    for call, err in enumerate(case["errs"]):
        assert err <= (PREFILL_BAR if call == 0 else DECODE_BAR), (what, call, err)
    for call, (got, priced) in enumerate(zip(case["tables"], case["priced"])):
        assert got == priced, (what, call, got, priced)
        assert not [k for k in got if k.split()[0] == "all_gather" and "model" in k.split()[1]]
    assert case["gathers_ok"], (what, case["gathers"], case["tables"])
    assert case["shapes_ok"], what


def _assert_model_peers(ranks, names):
    """The logits and the routes bitwise alike on the ranks that differ
    only along ``model``."""
    for a in range(len(ranks)):
        for b in range(a + 1, len(ranks)):
            ca, cb = ranks[a]["coords"], ranks[b]["coords"]
            if {k: v for k, v in ca.items() if k != "model"} != \
                    {k: v for k, v in cb.items() if k != "model"}:
                continue
            for name in names:
                ga, gb = ranks[a][name], ranks[b][name]
                assert all(x.tobytes() == y.tobytes() for x, y in zip(ga["logits"], gb["logits"]))
                assert ga["routes"] == gb["routes"], (name, a, b)


def test_compute_split_on_a_data_model_world_near_one_device_and_jax(tmp_path):
    jax_run = _jax_serving(tmp_path)
    try:
        ranks = run_world(tmp_path / "world", (2, 2), ("data", "model"),
                          "test_torch_serve_tp:data_model_rank")
        out, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, out[-3000:]
    for r, got in enumerate(ranks):
        for name, (arch, shape, _, attn) in DATA_MODEL.items():
            _assert_case(got[name], attn, (r, name))
            assert set(got[name]["gathers"]) == {"all_gather data"}, name  # FSDP over data
        d = got["coords"]["data"]
        for name in JAX_CASES:
            want = np.load(tmp_path / f"jax-{name}.npy")[:, 2 * d:2 * d + 2]
            flipped = {b for _, b, _, _ in got[name]["flips"]}
            keep = [b for b in range(2) if b not in flipped]
            for call, logits in enumerate(got[name]["logits"]):
                err = np.abs(logits[keep] - want[call][keep]).max() / np.abs(
                    want[call][keep]).max()
                assert err <= (PREFILL_BAR if call == 0 else DECODE_BAR), (r, name, call, err)
    _assert_model_peers(ranks, DATA_MODEL)


def test_compute_split_on_a_one_by_four_world_with_a_prompt_that_divides_or_not(tmp_path):
    ranks = run_world(tmp_path, (1, 4), ("data", "model"), "test_torch_serve_tp:one_by_four_rank")
    for r, got in enumerate(ranks):
        for name, (_, _, _, attn) in ONE_BY_FOUR.items():
            _assert_case(got[name], attn, (r, name))
            assert got[name]["gathers"] == {}, name  # data extent 1: nothing to gather
        # a prompt that divides gathers the attention's output along the
        # sequence; one that does not attends whole and gathers none
        assert got["qwen2-seq"]["tables"][0]["split_gather model"]["calls"] == 2 * 4 + 1
        assert got["qwen2-seq-whole"]["tables"][0]["split_gather model"]["calls"] == 2 * 3 + 1
    _assert_model_peers(ranks, ONE_BY_FOUR)
