"""The dry run's LM cells against the reference's, and their prices against
what comm counts in gloo CPU worlds.

* ``model_flops`` equals ``repro.launch.dryrun.model_flops`` for the ten
  architectures x four shapes; the per-cell choices (``dp_axes``,
  ``act_batch_axes``, ``attn_sharding``, ``fsdp_axis``, the hierarchical
  trainer, ``n_micro``) equal the ones the reference's ``dryrun_lm_cell``
  passes to its artifact functions, on both meshes with and without
  ``--hierarchical``; its SKIP rows are ``arch_skips``'. The JAX dry-run
  module forces 512 host devices when imported, so it runs in a
  subprocess, with its artifact functions replaced by recorders.
* ``price_lm`` on a ``MeshLayout`` (meta tensors, no process group) prices
  what a rank of a gloo world of the same shape counts in ``comm``, call
  by call, exactly: a sync training step on (data, model) = (2, 2)
  (head-parallel attention; reduced qwen2 and grok-1, its experts split
  over ``model``) and on (1, 4) (qwen2's 2 KV heads do not divide 4:
  context-parallel), a hierarchical int8 step and its sync step on (pod,
  data, model) = (2, 1, 2), each step's split collectives forward and
  backward, remat's recomputed ones included, and a prefill and a decode
  call on the two serving meshes, (2, 2) (KV heads over ``model``) and
  (1, 4) (the sequence over ``model``), reduced qwen2, and reduced grok-1
  (MoE) on (2, 2): the compute split's collectives, and no parameter
  gathered over ``model``. On (2, 2) also a step of two microbatches a
  rank (reduced zamba2) and of three (reduced qwen2): the microbatch
  loop's collectives are priced once a microbatch, the step's own once.
* The CLI prices ``--arch qwen2-0.5b --shape all --mesh both`` on the CPU
  and exits 0: every row OK or SKIP, with the reference's FLOPs.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.registry import arch_skips as jarch_skips
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.configs.registry import arch_skips, get_arch, list_archs
from repro_torch.core import comm
from repro_torch.core.mesh import MeshLayout
from repro_torch.data.pipeline import host_batch
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.train.steps import make_serve_artifacts, make_train_artifacts
from test_torch_comm import ROOT, run_world

ARCHS = list_archs()
SEQ = 16
# remat as the published configs take it, so the recomputed collectives count
REMAT = {"qwen2-0.5b": {"remat": "dots"}, "grok-1-314b": {"remat": "full"}}
SERVE = {"heads": ShapeSpec("serve", "decode", 32, 4), "seq": ShapeSpec("serve", "decode", 64, 1)}
PROMPT = 20

# The reference's dry run with its artifact functions recording what they are given.
_JAX_CELLS = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as d
    from repro.configs.common import SHAPES
    from repro.configs.registry import get_arch, list_archs

    class Recorded(Exception):
        pass

    seen = {}
    real_get_arch = d.get_arch

    def get_arch_rec(arch, **kw):
        if kw:
            seen["act_batch_axes"] = kw.get("act_batch_axes")
            seen["attn_sharding"] = kw.get("attn_sharding")
        return real_get_arch(arch, **kw)

    def train_rec(bundle, mesh=None, batch_axes=None, fsdp_axis=None, hier_cfg=None,
                  n_micro=1, **kw):
        seen.update(dp_axes=batch_axes, fsdp_axis=fsdp_axis, hierarchical=hier_cfg is not None,
                    n_micro=n_micro)
        raise Recorded

    def serve_rec(bundle, shape, mesh=None, fsdp_axis=None, **kw):
        seen.update(fsdp_axis=fsdp_axis)
        raise Recorded

    d.get_arch, d.make_train_artifacts, d.make_serve_artifacts = get_arch_rec, train_rec, serve_rec
    out = {"flops": {}, "cells": {}}
    for arch in list_archs():
        for name, shape in SHAPES.items():
            out["flops"][f"{arch}/{name}"] = d.model_flops(real_get_arch(arch), shape)
            for multi in (False, True):
                for hier in (False, True):
                    seen.clear()
                    try:
                        row = d.dryrun_lm_cell(arch, name, multi, hier)
                        seen["status"] = row["status"]
                    except Recorded:
                        pass
                    out["cells"][f"{arch}/{name}/{int(multi)}/{int(hier)}"] = dict(seen)
    print(json.dumps(out))
""")


def _jax_cells() -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", _JAX_CELLS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _cli(args) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _as_lists(x):
    return json.loads(json.dumps(x))


def test_cells_flops_choices_and_skips_match_the_reference_and_the_cli_runs(tmp_path):
    out = tmp_path / "rows.json"
    cli = _cli(["--arch", "qwen2-0.5b", "--shape", "all", "--mesh", "both", "--out", str(out)])
    jax_run = _jax_cells()
    try:
        jout, jerr = jax_run.communicate(timeout=600)
        cout, cerr = cli.communicate(timeout=600)
    finally:
        for p in (cli, jax_run):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert jax_run.returncode == 0, jerr[-3000:]
    ref = json.loads(jout.strip().splitlines()[-1])
    for arch in ARCHS:
        assert arch_skips(arch) == jarch_skips(arch), arch
        bundle = get_arch(arch)
        for name, shape in SHAPES.items():
            assert dryrun.model_flops(bundle, shape) == ref["flops"][f"{arch}/{name}"], (arch, name)
            for multi in (False, True):
                for hier in (False, True):
                    want = ref["cells"][f"{arch}/{name}/{int(multi)}/{int(hier)}"]
                    skip = arch_skips(arch).get(name)
                    if skip:
                        assert want == {"status": f"SKIP({skip})"}
                        row = dryrun.dryrun_lm_cell(arch, name, multi, hier)
                        assert row["status"] == want["status"], (arch, name)
                        continue
                    got = _as_lists(dryrun.lm_cell_choices(arch, name, multi, hier))
                    if shape.kind != "train":  # the reference's serve cells pass no DP axes
                        for k in ("dp_axes", "hierarchical", "n_micro"):
                            got.pop(k)
                    assert got == want, (arch, name, multi, hier)
    # the CLI
    assert cli.returncode == 0, (cout[-3000:], cerr[-3000:])
    rows = json.loads(out.read_text())
    assert [r["status"][:4] for r in rows] == ["OK", "OK", "OK", "SKIP"] * 2, cout
    assert "=== dry-run summary: 6 OK, 2 SKIP, 0 FAIL ===" in cout
    for r in rows:
        if r["status"] == "OK":
            assert r["model_flops_total"] == ref["flops"][f"qwen2-0.5b/{r['shape']}"]
            assert r["flops_per_device"] > 0 and r["rank_bytes"]["held"] > 0
            assert r["dominant"] in r["roofline"] and r["hbm_gib_modelled"] > 0
            total = r["flops_per_device"] * (512 if r["mesh"] == "2x16x16" else 256)
            assert r["useful_flops_ratio"] == r["model_flops_total"] / total


def test_the_cli_refuses_an_unknown_shape(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_9k"])
    assert e.value.code == 2 and "--shape: 'train_9k'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# priced against counted, in gloo worlds


def _train_calls(mesh, arch, hier: bool, n_micro: int = 1):
    """A training step of ``n_micro`` microbatches of one sequence a rank
    (and, hierarchical, its sync step) on this rank: what comm counted in
    each, as the dry run tabulates it."""
    bundle = get_arch(arch, reduced=True, **REMAT.get(arch, {}))
    pod = "pod" if hier else None
    art = make_train_artifacts(bundle, mesh=mesh, batch_axes=("data",),
                               hier_cfg=HierarchicalConfig(sync_every=2, compression="int8")
                               if hier else None, n_micro=n_micro)
    params = bundle.model.init_params(torch.Generator().manual_seed(0)).requires_grad_()
    opt = adamw_init(params, AdamWConfig(moment_dtype=bundle.moment_dtype))
    sync = None
    if hier:
        sync = art.shard(art.hier.init_sync_state(params), "sync")
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    params, opt = art.shard(params, "params"), art.shard(opt, "opt")
    n = n_micro * mesh.extent(("data",)) * (mesh.shape["pod"] if hier else 1)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, bundle.cfg.vocab, (n, SEQ))
    batch = host_batch({"tokens": toks, "labels": toks}, mesh, ("data",), pod)
    comm.reset_stats()
    params, opt, _ = art.step_fn(params, opt, batch)
    out = {"step": dryrun._table()}
    if hier:
        comm.reset_stats()
        art.sync_fn(params, sync)
        out["sync"] = dryrun._table()
    return out


def _serve_calls(mesh, arch, shape):
    """A prefill and a decode call on this rank: what comm counted in each."""
    bundle = get_arch(arch, reduced=True)
    art = make_serve_artifacts(bundle, shape, mesh)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(5).integers(0, bundle.cfg.vocab, (shape.global_batch, PROMPT + 1))
    batch = host_batch({"tokens": toks}, mesh, art.batch_axes)
    comm.reset_stats()
    _, state = art.prefill_fn(params, {"tokens": batch["tokens"][:, :PROMPT]})
    out = {"prefill": dryrun._table()}
    comm.reset_stats()
    art.decode_fn(params, state, batch["tokens"][:, PROMPT:], PROMPT)
    out["decode"] = dryrun._table()
    return out


# key: (arch, microbatches of a step) of the steps a world prices
TRAIN = {"train": ("qwen2-0.5b", 1), "train_moe": ("grok-1-314b", 1),
         "train_micro2": ("zamba2-1.2b", 2), "train_micro3": ("qwen2-0.5b", 3)}


def data_model_rank(mesh, payload):
    return {"train": _train_calls(mesh, "qwen2-0.5b", False),
            "train_moe": _train_calls(mesh, "grok-1-314b", False),
            "train_micro2": _train_calls(mesh, "zamba2-1.2b", False, 2),
            "train_micro3": _train_calls(mesh, "qwen2-0.5b", False, 3),
            "serve": _serve_calls(mesh, "qwen2-0.5b", SERVE["heads"]),
            "serve_moe": _serve_calls(mesh, "grok-1-314b", SERVE["heads"])}


def seq_rank(mesh, payload):
    return {"train": _train_calls(mesh, "qwen2-0.5b", False),
            "serve": _serve_calls(mesh, "qwen2-0.5b", SERVE["seq"])}


def pod_rank(mesh, payload):
    return {"train": _train_calls(mesh, "qwen2-0.5b", True)}


def _price_train(arch, layout, hier, n_micro=1):
    return dryrun.price_lm(get_arch(arch, reduced=True, **REMAT.get(arch, {})),
                           ShapeSpec("t", "train", SEQ, 1),
                           layout, hier_cfg=HierarchicalConfig(sync_every=2, compression="int8")
                           if hier else None, n_micro=n_micro, count_flops=False)


def _price_serve(arch, layout, shape):
    bundle = get_arch(arch, reduced=True)
    prefill = ShapeSpec(shape.name, "prefill", shape.seq_len, shape.global_batch)
    return {"prefill": dryrun.price_lm(bundle, prefill, layout, prompt_len=PROMPT,
                                       count_flops=False),
            "decode": dryrun.price_lm(bundle, shape, layout, cache_index=PROMPT,
                                      count_flops=False)}


@pytest.mark.parametrize("world", ["data_model", "seq", "pod"])
def test_priced_collectives_equal_the_counted_ones(tmp_path, world):
    shape, names = {"data_model": ((2, 2), ("data", "model")),
                    "seq": ((1, 4), ("data", "model")),
                    "pod": ((2, 1, 2), ("pod", "data", "model"))}[world]
    ranks = run_world(tmp_path, shape, names, f"test_torch_dryrun_lm:{world}_rank")
    for r, got in enumerate(ranks):
        layout = MeshLayout(shape, names, r)
        for key, (arch, n_micro) in TRAIN.items():
            if key not in got:
                continue
            priced = _price_train(arch, layout, world == "pod", n_micro)
            assert priced["collectives"] == got[key]["step"], (world, r, key)
            kinds = {k.split()[0] for k in got[key]["step"]}
            split = {"split_grad_sum", "partial_sum", "split_max"}
            if world == "seq":  # context-parallel attention
                split |= {"split_gather", "slice_grad_gather"}
            assert split <= kinds, (world, key, kinds)
            assert not any("model" in k.split()[1] for k in got[key]["step"]
                           if k.split()[0] == "all_gather"), (world, key)  # no model gather
            if world == "pod":
                assert priced["sync_step"]["collectives"] == got["train"]["sync"], r
                assert set(got["train"]["sync"]) == {"all_gather pod",
                                                     "all_reduce_max data,model"}
        for key, arch in (("serve", "qwen2-0.5b"), ("serve_moe", "grok-1-314b")):
            if key not in got:
                continue
            priced = _price_serve(arch, layout, SERVE["seq" if world == "seq" else "heads"])
            for call in ("prefill", "decode"):
                assert priced[call]["collectives"] == got[key][call], (world, r, key, call)
            # the compute split: partial sums, the logits' (and with the
            # sequence split q, k and v's) column gathers, the softmax
            # partials; parameters gathered over data alone
            kinds = {k.split()[0] for k in got[key]["decode"]}
            assert kinds == ({"partial_sum", "split_gather", "merge_partials"} if world == "seq"
                             else {"all_gather", "partial_sum", "split_gather"}), kinds
            assert not any(k.split()[0] == "all_gather" and "model" in k.split()[1]
                           for call in ("prefill", "decode") for k in got[key][call]), key
