"""Serving on a mesh of gloo CPU processes against the port's one-device
serving of the same batch slice, and the sequence split against JAX.

``make_serve_artifacts(bundle, shape, mesh)``: a rank holds its parameter
shards, its slice of the batch and its shards of the cache; a call gathers
each unit (a layer, the embedding, the head) over every axis but ``model``
where it runs and computes only the rank's share, attending (or stepping
its SSM heads) where its cache shard lies.
Reduced configs, weights drawn by the port from seed 0, prompts and the
stub frontends' inputs from numpy (seed 7), a bf16 cache:

* a ``(data, model)`` = (2, 2) world serves all ten architectures at B 4,
  a cache of 32, a 20-token prompt and 2 decode steps (the batch over
  ``data``, the KV heads and the SSM heads over ``model``), and again as
  the ``long_500k`` cell, ``ShapeSpec("long_500k", "decode", 64, 1)``: no
  batch axes, the cache's sequence over ``model`` (shards of 32 positions),
  a 40-token prompt that crosses them;
* a (1, 4) world serves reduced qwen2 (2 KV heads over 4: the sequence
  splits, shards of 16 positions, a 40-token prompt), mamba2 (its 8 SSM
  heads over 4) and zamba2 with the streaming path (``FLASH_THRESHOLD`` 16
  and key blocks ``_K_CHUNK`` 16 in the rank) over shards of 16, and
  raises for zamba2 where the one-device key blocks (16) do not tile a
  shard (a cache of 72: shards of 18) and for a cache that does not divide
  over ``model`` (66 positions over 4);
* a ``(pod, data, model)`` = (2, 2, 1) world serves qwen2 and grok-1 (MoE)
  with the batch over ``("pod", "data")``.

Bars (each case names its reference, the one-device serving of this
rank's batch slice with the whole parameters): the batch split alone
(model extent 1) is bitwise (the logits and the gathered cache); the
compute split's row-split products reorder sums, so its prefill logits are
within 1e-4 and its decode logits within 5e-4 of the largest logit (the
reference's bars), its cache bitwise or within a bf16 rounding of each
leaf's largest. A prefill that attends over the bf16 cache it has just
written (zamba2's shared block and whisper's decoder write in place, as
the reference does) reads K/V whose bf16 rounding a reordered sum can
flip, as every decode step does: it is held at the serving bar 5e-4 (with
an f32 cache the same calls are within 1e-4:
``tests/test_torch_tp_ssm_audio.py``). No rank holds more than its shard: every cache leaf has
its shard's shape, and what comm counts in a call is the parameters'
gathers over ``data`` (bytes from their specs, a tied embedding's at both
its uses) and the compute split's
partial sums, gathers and softmax partials (bytes from the shapes),
nothing of the cache and no parameter over ``model``. The (1, 4) qwen2
logits are also held within 5e-4 to JAX's ``make_serve_artifacts(mesh=...)``
on 4 forced host devices (``Auto`` axes).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.core import comm
from repro_torch.data.pipeline import host_batch
from repro_torch.models import layers
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_serve_artifacts
from test_torch_comm import ROOT, run_world

ARCHS = list_archs()
DECODE = ShapeSpec("serve", "decode", 32, 4)
LONG = ShapeSpec("long_500k", "decode", 64, 1)
PROMPT, LONG_PROMPT, STEPS = 20, 40, 2
BAR = 5e-4          # decode logits, of the largest (the reference's SERVE bar)
PREFILL_BAR = 1e-4  # prefill logits under the compute split


def _inputs(bundle, shape: ShapeSpec, prompt: int):
    """Tokens for the prompt and the decode steps, and the stub frontends'
    inputs, from numpy (seed 7)."""
    rng = np.random.default_rng(7)
    b = shape.global_batch
    toks = rng.integers(0, bundle.cfg.vocab, (b, prompt + STEPS)).astype(np.int64)
    batch = {"tokens": toks[:, :prompt]}
    for name, make in bundle.extra_inputs.items():
        batch[name] = rng.normal(size=tuple(make(b, prompt).shape)).astype(np.float32)
    return toks, batch


def _serve(bundle, shape, toks, batch, mesh=None, axes=None):
    """Prefill ``batch`` (numpy), then ``STEPS`` decode steps of ``toks``
    on ``mesh`` (its shards) or on one device (``mesh`` None), the inputs
    as given. Returns the logits of every call, the cache after the
    prefill (gathered over ``axes`` on a mesh) and after the last step, the
    artifacts and what comm counted in each call."""
    art = make_serve_artifacts(bundle, shape, mesh)
    params = art.shard(bundle.model.init_params(torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    prompt = batch["tokens"].shape[1]
    logits, counted = [], []
    comm.reset_stats()
    out, state = art.prefill_fn(params, batch)
    logits.append(out)
    counted.append(dict(comm.received))
    first = state["cache"] if mesh is None else art.gather_state(state, axes)["cache"]
    first = {n: x.clone() for n, x in named_leaves(first).items()}
    for i in range(prompt, prompt + STEPS):
        comm.reset_stats()
        out, state = art.decode_fn(params, state, torch.from_numpy(toks[:, i:i + 1]), i)
        logits.append(out)
        counted.append(dict(comm.received))
    return logits, (first, state), art, counted


def _rank_inputs(bundle, shape, prompt, mesh):
    """This rank's slice of :func:`_inputs`, numpy, by the batch axes
    serving picks (none for ``long_500k``)."""
    toks, batch = _inputs(bundle, shape, prompt)
    if shape.name == "long_500k":
        return toks, batch
    axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    cut = host_batch({"toks": toks, **batch}, mesh, axes)
    cut = {k: v.numpy() for k, v in cut.items()}
    return cut.pop("toks"), cut


def _computes(art) -> bool:
    """Whether ``art`` splits the compute over ``model`` (its parameters
    model shards): every family does where the model extent is above 1."""
    return art.split is not None


def _param_gather_bytes(art, mesh, bundle, prefill: bool) -> dict:
    """Bytes into a rank as the FSDP gather point gathers the parameters
    in a prefill (``prefill``) or a decode call, from their specs and
    shapes alone: one gather a split dimension, in order, each of ``extent
    - 1`` times what has been gathered so far; under the compute split none
    over ``model``. Each unit is gathered where it runs: once a call, a
    tied embedding (no ``lm_head`` beside it) at both of its uses (the
    lookup and the unembedding), zamba2's shared block at each of its
    applications, and the VLM's connector and the audio encoder by a
    prefill alone (a decode step carries no image and reads the encoder's
    output from the serve state)."""
    out = {}
    names = named_leaves(art.params_sds)
    for name, x in names.items():
        uses = 1
        if name.endswith("embed") and name[:-5] + "lm_head" not in names:
            uses = 2
        elif name.startswith("shared."):
            uses = bundle.cfg.n_apps
        elif name.startswith(("connector.", "enc_layers.", "enc_final_ln.")):
            uses = int(prefill)
        for _ in range(uses):
            _leaf_gather_bytes(out, art, mesh, name, x)
    return out


def _leaf_gather_bytes(out: dict, art, mesh, name: str, x) -> None:
    """:func:`_param_gather_bytes` of one gather of leaf ``name``, added
    to ``out``."""
    spec = art.named_specs[name]
    size = x.numel() * x.element_size()
    for axes in spec:
        if axes is not None:
            size //= mesh.extent(axes)
    for axes in spec:
        if _computes(art) and axes is not None and "model" in (
                (axes,) if isinstance(axes, str) else axes):
            continue
        n = 1 if axes is None else mesh.extent(axes)
        if n > 1:
            key = ("all_gather", (axes,) if isinstance(axes, str) else tuple(axes))
            out[key] = out.get(key, 0) + (n - 1) * size
            size *= n


def _tp_bytes(bundle, art, mesh, s: int, b_loc: int, n_patches: int = 0) -> dict:
    """Bytes into a rank of the compute split's collectives in one call of
    ``s`` positions and ``b_loc`` sequences (``n_patches`` image
    positions): the embedding's partial sum ``[b, s, D]``; per layer the
    output product's and the MLP's (each MoE layer: the routed experts'
    and a shared expert's) partial sums, and with the sequence split q, k
    and v's column gathers and, for a prompt, the output's gather along
    the sequence (none where the prompt does not divide) or, for a decode
    step, the softmax partials; the logits' vocab columns of the last
    position; the VLM's connector columns."""
    cfg = bundle.cfg
    t = cfg.backbone if hasattr(cfg, "backbone") else cfg
    n = mesh.extent("model")
    item = torch.empty((), dtype=t.cdtype).element_size()
    act = (n - 1) * b_loc * s * t.d_model * item
    sums = 1 + t.n_layers * 2
    if t.moe is not None and t.moe.shared_expert:
        sums += t.n_groups
    gathers = (n - 1) * b_loc * t.vocab // n * item + (
        (n - 1) * b_loc * n_patches * t.d_model // n * item)
    out = {("partial_sum", ("model",)): sums * act}
    if art.split.attn == "seq":
        cols = (t.n_heads + 2 * t.n_kv) * t.d_head // n
        gathers += t.n_layers * (n - 1) * b_loc * s * cols * item
        if s == 1:
            out[("merge_partials", ("model",))] = t.n_layers * (n - 1) * b_loc * t.n_heads * (
                t.d_head + 2) * 4
        elif s % n == 0:
            gathers += t.n_layers * (n - 1) * b_loc * s // n * t.n_heads * t.d_head * item
    out[("split_gather", ("model",))] = gathers
    return out


def _attention_bytes(art, mesh, s: int, b_loc: int, item: int, layers: int, heads: int,
                     kv: int, d_head: int) -> dict:
    """The sequence split's own bytes in ``layers`` attention layers that
    attend in place over the cache (zamba2's shared block, whisper's
    decoder): q, k and v's column gathers and the softmax partials
    (``[b, Hkv, G, s, Dh + 2]`` f32); none with the heads split."""
    if art.split.attn != "seq":
        return {}
    n = mesh.extent("model")
    return {("split_gather", ("model",)):
            layers * (n - 1) * b_loc * s * (heads + 2 * kv) * d_head // n * item,
            ("merge_partials", ("model",)): layers * (n - 1) * b_loc * heads * s * (d_head + 2) * 4}


def _split_bytes(bundle, art, mesh, s: int, b_loc: int, n_patches: int = 0,
                 prefill: bool = False) -> dict:
    """Bytes into a rank of the compute split's collectives in one call of
    ``s`` positions and ``b_loc`` sequences: the transformer backbones'
    by :func:`_tp_bytes`; for the others the embedding's partial sum
    ``[b, s, D]`` and the logits' vocab columns of the last position, and

    * per mamba layer (mamba2's, zamba2's) ``in_proj``'s and the conv's
      column gathers (``[b, s, C / n]``, ``[b, s, conv_dim / n]``), the
      gated norm's sum of squares (``[b, s, 1]`` f32) and ``out_proj``'s
      partial sum;
    * per application of zamba2's shared block its ``in_proj``'s column
      gather and the attention's and the MLP's partial sums;
    * per whisper decoder layer the self-attention's, the
      cross-attention's and the MLP's partial sums, and at prefill per
      encoder layer the attention's and the MLP's over the frames;

    with the sequence split the attention's own (:func:`_attention_bytes`)."""
    if art.split is None:
        return {}
    if bundle.family in ("dense", "moe", "vlm"):
        return _tp_bytes(bundle, art, mesh, s, b_loc, n_patches)
    cfg = bundle.cfg
    n = mesh.extent("model")
    item = torch.empty((), dtype=cfg.cdtype).element_size()
    act = (n - 1) * b_loc * s * cfg.d_model * item
    sums, gathers = act, (n - 1) * b_loc * cfg.vocab // n * item
    out = {}
    if bundle.family in ("ssm", "hybrid"):
        m = bundle.model.mamba.cfg if bundle.family == "hybrid" else cfg
        cols = 2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads
        gathers += m.n_layers * (n - 1) * b_loc * s * (cols + m.conv_dim) // n * item
        sums += m.n_layers * (act + (n - 1) * b_loc * s * 4)
    if bundle.family == "hybrid":
        gathers += cfg.n_apps * (n - 1) * b_loc * s * cfg.d_model // n * item
        sums += cfg.n_apps * 2 * act
        out = _attention_bytes(art, mesh, s, b_loc, item, cfg.n_apps, cfg.n_heads, cfg.n_kv,
                               cfg.d_head)
    if bundle.family == "audio":
        sums += cfg.n_dec_layers * 3 * act
        if prefill:
            sums += cfg.n_enc_layers * 2 * (n - 1) * b_loc * cfg.n_frames * cfg.d_model * item
        out = _attention_bytes(art, mesh, s, b_loc, item, cfg.n_dec_layers, cfg.n_heads,
                               cfg.n_heads, cfg.d_head)
    key = ("split_gather", ("model",))
    out[key] = out.get(key, 0) + gathers
    out[("partial_sum", ("model",))] = sums
    return out


def _check_rank(bundle, shape, prompt, mesh) -> dict:
    """One case on this rank: its logits and cache against the one-device
    serving of its batch slice, its cache leaves' shapes and its counts."""
    toks, batch = _rank_inputs(bundle, shape, prompt, mesh)
    batch_axes = make_serve_artifacts(bundle, shape, mesh).batch_axes
    # this rank's batch slice of the whole cache: gathered off the batch axes
    axes = tuple(a for a in mesh.axis_names if a not in (batch_axes or ()))
    logits, (first, state), art, counted = _serve(bundle, shape, toks, batch, mesh, axes)
    # the reference: one device, this rank's batch slice, the whole weights
    local = dataclasses.replace(shape, global_batch=toks.shape[0])
    ref_logits, (ref_first, ref_state), _, _ = _serve(bundle, local, toks, batch)
    whole = named_leaves(art.gather_state(state, axes)["cache"])
    out = {"kv": None if art.split is None else art.split.kv, "computes": _computes(art),
           "prefill_reads_cache": bundle.family in ("hybrid", "audio"),
           "batch_axes": art.batch_axes, "logits_bitwise": [], "err": []}
    for got, want in zip(logits, ref_logits):
        out["logits_bitwise"].append(torch.equal(got, want))
        out["err"].append(float((got - want).abs().max() / want.abs().max()))
    # the cache after the prefill and after the last step: bitwise, or
    # within a bf16 rounding of each leaf's largest entry where the merged
    # attention fed the layers that wrote it
    last = named_leaves(ref_state["cache"])
    out["cache_bitwise"] = first.keys() == ref_first.keys() == whole.keys() and all(
        torch.equal(first[n], ref_first[n]) and torch.equal(whole[n], last[n]) for n in first)
    out["cache_close"] = all(
        bool(((a.float() - b.float()).abs() <= 2**-7 * b.float().abs().max()).all())
        for got, want in ((first, ref_first), (whole, last)) for n in want
        for a, b in [(got[n], want[n])])
    # every cache leaf is this rank's shard, no more
    shard_shapes = {n: tuple(mesh.shard(x, s_).shape) for (n, x), s_ in zip(
        named_leaves(art.state_sds["cache"]).items(),
        named_leaves_specs(art.state_specs["cache"]))}
    out["cache_shapes_ok"] = all(
        tuple(x.shape) == shard_shapes[n] for n, x in named_leaves(state["cache"]).items())
    if "enc_out" in state:
        out["cache_shapes_ok"] &= tuple(state["enc_out"].shape) == tuple(
            mesh.shard(art.state_sds["enc_out"], art.state_specs["enc_out"]).shape)
    # what comm counted: the parameters' gathers and the splits' own
    # collectives, by formulas of their shapes; the cache moves nowhere
    b_loc = logits[0].shape[0]
    out["counts_ok"] = []
    for call, got in enumerate(counted):
        s = prompt if call == 0 else 1
        want = _param_gather_bytes(art, mesh, bundle, call == 0)
        n_patches = batch["patch_embeds"].shape[1] if call == 0 and "patch_embeds" in batch else 0
        for k, v in _split_bytes(bundle, art, mesh, s, b_loc, n_patches, call == 0).items():
            want[k] = want.get(k, 0) + v
        out["counts_ok"].append((got == want, got, want))
    return out


def named_leaves_specs(specs):
    """The leaves of a spec tree in :func:`named_leaves` order."""
    if isinstance(specs, dict):
        return [leaf for v in specs.values() for leaf in named_leaves_specs(v)]
    return [specs]


def data_model_rank(mesh, payload):
    """The (2, 2) world: every architecture at ``DECODE`` and ``LONG``."""
    torch.manual_seed(0)
    out = {}
    for arch in ARCHS:
        bundle = get_arch(arch, reduced=True)
        out[arch, "decode"] = _check_rank(bundle, DECODE, PROMPT, mesh)
        out[arch, "long"] = _check_rank(bundle, LONG, LONG_PROMPT, mesh)
    return out


def seq_rank(mesh, payload):
    """The (1, 4) world: the sequence split, the SSM heads over 4, the
    streaming path on shards, and the errors."""
    out = {"qwen2": _check_rank(get_arch("qwen2-0.5b", reduced=True),
                                ShapeSpec("serve", "decode", 64, 1), LONG_PROMPT, mesh)}
    qwen2 = get_arch("qwen2-0.5b", reduced=True)
    shape = ShapeSpec("serve", "decode", 64, 1)
    logits, *_ = _serve(qwen2, shape, *_rank_inputs(qwen2, shape, LONG_PROMPT, mesh), mesh,
                        mesh.axis_names)
    out["qwen2_logits"] = [x.numpy() for x in logits]
    out["mamba2"] = _check_rank(get_arch("mamba2-2.7b", reduced=True),
                                ShapeSpec("serve", "decode", 64, 1), LONG_PROMPT, mesh)
    # zamba2's shared block attends in place over its cache: with the
    # streaming path taken, the one-device key blocks tile shards of 16...
    layers.FLASH_THRESHOLD, layers._K_CHUNK = 16, 16
    zamba2 = get_arch("zamba2-1.2b", reduced=True)
    out["zamba2_streaming"] = _check_rank(zamba2, LONG, LONG_PROMPT, mesh)
    # ... and not shards of 18
    try:
        _serve(zamba2, ShapeSpec("long_500k", "decode", 72, 1),
               *_inputs(zamba2, LONG, LONG_PROMPT), mesh, mesh.axis_names)
    except ValueError as e:
        out["tiling_error"] = str(e)
    layers.FLASH_THRESHOLD, layers._K_CHUNK = 2048, 1024
    try:
        _serve(qwen2, ShapeSpec("long_500k", "decode", 66, 1),
               *_inputs(qwen2, LONG, LONG_PROMPT), mesh, mesh.axis_names)
    except ValueError as e:
        out["extent_error"] = str(e)
    return out


def pod_rank(mesh, payload):
    """The (2, 2, 1) world: the batch over ("pod", "data")."""
    return {arch: _check_rank(get_arch(arch, reduced=True), DECODE, PROMPT, mesh)
            for arch in ("qwen2-0.5b", "grok-1-314b")}


def _assert_case(case, name):
    computes = case["computes"]
    first = BAR if case["prefill_reads_cache"] else PREFILL_BAR
    for i, (ok, err) in enumerate(zip(case["logits_bitwise"], case["err"])):
        if computes:
            assert err <= (first if i == 0 else BAR), (name, i, err)
        else:
            assert ok, (name, i, err)
    assert case["cache_bitwise"] or (computes and case["cache_close"]), name
    assert case["cache_shapes_ok"], name
    for ok, got, want in case["counts_ok"]:
        assert ok, (name, got, want)
        assert not [k for k in got if k[0] == "all_gather" and "model" in k[1]], (name, got)


def test_all_families_serve_on_a_data_model_world(tmp_path):
    ranks = run_world(tmp_path, (2, 2), ("data", "model"), "test_torch_serve_mesh:data_model_rank")
    for r, got in enumerate(ranks):
        for arch in ARCHS:
            dec, long_ = got[arch, "decode"], got[arch, "long"]
            assert dec["batch_axes"] == ("data",) and long_["batch_axes"] is None
            # the KV heads (2 or 4 of them reduced) divide over 2; mamba2 has none
            assert dec["kv"] == (None if arch == "mamba2-2.7b" else "heads"), arch
            assert long_["kv"] == (None if arch == "mamba2-2.7b" else "seq"), arch
            _assert_case(dec, (r, arch, "decode"))
            _assert_case(long_, (r, arch, "long"))


def _jax_seq(tmp_path, tree) -> subprocess.Popen:
    """JAX's serving of reduced qwen2 on a (1, 4) mesh of forced host
    devices (the sequence split), from the port's weights ``tree``."""
    np.savez(tmp_path / "w.npz", **{"/".join(k): v for k, v in _flat(tree).items()})
    toks, _ = _inputs(get_arch("qwen2-0.5b", reduced=True), ShapeSpec("s", "decode", 64, 1),
                      LONG_PROMPT)
    np.save(tmp_path / "toks.npy", toks)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.common import ShapeSpec
        from repro.configs.registry import get_arch
        from repro.train.steps import make_serve_artifacts

        mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        b = get_arch("qwen2-0.5b", reduced=True)
        art = make_serve_artifacts(b, ShapeSpec("serve", "decode", 64, 1), mesh)
        assert art.state_specs["cache"]["sub_0"]["k"] == P(None, ("data",), "model", None, None)
        params = {{}}
        for key, v in dict(np.load({str(tmp_path / 'w.npz')!r})).items():
            node = params
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {{}})
            node[last] = jnp.asarray(v)
        params = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                              params, art.params_specs, is_leaf=lambda x: isinstance(x, P))
        toks = np.load({str(tmp_path / 'toks.npy')!r}).astype(np.int32)
        out = []
        logits, state = art.prefill_fn(params, {{"tokens": jnp.asarray(toks[:, :{LONG_PROMPT}])}})
        out.append(np.asarray(logits))
        for i in range({LONG_PROMPT}, {LONG_PROMPT + STEPS}):
            logits, state = art.decode_fn(params, state, jnp.asarray(toks[:, i:i + 1]),
                                          jnp.int32(i))
            out.append(np.asarray(logits))
        np.save({str(tmp_path / 'jax.npy')!r}, np.stack(out))
    """)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def test_sequence_split_ssm_heads_and_streaming_on_a_one_by_four_world_near_jax(tmp_path):
    bundle = get_arch("qwen2-0.5b", reduced=True)
    tree = bundle.model.params_to_numpy(
        bundle.model.init_params(torch.Generator().manual_seed(0)))
    jax_run = _jax_seq(tmp_path, tree)
    try:
        ranks = run_world(tmp_path / "world", (1, 4), ("data", "model"),
                          "test_torch_serve_mesh:seq_rank")
        out, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, out[-3000:]
    want = np.load(tmp_path / "jax.npy")
    for r, got in enumerate(ranks):
        assert got["qwen2"]["kv"] == "seq" and got["zamba2_streaming"]["kv"] == "seq"
        assert got["mamba2"]["kv"] is None
        for name in ("qwen2", "mamba2", "zamba2_streaming"):
            _assert_case(got[name], (r, name))
        # against JAX's mesh serving: the serving bar
        for call, logits in enumerate(got["qwen2_logits"]):
            err = np.abs(logits - want[call]).max() / np.abs(want[call]).max()
            assert err <= BAR, (r, call, err)
        assert "do not tile a rank's shard of 18 positions" in got["tiling_error"], got
        assert "dimension 2 of shape (2, 1, 66, 2, 16) does not divide over model (extent 4)" \
            in got["extent_error"], got


def test_pod_data_batch_axes_on_a_pod_data_model_world(tmp_path):
    ranks = run_world(tmp_path, (2, 2, 1), ("pod", "data", "model"),
                      "test_torch_serve_mesh:pod_rank")
    for r, got in enumerate(ranks):
        for arch, case in got.items():
            assert case["batch_axes"] == ("pod", "data") and case["kv"] is None
            _assert_case(case, (r, arch))
