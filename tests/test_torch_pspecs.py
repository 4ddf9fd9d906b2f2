"""The port's sharding specs against the JAX package's, with no process group.

Every spec tree of the ten architectures, reduced and as published, equals
the JAX tree leaf by leaf with each ``PartitionSpec`` read as a tuple
(``tuple(P(...))``): ``param_pspecs`` with ``fsdp`` ``"data"`` and None,
``cache_pspecs`` under the batch, sequence and head choices
``make_serve_artifacts`` makes, ``moe_pspecs`` with ``"ep"`` and ``"tp"``,
``_attn_pspecs``, ``Hierarchical.pspecs`` and ``make_train_artifacts``'
params, opt, batch and sync specs in both modes. The port's per-layer
leaves take the stacked spec without its stack axis. A dimension that its
axes' extent does not divide raises ``ValueError`` naming the leaf, the
dimension and the extent (a mesh's positions without a world).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.common import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import list_archs
from repro.models.moe import MoEConfig as JMoEConfig
from repro.models.moe import moe_pspecs as jmoe_pspecs
from repro.optim.hierarchical import Hierarchical as JHierarchical
from repro.optim.hierarchical import HierarchicalConfig as JHierarchicalConfig
from repro.train.steps import make_train_artifacts as jmake_train_artifacts
from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.core.mesh import ProcessMesh
from repro_torch.models.jax_layout import P
from repro_torch.models.moe import MoEConfig, moe_pspecs
from repro_torch.optim.hierarchical import Hierarchical, HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts, shard_state

ARCHS = list_archs()
# (batch_axes, seq_axis, head_axis) as make_serve_artifacts chooses them:
# no mesh; the batch over the DP axes with KV heads or the sequence over TP
# (or neither at TP 1); the long-context cell's sequence over TP.
CACHE_CHOICES = [
    (None, None, None),
    (("data",), None, None), (("data",), None, "model"), (("data",), "model", None),
    (("pod", "data"), None, "model"), (("pod", "data"), "model", None),
    (None, "model", None),
]


def as_tuples(tree):
    """A JAX spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, JP):
        return tuple(tree)
    if isinstance(tree, tuple):
        return tuple(as_tuples(x) for x in tree)
    return tree


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_pspecs_match_jax(arch, reduced):
    jb, pb = jget_arch(arch, reduced=reduced), get_arch(arch, reduced=reduced)
    for fsdp in ("data", None):
        want = as_tuples(jb.model.param_pspecs(fsdp=fsdp))
        got = pb.model.param_pspecs(fsdp=fsdp)
        assert got == want, fsdp
        # each of the port's leaves: the JAX leaf's spec, its stack axis
        # dropped; one entry at most a dimension of the leaf
        named = pb.model.named_pspecs(got)
        meta = dict(pb.model.init_params(None, device="meta").named_parameters())
        assert named.keys() == meta.keys()
        assert all(len(named[n]) <= x.dim() for n, x in meta.items())
    for batch_axes, seq, head in CACHE_CHOICES:
        want = as_tuples(jb.model.cache_pspecs(batch_axes=batch_axes, seq_axis=seq,
                                               head_axis=head))
        assert pb.model.cache_pspecs(batch_axes=batch_axes, seq_axis=seq,
                                     head_axis=head) == want, (batch_axes, seq, head)


@pytest.mark.parametrize("sharding", ["ep", "tp"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_pspecs_match_jax(sharding, shared):
    for fsdp in ("data", None):
        want = jmoe_pspecs(JMoEConfig(8, 2, 32, shared_expert=shared, expert_sharding=sharding),
                           fsdp, "model")
        got = moe_pspecs(MoEConfig(8, 2, 32, shared_expert=shared, expert_sharding=sharding),
                         fsdp, "model")
        assert got == as_tuples(want)


@pytest.mark.parametrize("pins", [(None, None), (("data",), "heads"), (("pod", "data"), "heads"),
                                  (("data",), "seq"), (("pod", "data"), "seq"),
                                  (("data",), None)])
def test_attn_pspecs_match_jax(pins):
    """``_attn_pspecs`` is returned for parity: the port pins nothing."""
    batch_axes, attn = pins
    jb, pb = jget_arch("qwen2-0.5b", reduced=True), get_arch("qwen2-0.5b", reduced=True)
    jm = type(jb.model)(dataclasses.replace(jb.cfg, act_batch_axes=batch_axes,
                                            attn_sharding=attn))
    pm = type(pb.model)(dataclasses.replace(pb.cfg, act_batch_axes=batch_axes,
                                            attn_sharding=attn))
    assert pm._attn_pspecs() == as_tuples(jm._attn_pspecs())


def test_hierarchical_pspecs_and_config_match_jax():
    assert [f.name for f in dataclasses.fields(HierarchicalConfig)] == \
        [f.name for f in dataclasses.fields(JHierarchicalConfig)]
    for arch in ("qwen2-0.5b", "whisper-medium"):
        jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
        for pod in ("pod", "replica"):
            want = JHierarchical(JHierarchicalConfig(pod_axis=pod), 2).pspecs(
                jb.model.param_pspecs())
            got = Hierarchical(HierarchicalConfig(pod_axis=pod), 2).pspecs(
                pb.model.param_pspecs())
            assert got == as_tuples(want), (arch, pod)


@pytest.mark.parametrize("mode", ["sync", "hierarchical"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_artifact_specs_match_jax(arch, mode):
    """params, opt, batch and sync specs, and ``batch_sds``' shapes, for
    the batch and FSDP choices the trainers use."""
    jb, pb = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    for batch_axes, fsdp in ((("data",), "data"), (("pod", "data"), None)):
        if mode == "hierarchical" and "pod" in batch_axes:
            continue
        kw = dict(batch_axes=batch_axes, fsdp_axis=fsdp)
        jh = JHierarchicalConfig(compression="int8") if mode == "hierarchical" else None
        ph = HierarchicalConfig(compression="int8") if mode == "hierarchical" else None
        jart = jmake_train_artifacts(jb, mesh=None, hier_cfg=jh, **kw)
        art = make_train_artifacts(pb, hier_cfg=ph, **kw)
        for part in ("params_specs", "opt_specs", "batch_specs", "sync_specs"):
            assert getattr(art, part) == as_tuples(getattr(jart, part)), part
        want = jart.batch_sds(jb, JShapeSpec("t", "train", 16, 8), None)
        got = art.batch_sds(pb, ShapeSpec("t", "train", 16, 8), None)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def _positions(shape, names, coords) -> ProcessMesh:
    """A mesh's positions and extents without a world: what ``block`` and
    ``shard`` read."""
    mesh = ProcessMesh.__new__(ProcessMesh)
    mesh.axis_names = tuple(names)
    mesh.shape = dict(zip(names, shape))
    mesh.coords = dict(zip(names, coords))
    return mesh


def test_shards_and_the_error_for_an_extent_that_does_not_divide():
    mesh = _positions((2, 2, 2), ("pod", "data", "model"), (1, 0, 1))
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    assert mesh.block(("pod", "data")) == (2, 4) and mesh.block(None) == (0, 1)
    assert torch.equal(mesh.shard(x, (("pod", "data"), "model")), x[2:3, 3:6])
    assert np.array_equal(mesh.shard(x.numpy(), (None, None, None)), x.numpy())
    with pytest.raises(ValueError, match=r"layers/w: dimension 2 of shape \(4, 6, 3\) does not "
                                         r"divide over model \(extent 2\)"):
        shard_state({"layers": {"w": x}}, {"layers": {"w": P(None, None, "model")}}, mesh)
    with pytest.raises(ValueError, match="more entries"):
        mesh.shard(x, (None,) * 4)
    # every leaf of a reduced architecture divides over a (2, 2, 2) mesh
    pb = get_arch("grok-1-314b", reduced=True)
    specs = Hierarchical(HierarchicalConfig(), 2).pspecs(pb.model.param_pspecs())
    named = pb.model.named_pspecs(specs, lead=1)
    for n, x in named_leaves(Hierarchical(HierarchicalConfig(), 2).replicate(
            pb.model.init_params(None, device="meta"))).items():
        got = mesh.shard(x, named[n], n)
        assert got.numel() * np.prod([mesh.block(a)[1] for a in named[n]]) == x.numel()
