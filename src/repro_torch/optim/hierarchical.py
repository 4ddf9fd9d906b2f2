"""Hierarchical (two-tier) synchronization: the paper's technique applied to
training. The port of ``repro.optim.hierarchical``.

The paper synchronises its slow tier D times less often than its fast tier.
For training on a ``(pod, data, model)`` mesh:

* fast tier = intra-pod data parallelism: exact gradients every step,
  summed over the pod's batch axes;
* slow tier = cross-pod synchronisation every D-th step: each pod runs local
  optimizer steps on its own parameter replica, and every D-th step the
  replicas are averaged across pods, optionally int8-compressed with error
  feedback (the slow tier tolerates approximation; the fast tier stays
  exact).

State keeps the JAX layout: every leaf gains a leading ``[n_pods]`` axis
(:meth:`Hierarchical.replicate`), whose spec is the pod axis
(:meth:`Hierarchical.pspecs`), so checkpoints cross between the packages.
On one device the local step walks the pods in a Python loop over views of
the stacked leaves (each pod's step updates its slice in place).
``torch.func.vmap`` would hold every pod's activations at once, and it does
not compose with the ``torch.utils.checkpoint`` rematerialisation the
configs ask for; the pods share nothing within a local step, so the loop
computes the same. On a mesh (a :class:`~repro_torch.core.mesh.ProcessMesh`
with the pod axis) a rank holds only its pod's block (a leading extent of
1) and steps that pod: no local step sends anything over the pod axis.

Compressed sync (anchor-based, int8 on the wire): every pod keeps the last
synced parameters (``anchor``, identical across pods). At a sync each pod
int8-encodes (delta + error residual) from the anchor, with one scale for
each whole leaf; the receivers decode, average and advance the anchor. On
one device the pods' payloads need no transfer and
:attr:`Hierarchical.wire_bytes` counts what a cross-pod sync would move. On
a mesh each rank encodes its shard: a max all-reduce over the pod's other
axes first makes its scale the whole leaf's, as the one-device encode
computes it; then the int8 shards and the scales cross the pod axis in one
all-gather, and ``wire_bytes`` is what this rank took in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import comm
from repro_torch.models.jax_layout import P
from repro_torch.optim import compress
from repro_torch.optim.tree import map_tree, named_leaves

__all__ = ["HierarchicalConfig", "Hierarchical"]


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    sync_every: int = 10        # D: slow-tier period (paper eq. (1))
    pod_axis: str = "pod"
    compression: str = "none"   # 'none' | 'int8' (slow tier only)

    def __post_init__(self) -> None:
        if self.compression not in ("none", "int8"):
            raise ValueError(f"unknown compression {self.compression!r}")


class Hierarchical:
    """Per-pod replica management + the two sync tiers. ``param_specs``
    (the spec tree without the pod axis) is kept for parity with the
    reference; each rank's shards carry their layout in their shapes."""

    def __init__(self, cfg: HierarchicalConfig, n_pods: int, mesh=None,
                 param_specs: Any = None):
        if mesh is not None and mesh.shape.get(cfg.pod_axis) != n_pods:
            raise ValueError(f"{n_pods} pods on a mesh of {mesh.shape}: the pod axis "
                             f"{cfg.pod_axis!r} must have that extent")
        self.cfg = cfg
        self.n_pods = n_pods
        self.mesh = mesh
        self.param_specs = param_specs
        # The last compressed sync's int8 payload and scales: all pods' on
        # one device, what this rank took in over the pod axis on a mesh.
        self.wire_bytes = 0

    # -- state ----------------------------------------------------------------

    def replicate(self, tree: Any) -> Any:
        """Add the leading [n_pods] axis (same initial value in every pod),
        as new tensors."""
        return map_tree(
            lambda x: x[None].expand((self.n_pods,) + tuple(x.shape)).clone(), tree)

    def pspecs(self, tree_specs: Any) -> Any:
        """Every leaf spec of ``tree_specs`` with the pod axis in front."""
        if isinstance(tree_specs, dict):
            return {k: self.pspecs(v) for k, v in tree_specs.items()}
        return P(self.cfg.pod_axis, *tree_specs)

    def init_sync_state(self, params: Any) -> dict:
        """``anchor``: the last synced params (no pod axis, a copy);
        ``ef``: per-pod f32 residuals (int8 only). Keyed by leaf name."""
        named = named_leaves(params)
        state = {"anchor": {n: x.detach().clone() for n, x in named.items()}}
        if self.cfg.compression != "none":
            state["ef"] = {n: torch.zeros((self.n_pods,) + tuple(x.shape),
                                          dtype=torch.float32, device=x.device)
                           for n, x in named.items()}
        return state

    def pod(self, tree: Any, p: int) -> Any:
        """Pod ``p``'s slice of a replicated tree, as views: a module's
        parameters are trainable views, so a step on them updates the
        stacked leaves in place."""
        return map_tree(lambda x: x[p], tree, requires_grad=True)

    # -- steps ----------------------------------------------------------------

    def local_step(self, step_fn: Callable) -> Callable:
        """``step_fn(params, opt_state, batch) -> (params', opt_state',
        metrics)`` over one pod becomes the same over ``[n_pods, ...]``
        trees and batches, pod by pod (on a mesh: this rank's pod, a
        leading extent of 1); the metrics gain the pod axis. No pod reads
        another's state: the slow tier stays silent."""
        local_pods = 1 if self.mesh is not None else self.n_pods

        def run(params_pods, opt_pods, batch_pods):
            metrics = []
            for p in range(local_pods):
                _, _, m = step_fn(self.pod(params_pods, p), self.pod(opt_pods, p),
                                  {k: v[p] for k, v in batch_pods.items()})
                metrics.append(m)
            return params_pods, opt_pods, {k: torch.stack([m[k] for m in metrics])
                                           for k in metrics[0]}
        return run

    @torch.no_grad()
    def sync_step(self, params_pods: Any, sync_state: dict,
                  live: torch.Tensor | None = None) -> tuple[Any, dict]:
        """Slow tier: average replicas across pods (every D-th step), in
        place. ``live`` ([n_pods] bool) drops straggling or failed pods from
        the average; a dropped pod re-joins with the averaged parameters."""
        named = named_leaves(params_pods)
        dev = next(iter(named.values())).device
        if live is None:
            live = torch.ones((self.n_pods,), dtype=torch.bool, device=dev)
        wts = live.float()
        wts = wts / torch.clamp(wts.sum(), min=1.0)
        anchor = sync_state["anchor"]
        pod = self.cfg.pod_axis

        if self.cfg.compression == "none":
            for name, x in named.items():
                shape = (self.n_pods,) + (1,) * (x.dim() - 1)
                pods = x if self.mesh is None else comm.all_gather(x, self.mesh, pod, dim=0)
                m = (pods.float() * wts.reshape(shape)).sum(dim=0)
                x.copy_(m[None].expand(x.shape))
                anchor[name].copy_(m)
            return params_pods, {"anchor": anchor}

        ef, wire = sync_state["ef"], 0
        if self.mesh is not None:
            ys, coded = self._exchange(named, anchor, ef)
        for name, x in named.items():
            if self.mesh is None:
                y = x.float() - anchor[name].float()[None] + ef[name]
                q, scale = zip(*(compress.int8_encode(y[p]) for p in range(self.n_pods)))
                q, scale = torch.stack(q), torch.stack(scale)       # [P, ...] int8, [P]
                wire += q.numel() + 4 * scale.numel()
                own_q, own_scale = q, scale
            else:
                y, (q, scale) = ys.pop(name), coded.pop(name)
                p = self.mesh.axis_index(pod)
                own_q, own_scale = q[p:p + 1], scale[p:p + 1]
            shape = (self.n_pods,) + (1,) * (q.dim() - 1)
            dec = q.float() * scale.reshape(shape)
            new_anchor = anchor[name].float() + (dec * wts.reshape(shape)).sum(dim=0)
            ef[name].copy_(compress.int8_residual(y, own_q, own_scale.reshape(
                (-1,) + shape[1:])))
            x.copy_(new_anchor[None].expand(x.shape))
            anchor[name].copy_(new_anchor)
        if self.mesh is None:
            self.wire_bytes = wire
        return params_pods, {"anchor": anchor, "ef": ef}

    def _exchange(self, named: dict, anchor: dict, ef: dict) -> tuple[dict, dict]:
        """This rank's ``y = delta + ef`` for each leaf (its pod's block, a
        leading extent of 1), int8-encoded with the whole leaf's scale and
        sent over the pod axis: ``(ys, coded)``, ``coded`` every pod's
        ``(q [P, ...], scale [P])`` for each leaf."""
        mesh, pod = self.mesh, self.cfg.pod_axis
        names = list(named)
        ys = {n: named[n].float() - anchor[n].float()[None] + ef[n] for n in names}
        amax = torch.stack([torch.max(torch.abs(ys[n])) for n in names])
        inner = tuple(a for a in mesh.axis_names if a != pod)
        if inner and mesh.extent(inner) > 1:
            amax = comm.all_reduce(amax, mesh, inner, op="max")
        scales = torch.clamp(amax * (1.0 / 127.0), min=1e-12)  # int8_encode's scale
        qs = [torch.clamp(torch.round(ys[n] / scales[i]), -127, 127).to(torch.int8)
              for i, n in enumerate(names)]
        payload = torch.cat([q.reshape(-1) for q in qs] + [scales.view(torch.int8)])
        before = comm.received[("all_gather", (pod,))]
        got = comm.all_gather(payload, mesh, pod, dim=0).reshape(self.n_pods, -1)
        self.wire_bytes = comm.received[("all_gather", (pod,))] - before
        all_scales = got[:, payload.numel() - 4 * len(names):].contiguous().view(torch.float32)
        coded, off = {}, 0
        for i, (n, q) in enumerate(zip(names, qs)):
            k = q.numel()
            coded[n] = (got[:, off:off + k].reshape((self.n_pods,) + tuple(q.shape[1:])),
                        all_scales[:, i])
            off += k
        return ys, coded
