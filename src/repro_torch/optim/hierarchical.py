"""Hierarchical (two-tier) synchronization: the paper's technique applied to
training. The port of ``repro.optim.hierarchical`` on one device.

The paper synchronises its slow tier D times less often than its fast tier.
For training:

* fast tier = intra-pod data parallelism: exact gradients every step;
* slow tier = cross-pod synchronisation every D-th step: each pod runs local
  optimizer steps on its own parameter replica, and every D-th step the
  replicas are averaged across pods, optionally int8-compressed with error
  feedback (the slow tier tolerates approximation; the fast tier stays
  exact).

State keeps the JAX layout: every leaf gains a leading ``[n_pods]`` axis
(:meth:`Hierarchical.replicate`), so checkpoints cross between the packages.
The local step walks the pods in a Python loop over views of the stacked
leaves (each pod's step updates its slice in place). ``torch.func.vmap``
would hold every pod's activations at once, and it does not compose with
the ``torch.utils.checkpoint`` rematerialisation the configs ask for; the
pods share nothing within a local step, so the loop computes the same.

Compressed sync (anchor-based, int8 on the wire): every pod keeps the last
synced parameters (``anchor``, identical across pods). At a sync each pod
int8-encodes (delta + error residual) from the anchor; the receivers decode,
average and advance the anchor. On one device the pods' int8 payloads need
no transfer; :attr:`Hierarchical.wire_bytes` counts what a cross-pod sync
would move. The mesh specs (``pspecs``, the wire's sharding constraint) and
the reference's ``pod_axis``, the mesh axis they name, wait for the port's
sharded paths; on one device they are identities in the JAX package too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.optim import compress
from repro_torch.optim.tree import map_tree, named_leaves

__all__ = ["HierarchicalConfig", "Hierarchical"]


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    sync_every: int = 10        # D: slow-tier period (paper eq. (1))
    compression: str = "none"   # 'none' | 'int8' (slow tier only)

    def __post_init__(self) -> None:
        if self.compression not in ("none", "int8"):
            raise ValueError(f"unknown compression {self.compression!r}")


class Hierarchical:
    """Per-pod replica management + the two sync tiers."""

    def __init__(self, cfg: HierarchicalConfig, n_pods: int):
        self.cfg = cfg
        self.n_pods = n_pods
        self.wire_bytes = 0  # int8 payload + scales of the last compressed sync, all pods

    # -- state ----------------------------------------------------------------

    def replicate(self, tree: Any) -> Any:
        """Add the leading [n_pods] axis (same initial value in every pod),
        as new tensors."""
        return map_tree(
            lambda x: x[None].expand((self.n_pods,) + tuple(x.shape)).clone(), tree)

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
        trees and batches, pod by pod; the metrics gain the pod axis. No
        pod reads another's state: the slow tier stays silent."""
        def run(params_pods, opt_pods, batch_pods):
            metrics = []
            for p in range(self.n_pods):
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

        if self.cfg.compression == "none":
            for name, x in named.items():
                shape = (self.n_pods,) + (1,) * (x.dim() - 1)
                m = (x.float() * wts.reshape(shape)).sum(dim=0)
                x.copy_(m[None].expand(x.shape))
                anchor[name].copy_(m)
            return params_pods, {"anchor": anchor}

        ef, wire = sync_state["ef"], 0
        for name, x in named.items():
            delta = x.float() - anchor[name].float()[None]
            y = delta + ef[name]
            q, scale = zip(*(compress.int8_encode(y[p]) for p in range(self.n_pods)))
            q, scale = torch.stack(q), torch.stack(scale)       # [P, ...] int8, [P]
            wire += q.numel() + 4 * scale.numel()
            shape = (self.n_pods,) + (1,) * (q.dim() - 1)
            dec = q.float() * scale.reshape(shape)
            new_anchor = anchor[name].float() + (dec * wts.reshape(shape)).sum(dim=0)
            ef[name].copy_(compress.int8_residual(y, q, scale.reshape(shape)))
            x.copy_(new_anchor[None].expand(x.shape))
            anchor[name].copy_(new_anchor)
        self.wire_bytes = wire
        return params_pods, {"anchor": anchor, "ef": ef}
