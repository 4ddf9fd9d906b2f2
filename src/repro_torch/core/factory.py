"""The engine factory (port of ``repro.core.factory``): no mesh means the
single-host engine (:mod:`repro_torch.core.engine`), a mesh the distributed
one (:mod:`repro_torch.core.dist_engine`)."""

from __future__ import annotations

import torch

from repro_torch.core import connectivity as connectivity_lib
from repro_torch.core import dist_engine as dist_engine_lib
from repro_torch.core.areas import MultiAreaSpec
from repro_torch.core.connectivity import Network
from repro_torch.core.engine import Engine, EngineConfig, _make_engine
from repro_torch.device import resolve_device

__all__ = ["make_simulation"]


def make_simulation(
    spec: MultiAreaSpec,
    config: EngineConfig = EngineConfig(),
    *,
    net: Network | None = None,
    mesh=None,
    build_seed: int = 12,
    gids: torch.Tensor | None = None,
    trial_leaves: bool = False,
    device=None,
) -> Engine:
    """Build a simulation engine for ``spec``, dispatching on ``mesh``.

    * ``mesh=None``: the single-host engine on ``device`` (default
      ``"cuda"``, which raises when no GPU is present; ``device="cpu"`` runs
      on the host). ``net=None`` builds the connectivity there (seeded by
      ``build_seed``, with outgoing tables exactly when the event backend
      needs them); a given ``net`` must already live there.
    * ``mesh=`` a :class:`~repro_torch.core.mesh.ProcessMesh`: this rank's
      distributed engine on ``mesh.device`` (``device`` is not used). Every
      rank passes the same global ``net`` (on its device), or ``net=None``
      with ``config.sharded_build`` for the host-free build.
      ``trial_leaves`` makes its state carry per-neuron ``seed`` / ``stim``
      leaves; the single-host engine takes them in ``init`` directly.

    The config is validated against the target in one shot: a bad config
    raises :class:`~repro_torch.core.engine.ConfigError` listing every
    broken rule.
    """
    config.check(distributed=mesh is not None)
    if mesh is not None:
        return dist_engine_lib._make_dist_engine(
            net, spec, mesh, config, build_seed=build_seed, gids=gids,
            trial_leaves=trial_leaves)
    if trial_leaves:
        raise ValueError(
            "trial_leaves sizes the distributed engine's shard_map state "
            "specs; the single-host engine takes per-trial seed/stim "
            "directly via engine.init(seed=..., stim=...)")
    dev = resolve_device(device)
    if net is None:
        net = connectivity_lib.build_network(
            spec, seed=build_seed, outgoing=config.backend == "event", device=dev)
    elif net.device.type != dev.type or (
            dev.index is not None and net.device != dev):
        raise ValueError(f"net lives on {net.device}, but the engine was asked "
                         f"to run on {dev}")
    return _make_engine(net, spec, config, gids=gids)
