"""The engine factory (port of ``repro.core.factory``, single-host branch)."""

from __future__ import annotations

import torch

from repro_torch.core import connectivity as connectivity_lib
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
    device=None,
) -> Engine:
    """Build a single-host simulation engine for ``spec`` on ``device``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present; pass
    ``device="cpu"`` to run on the host. ``net=None`` builds the connectivity
    on that device (seeded by ``build_seed``, with outgoing tables exactly
    when the event backend needs them); a given ``net`` must already live
    there. A ``mesh`` (the distributed engine) is not ported yet. The
    config is validated in one shot: a bad config raises
    :class:`~repro_torch.core.engine.ConfigError` listing every broken rule.
    """
    config.check(distributed=mesh is not None)
    dev = resolve_device(device)
    if net is None:
        net = connectivity_lib.build_network(
            spec, seed=build_seed, outgoing=config.backend == "event", device=dev)
    elif net.device.type != dev.type or (
            dev.index is not None and net.device != dev):
        raise ValueError(f"net lives on {net.device}, but the engine was asked "
                         f"to run on {dev}")
    return _make_engine(net, spec, config, gids=gids)
