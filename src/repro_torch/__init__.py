"""Structure-aware brain-scale SNN simulation in PyTorch, with CUDA kernels.

A port of the JAX package ``repro`` (which stays the reference) to PyTorch on
an NVIDIA Hopper GPU. It imports neither ``jax`` nor ``repro``. Entry points
run on the GPU unless given ``device="cpu"``; on CPU tensors every kernel
runs its plain PyTorch version.
"""

from __future__ import annotations

from repro_torch.core import (
    AreaSpec,
    ConfigError,
    ConfigViolation,
    Engine,
    EngineConfig,
    MultiAreaSpec,
    Network,
    SimState,
    build_network,
    make_simulation,
    mam_benchmark_spec,
    mam_spec,
    run_windows,
)

__all__ = [
    "AreaSpec",
    "ConfigError",
    "ConfigViolation",
    "Engine",
    "EngineConfig",
    "MultiAreaSpec",
    "Network",
    "SimState",
    "build_network",
    "make_simulation",
    "mam_benchmark_spec",
    "mam_spec",
    "run_windows",
]
