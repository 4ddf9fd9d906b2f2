"""Architecture registry: ``--arch <id>`` resolution. The ten
architectures of the JAX package, in its order."""

from __future__ import annotations

import importlib

from repro_torch.configs.common import SHAPES, Bundle, ShapeSpec

__all__ = ["ARCH_MODULES", "list_archs", "get_arch", "arch_skips",
           "arch_cells", "SHAPES"]

# arch id -> module name under repro_torch.configs
ARCH_MODULES: dict[str, str] = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma3-27b": "gemma3_27b",
    "olmo-1b": "olmo_1b",
    "qwen2-0.5b": "qwen2_0_5b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "internvl2-76b": "internvl2_76b",
}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {', '.join(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch_id]}")


def get_arch(arch_id: str, reduced: bool = False, **overrides) -> Bundle:
    return _module(arch_id).make_bundle(reduced=reduced, **overrides)


def arch_skips(arch_id: str) -> dict[str, str]:
    return dict(_module(arch_id).SKIPS)


def arch_cells(arch_id: str) -> list[tuple[ShapeSpec, str | None]]:
    """All four shapes with skip reasons (None = runnable)."""
    skips = arch_skips(arch_id)
    return [(shape, skips.get(name)) for name, shape in SHAPES.items()]
