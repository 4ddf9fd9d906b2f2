"""Architecture registry: ``--arch <id>`` resolution.

The JAX package registers ten architectures; the port has the four dense
transformers so far. Asking for another raises and names the ROADMAP item
that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.common import SHAPES, Bundle, ShapeSpec

__all__ = ["ARCH_MODULES", "NOT_PORTED", "list_archs", "get_arch", "arch_skips",
           "arch_cells", "SHAPES"]

# arch id -> module name under repro_torch.configs
ARCH_MODULES: dict[str, str] = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma3-27b": "gemma3_27b",
    "olmo-1b": "olmo_1b",
    "qwen2-0.5b": "qwen2_0_5b",
}

# arch id -> the ROADMAP item (LM stack) that ports what it needs
NOT_PORTED: dict[str, str] = {
    "llama4-maverick-400b-a17b": "LM stack, MoE",
    "grok-1-314b": "LM stack, MoE",
    "zamba2-1.2b": "LM stack, mamba2 and zamba2",
    "mamba2-2.7b": "LM stack, mamba2 and zamba2",
    "whisper-medium": "LM stack, whisper",
    "internvl2-76b": "LM stack, internvl",
}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet "
            f"(ROADMAP: {NOT_PORTED[arch_id]})")
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
