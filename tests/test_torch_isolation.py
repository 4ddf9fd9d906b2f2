"""The port stands alone: it imports neither ``jax`` nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# `import jax`, `from jax...`, `import repro`, `from repro.core ...` -- but not
# `repro_torch`.
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)", re.M)


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = port_modules()
    assert "repro_torch.core.engine" in mods and "repro_torch.quickstart" in mods
    # The distributed engine's modules, each a copy rather than an import of
    # its JAX counterpart (partition.py included, which is pure numpy there).
    assert {"repro_torch.core.mesh", "repro_torch.core.comm", "repro_torch.core.partition",
            "repro_torch.core.dist_engine"} <= set(mods)
    # The paper's driver and the dry-run tooling, with their own copies of
    # the cost model and the byte arithmetic.
    assert {"repro_torch.mam_simulation", "repro_torch.core.cost_model",
            "repro_torch.launch.dryrun"} <= set(mods)
    # LM training: the optimizer, the slow tier, the data, the CLI and the
    # example, and the configs registered with it (the data pipeline keeps
    # its own copy of the numpy mixer).
    assert {"repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.optim.hierarchical", "repro_torch.optim.tree",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.train_lm", "repro_torch.configs.olmo_1b",
            "repro_torch.configs.gemma3_27b"} <= set(mods)
    # The six other families and their configs, each module the port's own
    # copy (the MoE layer, the SSD scan, the encoder-decoder, the VLM).
    assert {"repro_torch.models.moe", "repro_torch.models.mamba2",
            "repro_torch.models.zamba2", "repro_torch.models.whisper",
            "repro_torch.models.internvl", "repro_torch.models.jax_layout",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.configs.grok_1_314b", "repro_torch.configs.mamba2_2_7b",
            "repro_torch.configs.zamba2_1_2b", "repro_torch.configs.whisper_medium",
            "repro_torch.configs.internvl2_76b"} <= set(mods)
    # The trainer on a mesh: the spec trees (each model's, ``moe_pspecs``,
    # ``jax_layout.P``), the sharded state and steps, the slow tier's int8
    # wire, the mesh's groups over axis subsets, the in-order sum and the
    # batch's slices, each the port's own.
    assert {"repro_torch.train.steps", "repro_torch.optim.hierarchical",
            "repro_torch.optim.adamw", "repro_torch.core.mesh", "repro_torch.core.comm",
            "repro_torch.data.pipeline", "repro_torch.models.transformer",
            "repro_torch.models.layers"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_port_source_names_jax_or_repro():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)
