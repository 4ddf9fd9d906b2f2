"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 -- Mamba2 backbone + shared attention block.
[arXiv:2411.15242; verified tier: hf]

38 = 6 applications x 6-layer period + 2 trailing mamba layers. The shared
block's KV cache is small (one block, 6 application points), so ``long_500k``
runs (sequence axis of the shared-block cache shards over the model axis).
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.zamba2 import Zamba2, Zamba2Config

ARCH_ID = "zamba2-1.2b"
FAMILY = "hybrid"
SKIPS: dict[str, str] = {}  # hybrid with O(1) mamba state: all shapes run


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = Zamba2Config(
            name=ARCH_ID + "-smoke", n_layers=8, d_model=64, vocab=512,
            n_heads=4, n_kv=4, d_head=16, d_ff=128, period=3,
            d_state=16, headdim=16, chunk=8, **overrides,
        )
    else:
        cfg = Zamba2Config(
            name=ARCH_ID, n_layers=38, d_model=2048, vocab=32000,
            n_heads=32, n_kv=32, d_head=64, d_ff=8192, period=6,
            d_state=64, headdim=64, chunk=256,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Zamba2(cfg), cfg=cfg)
