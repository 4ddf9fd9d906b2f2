"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 -- 5:1 local:global attention pattern, 128k context.
[hf:google/gemma-3-1b-pt; verified tier: unverified]

The 5:1 pattern is per-layer data (window and rope-base arrays): five
sliding-window layers (1024, rope 10k) then one global layer (rope 1M).
62 = 10 full periods + 2 trailing local layers.
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "gemma3-27b"
FAMILY = "dense"
SKIPS = {
    "long_500k": "every 6th layer is full global attention; 500k dense-KV "
    "decode out of scope per assignment",
}

_PATTERN = (1024, 1024, 1024, 1024, 1024, 0)  # 5 local : 1 global


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=6, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=512,
            window_pattern=(8, 8, 8, 8, 8, 0), rope_theta_global=1e6,
            embed_scale=True, **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=62, d_model=5376, n_heads=32, n_kv=16,
            d_head=128, d_ff=21504, vocab=262144,
            window_pattern=_PATTERN, rope_theta=10_000.0, rope_theta_global=1e6,
            embed_scale=True,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg)
