"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304
-- non-parametric LayerNorm. [arXiv:2402.00838; verified tier: hf]
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "olmo-1b"
FAMILY = "dense"
SKIPS = {
    "long_500k": "full attention; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv=4, d_head=16, d_ff=128, vocab=512, norm="nonparam",
            tie_embeddings=True, **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv=16,
            d_head=128, d_ff=8192, vocab=50304, norm="nonparam",
            tie_embeddings=True,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg)
