"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
-- GQA with QKV bias, tied embeddings. [arXiv:2407.10671; verified tier: hf]
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "qwen2-0.5b"
FAMILY = "dense"
SKIPS = {
    "long_500k": "full attention; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=512, qkv_bias=True,
            tie_embeddings=True, **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=24, d_model=896, n_heads=14, n_kv=2,
            d_head=64, d_ff=4864, vocab=151936, qkv_bias=True,
            tie_embeddings=True,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg)
