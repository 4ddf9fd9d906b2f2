"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8e top-2 on every layer. [hf:xai-org/grok-1; verified tier: unverified]

8 experts < the 16-way model axis, so experts use TP sharding (d_ff sharded
inside every expert) rather than EP -- see models/moe.py.
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "grok-1-314b"
FAMILY = "moe"
SKIPS = {
    "long_500k": "full attention; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=256, vocab=512,
            moe=MoEConfig(n_experts=4, top_k=2, d_ff=128,
                          expert_sharding="tp"),
            **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv=8,
            d_head=128, d_ff=32768, vocab=131072,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768,
                          expert_sharding="tp"),
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
    return Bundle(
        arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg,
        moment_dtype="bfloat16",
    )
