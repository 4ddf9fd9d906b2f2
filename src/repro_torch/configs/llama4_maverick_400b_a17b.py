"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1 -- interleaved dense/MoE layers (every 2nd layer
routed), shared expert always on, early-fusion multimodal (text path here).
[hf:meta-llama/Llama-4-Scout-17B-16E; verified tier: unverified]

Parameter audit with this config: ~399B total, ~17.7B active per token
(cfg.param_count()/active_param_count()), matching the 400B-A17B designation.
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "llama4-maverick-400b-a17b"
FAMILY = "moe"
SKIPS = {
    "long_500k": "full/chunked attention; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=512,
            moe=MoEConfig(n_experts=4, top_k=1, d_ff=128,
                          shared_expert=True, interleave=2),
            **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv=8,
            d_head=128, d_ff=8192, vocab=202048,
            moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192,
                          shared_expert=True, interleave=2,
                          expert_sharding="ep"),
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
    return Bundle(
        arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg,
        moment_dtype="bfloat16",
    )
