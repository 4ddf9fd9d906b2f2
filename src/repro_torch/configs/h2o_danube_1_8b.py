"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf -- verified tier: hf]
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.transformer import Transformer, TransformerConfig

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "dense"
SKIPS = {
    "long_500k": "SWA-trained dense transformer treated as full-attention "
    "family per assignment; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv=2, d_head=8, d_ff=128, vocab=512,
            window_pattern=(16,),  # keep the SWA code path exercised
            **overrides,
        )
    else:
        cfg = TransformerConfig(
            name=ARCH_ID, n_layers=24, d_model=2560, n_heads=32, n_kv=8,
            d_head=80, d_ff=6912, vocab=32000,
            window_pattern=(4096,),  # mistral-style sliding window
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Transformer(cfg), cfg=cfg)
