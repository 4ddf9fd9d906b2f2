"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 -- InternViT frontend STUBBED (input_specs supplies precomputed
patch embeddings), InternLM2/llama-3-70B-class language backbone.
[arXiv:2404.16821; verified tier: unverified]
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import Bundle
from repro_torch.models.internvl import InternVL, InternVLConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "internvl2-76b"
FAMILY = "vlm"
SKIPS = {
    "long_500k": "full attention backbone; 500k dense-KV decode out of scope",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        bb = TransformerConfig(
            name=ARCH_ID + "-smoke-bb", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=512, **overrides,
        )
        cfg = InternVLConfig(name=ARCH_ID + "-smoke", backbone=bb,
                             d_vit=32, n_patches=4)
    else:
        bb = TransformerConfig(
            name=ARCH_ID + "-bb", n_layers=80, d_model=8192, n_heads=64,
            n_kv=8, d_head=128, d_ff=28672, vocab=128256,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
        cfg = InternVLConfig(name=ARCH_ID, backbone=bb,
                             d_vit=1024, n_patches=256)

    def patches_spec(batch: int, seq: int) -> torch.Tensor:
        del seq
        return torch.empty((batch, cfg.n_patches, cfg.d_vit), dtype=cfg.cdtype, device="meta")

    return Bundle(
        arch_id=ARCH_ID, family=FAMILY, model=InternVL(cfg), cfg=cfg,
        extra_inputs={"patch_embeds": patches_spec},
        moment_dtype="bfloat16",
    )
