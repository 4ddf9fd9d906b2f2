"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality). [arXiv:2405.21060; unverified]

Vocab padded 50280 -> 50304 for even 16-way TP sharding (50280 % 16 != 0);
the pad rows are inert. O(1) decode state means ``long_500k`` runs here.
"""

from __future__ import annotations

from repro_torch.configs.common import Bundle
from repro_torch.models.mamba2 import Mamba2, Mamba2Config

ARCH_ID = "mamba2-2.7b"
FAMILY = "ssm"
SKIPS: dict[str, str] = {}  # sub-quadratic: all four shapes run


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = Mamba2Config(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, vocab=512,
            d_state=16, headdim=16, chunk=8, **overrides,
        )
    else:
        cfg = Mamba2Config(
            name=ARCH_ID, n_layers=64, d_model=2560, vocab=50304,
            d_state=128, headdim=64, chunk=256,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
            **overrides,
        )
    return Bundle(arch_id=ARCH_ID, family=FAMILY, model=Mamba2(cfg), cfg=cfg)
