"""whisper-medium [audio]: 24L (enc) + 24L (dec) d_model=1024 16H d_ff=4096
vocab=51865 -- encoder-decoder, conv frontend STUBBED (input_specs supplies
precomputed frame embeddings). [arXiv:2212.04356; verified tier: unverified]

Vocab padded 51865 -> 51872 for 16-way TP. The assigned decoder shapes
(4k/32k) exceed Whisper's physical 448-token decoder; they exercise the
backbone as assigned -- see DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import Bundle
from repro_torch.models.whisper import Whisper, WhisperConfig

ARCH_ID = "whisper-medium"
FAMILY = "audio"
SKIPS = {
    "long_500k": "enc-dec audio model; 500k-token decode not defined for the "
    "family (30 s inputs, 448-token transcripts)",
}


def make_bundle(reduced: bool = False, **overrides) -> Bundle:
    if reduced:
        cfg = WhisperConfig(
            name=ARCH_ID + "-smoke", n_enc_layers=2, n_dec_layers=2,
            d_model=64, n_heads=4, d_ff=128, vocab=512, n_frames=16,
            **overrides,
        )
    else:
        cfg = WhisperConfig(
            name=ARCH_ID, n_enc_layers=24, n_dec_layers=24, d_model=1024,
            n_heads=16, d_ff=4096, vocab=51872, n_frames=1500,
            param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots",
            **overrides,
        )

    def frames_spec(batch: int, seq: int) -> torch.Tensor:
        del seq  # encoder length is fixed by the 30 s audio window
        return torch.empty((batch, cfg.n_frames, cfg.d_model), dtype=cfg.cdtype, device="meta")

    return Bundle(
        arch_id=ARCH_ID, family=FAMILY, model=Whisper(cfg), cfg=cfg,
        extra_inputs={"frames": frames_spec},
    )
