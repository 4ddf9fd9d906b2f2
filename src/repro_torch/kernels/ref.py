"""Straight-line PyTorch oracles for the kernels (port of ``repro.kernels.ref``).

No tiling, no chunking and no code shared with the kernels or their plain
versions, so that they stay obviously correct. The tests hold the plain
versions and the kernels against them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lif_update_ref", "spike_deliver_ref"]


def lif_update_ref(
    v, i_syn, refrac, i_in, alive,
    *, p11, p21, p22, v_th, v_reset, t_ref_steps,
):
    """One exact-propagator iaf_psc_exp step, with the jitted reference's two
    FMAs computed in float64 (f32 products are exact there)."""
    p11, p21, p22, v_th, v_reset = (
        float(np.float32(x)) for x in (p11, p21, p22, v_th, v_reset))
    refractory = refrac > 0
    i_new = (i_syn.double() * p11 + i_in.double()).float()
    v_prop = (v.double() * p22 + (i_syn * p21).double()).float()
    v_new = torch.where(refractory, torch.full_like(v, v_reset), v_prop)
    spikes = (v_new >= v_th) & alive & ~refractory
    v_out = torch.where(spikes, torch.full_like(v, v_reset), v_new)
    refrac_out = torch.where(
        spikes, torch.full_like(refrac, t_ref_steps),
        torch.maximum(refrac - 1, torch.zeros_like(refrac)))
    return v_out, i_new, refrac_out, spikes


def spike_deliver_ref(spikes, src, w, delay, *, steps_lo: int, r_span: int):
    """``contrib[n, j] = sum_k w[n,k] * spikes[src[n,k]] * [delay[n,k] == steps_lo + j]``
    through a one-hot einsum (``src`` holds ids into ``spikes``)."""
    vals = w * spikes[src.long()]
    j = delay.long() - steps_lo
    onehot = (j[..., None] == torch.arange(r_span, device=j.device)).to(vals.dtype)
    return torch.einsum("nk,nkr->nr", vals, onehot)
