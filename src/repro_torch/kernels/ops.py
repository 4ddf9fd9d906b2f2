"""Public wrappers around the kernels, dispatching on the tensors' device.

Port of ``repro.kernels.ops`` (``lif_update``, ``spike_deliver``,
``apply_contrib``, ``superstep_lif``, ``superstep_iaf``) and of the call of
``flash_attention_pallas`` in ``repro.models.layers``. A tensor on the
CPU goes to the kernel's plain PyTorch version, a CUDA tensor to the CUDA
kernel, and any other device raises: there is no silent fallback from the
kernel to the plain version. Unlike the JAX wrappers these pad nothing and
do not widen int8 delays: the kernels mask their own ragged edge and read
int8 as stored.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cycle as _cyc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lif_update as _lif
from repro_torch.kernels import spike_deliver as _dlv

__all__ = [
    "lif_update", "spike_deliver", "apply_contrib", "superstep_lif", "superstep_iaf",
    "flash_attention",
]


def _pick(x: torch.Tensor, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"no kernel for device {x.device} (expected cpu or cuda)")


def lif_update(
    v, i_syn, refrac, i_in, alive,
    *, p11, p21, p22, v_th, v_reset, t_ref_steps,
):
    """Fused LIF step over state of any shape; see :mod:`.lif_update`."""
    fn = _pick(v, _lif.lif_update_plain, _lif.lif_update_cuda)
    return fn(v, i_syn, refrac, i_in, alive, p11=p11, p21=p21, p22=p22,
              v_th=v_th, v_reset=v_reset, t_ref_steps=t_ref_steps)


def spike_deliver(
    spikes, src, w, delay, *, steps_lo: int, r_span: int,
    rows_per_area: int | None = None, src_stride: int = 0,
):
    """Delay-resolved contributions ``[N, r_span]``; see :mod:`.spike_deliver`."""
    fn = _pick(src, _dlv.spike_deliver_plain, _dlv.spike_deliver_cuda)
    return fn(spikes, src, w, delay, steps_lo=steps_lo, r_span=r_span,
              rows_per_area=rows_per_area, src_stride=src_stride)


def apply_contrib(
    ring: torch.Tensor,     # [N, R], updated in place
    contrib: torch.Tensor,  # [N, r_span]
    t: int,
    steps_lo: int,
) -> torch.Tensor:
    """Add delay-resolved contributions into ring slots ``(t+steps_lo+j) % R``.

    In place (the ring is the engine's largest state array); returns ``ring``.
    """
    r = ring.shape[-1]
    slots = torch.remainder(
        t + steps_lo + torch.arange(contrib.shape[-1], device=ring.device), r)
    return ring.index_add_(1, slots, contrib)


def superstep_lif(
    v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
    *, d_win: int, steps_lo: int, r_span: int,
    p11, p21, p22, v_th, v_reset, t_ref_steps, seed, w_ext,
):
    """Fused LIF D-cycle window over ``[A, n]`` state; see :mod:`.cycle`.

    Returns ``(v, i_syn, refrac, fut, spikes)`` with the spikes in the
    engine's block layout ``[D, A, n]`` bool (the JAX wrapper returns
    ``[A, D, n]`` int8). ``fut`` is updated in place.
    """
    fn = _pick(v, _cyc.superstep_lif_plain, _cyc.superstep_lif_cuda)
    return fn(v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
              d_win=d_win, steps_lo=steps_lo, r_span=r_span, p11=p11, p21=p21,
              p22=p22, v_th=v_th, v_reset=v_reset, t_ref_steps=t_ref_steps,
              seed=seed, w_ext=w_ext)


def superstep_iaf(
    countdown, fut, interval, alive, src, w, delay,
    *, d_win: int, steps_lo: int, r_span: int,
):
    """Fused ignore-and-fire window; returns ``(countdown, fut, spikes)``
    with the spikes as ``[D, A, n]`` bool. See :func:`superstep_lif`."""
    fn = _pick(countdown, _cyc.superstep_iaf_plain, _cyc.superstep_iaf_cuda)
    return fn(countdown, fut, interval, alive, src, w, delay,
              d_win=d_win, steps_lo=steps_lo, r_span=r_span)


def flash_attention(q, k, v, window, k_len):
    """Causal (optionally windowed) GQA attention ``[B, Sq, H, Dh]`` over
    k, v ``[B, Sk, Hkv, Dh]``; see :mod:`.flash_attention`."""
    fn = _pick(q, _fa.flash_attention_plain, _fa.flash_attention_cuda)
    return fn(q, k, v, window, k_len)
