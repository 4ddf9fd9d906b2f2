"""Fused LIF (iaf_psc_exp) state update: the CUDA kernel and its plain version.

Port of ``repro.kernels.lif_update``. The kernel (``csrc/lif_update.cu``)
makes one pass over flat ``[N]`` state, four neurons a thread with 16-byte
accesses, no padding; a ragged tail, or inputs not aligned for the wide
accesses, take its scalar path (the wrapper refuses neither).

Exactness: the jitted JAX reference computes the propagator as exactly two
fused multiply-adds, ``i' = fma(i, p11, i_in)`` and
``v' = fma(v, p22, round_f32(i * p21))``. Plain f32 arithmetic differs in
many lanes, so the kernel spells out these two FMAs and the plain version
emulates them in float64: the product of two f32 values is exact in f64, and
one f64 add then one rounding to f32 equals the FMA except at a rare
double-rounding tie.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import cuda

__all__ = ["f32", "lif_update_plain", "lif_update_cuda", "lif_update_meta", "allocations"]


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a weakly typed Python float."""
    return float(np.float32(x))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, c)`` in f32 for f32 ``a``, ``c`` and f32-exact ``b``."""
    return (a.double() * b + c.double()).float()


def lif_update_plain(
    v, i_syn, refrac, i_in, alive,
    *, p11: float, p21: float, p22: float,
    v_th: float, v_reset: float, t_ref_steps: int,
):
    """One exact-propagator LIF step in plain PyTorch (any shape, any device).

    ``alive`` is bool; returns ``(v', i_syn', refrac', spikes bool)``.
    """
    p11, p21, p22 = f32(p11), f32(p21), f32(p22)
    v_th, v_reset = f32(v_th), f32(v_reset)
    refractory = refrac > 0
    i_new = _fma(i_syn, p11, i_in)
    v_prop = _fma(v, p22, i_syn * p21)
    v_new = torch.where(refractory, v_reset, v_prop)
    spikes = (v_new >= v_th) & alive & ~refractory
    v_out = torch.where(spikes, v_reset, v_new)
    refrac_out = torch.where(
        spikes, t_ref_steps, torch.clamp(refrac - 1, min=0)).to(torch.int32)
    return v_out, i_new, refrac_out, spikes


def allocations(v, i_syn, refrac, alive) -> tuple[torch.Tensor, ...]:
    """What the kernel's wrapper allocates for a launch: the new ``(v',
    i_syn', refrac', spikes)``, on the inputs' device."""
    return (torch.empty_like(v), torch.empty_like(i_syn), torch.empty_like(refrac),
            torch.empty_like(alive))


def lif_update_meta(v, i_syn, refrac, i_in, alive, **params):
    """A launch priced on ``meta`` tensors: the kernel's :func:`allocations`,
    no arithmetic."""
    return allocations(v, i_syn, refrac, alive)


def lif_update_cuda(
    v, i_syn, refrac, i_in, alive,
    *, p11: float, p21: float, p22: float,
    v_th: float, v_reset: float, t_ref_steps: int,
):
    """Launch the CUDA kernel on contiguous CUDA tensors of one shape.

    ``v``, ``i_syn``, ``i_in`` f32, ``refrac`` int32, ``alive`` bool. Returns
    new tensors ``(v', i_syn', refrac', spikes bool)`` of the same shape.
    """
    args = (v, i_syn, refrac, i_in, alive)
    dtypes = (torch.float32, torch.float32, torch.int32, torch.float32, torch.bool)
    for name, x, dt in zip(("v", "i_syn", "refrac", "i_in", "alive"), args, dtypes):
        if not x.is_cuda or x.dtype != dt or x.shape != v.shape or not x.is_contiguous():
            raise ValueError(
                f"lif_update kernel: {name} must be a contiguous CUDA {dt} "
                f"tensor of shape {tuple(v.shape)}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    lib = cuda.library("lif_update")
    v_o, i_o, r_o, s_o = allocations(v, i_syn, refrac, alive)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.lif_update_launch(
            v.data_ptr(), i_syn.data_ptr(), refrac.data_ptr(), i_in.data_ptr(),
            alive.data_ptr(), v_o.data_ptr(), i_o.data_ptr(), r_o.data_ptr(),
            s_o.data_ptr(), v.numel(), f32(p11), f32(p21), f32(p22),
            f32(v_th), f32(v_reset), int(t_ref_steps), stream)
    cuda.check("lif_update", err)
    cuda.launches["lif_update"] += 1
    return v_o, i_o, r_o, s_o
