"""The fused D-cycle superstep: the CUDA kernels and their plain versions.

Port of ``repro.kernels.cycle``. One call advances a whole structure-aware
window of ``D`` cycles. Cycle ``s`` takes the neuron update on the live
window buffer's column ``fut[..., s]`` (LIF with the counter-based Poisson
drive, or ignore-and-fire) and deposits the cycle's spikes through the intra
tables at columns ``s + delay`` of ``fut``; delays outside ``[steps_lo,
steps_lo + r_span)`` add nothing. The result is bitwise the unfused window's:
the same LIF step and drive, and weights on the 1/256 grid, so every sum is
exact in any order.

Layouts: state ``[A, n]``; tables ``[A, n, K]`` with sources indexed within
their area; ``fut [A, n, W]`` with ``W >= D + steps_lo + r_span - 1``. The
spikes come back in the engine's block layout ``[D, A, n]`` bool (the JAX
kernels return ``[A, D, n]`` int8). ``fut`` is updated in place and returned:
it is the engine's scratch for one window. Unlike the JAX wrappers these pad
nothing, and they read int8 delays as stored.

The CUDA kernels are ``csrc/superstep_lif.cu`` (one cooperative launch, one
grid barrier per cycle) and ``csrc/superstep_iaf.cu`` (all spikes first, then
one pass over ``src`` for the whole window, the hits queued and served 32 at
a time); their sources say how.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.lif_update import f32, lif_update_plain
from repro_torch.kernels.spike_deliver import spike_deliver_plain

__all__ = [
    "counter_uniform",
    "superstep_lif_plain",
    "superstep_lif_cuda",
    "superstep_iaf_plain",
    "superstep_iaf_cuda",
    "superstep_lif_meta",
    "superstep_iaf_meta",
    "lif_allocations",
    "iaf_allocations",
]

_M32 = 0xFFFFFFFF
# The ignore-and-fire kernel keeps each source's window as a 32-bit pattern.
IAF_MAX_WINDOW = 32


def _splitmix32(x):
    """A well-mixed 32-bit finaliser on int64 tensors (or Python ints)
    holding uint32 values; every product stays below 2^63."""
    x = (x + 0x9E3779B9) & _M32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & _M32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def counter_uniform(seed, t: int, gids: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) f32 as a pure function of (seed, t, gid).

    ``seed`` is an int (the engine-wide seed) or an integer tensor
    broadcastable against ``gids`` holding uint32 values (the per-neuron
    drive seed); a broadcast int gives the same bits. The 32-bit mixing runs
    in int64 masked to 32 bits (PyTorch has no uint32 add or shift on every
    device); the CUDA kernel computes the same in ``uint32_t``
    (``csrc/neuron.cuh``).
    """
    if isinstance(seed, torch.Tensor):
        s = _splitmix32(seed.long() & _M32)
    else:
        s = _splitmix32(int(seed) & _M32)
    h = _splitmix32((_splitmix32((gids.long() + s) & _M32) + (int(t) & _M32)) & _M32)
    return h.float() * f32(1.0 / 4294967296.0)


def _check(name, state, fut, src, w, delay, *, d_win, steps_lo, r_span):
    a, n = state.shape
    k = src.shape[-1]
    for what, x in (("src", src), ("w", w), ("delay", delay)):
        if tuple(x.shape) != (a, n, k):
            raise ValueError(f"{name}: {what} {tuple(x.shape)} must be [A, n, K] = "
                             f"{(a, n, k)}")
    need = d_win + steps_lo + r_span - 1 if r_span > 0 else d_win
    if fut.ndim != 3 or tuple(fut.shape[:2]) != (a, n) or fut.shape[2] < need:
        raise ValueError(f"{name}: fut {tuple(fut.shape)} must be [{a}, {n}, W] "
                         f"with W >= {need} (D + steps_lo + r_span - 1)")
    if d_win < 1 or steps_lo < 0 or r_span < 0:
        raise ValueError(f"{name}: d_win={d_win} must be >= 1, steps_lo={steps_lo} "
                         f"and r_span={r_span} >= 0")


def _deposit_plain(fut, spikes, src, w, delay, s: int, steps_lo: int, r_span: int):
    """Add cycle ``s``'s intra contributions into ``fut[..., s + steps_lo + j]``."""
    a, n, k = src.shape
    if r_span == 0 or k == 0:
        return
    contrib = spike_deliver_plain(
        spikes.reshape(-1).float(), src.reshape(a * n, k), w.reshape(a * n, k),
        delay.reshape(a * n, k), steps_lo=steps_lo, r_span=r_span,
        rows_per_area=n, src_stride=n)
    fut[..., s + steps_lo: s + steps_lo + r_span] += contrib.view(a, n, r_span)


def superstep_lif_plain(
    v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
    *, d_win: int, steps_lo: int, r_span: int,
    p11: float, p21: float, p22: float, v_th: float, v_reset: float,
    t_ref_steps: int, seed: int, w_ext: float,
):
    """Fused LIF window in plain PyTorch (any device; row-chunked deposits).

    Returns ``(v, i_syn, refrac, fut, spikes [D, A, n] bool)``.
    """
    _check("superstep_lif", v, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    kw = dict(p11=p11, p21=p21, p22=p22, v_th=v_th, v_reset=v_reset,
              t_ref_steps=t_ref_steps)
    cols = []
    for s in range(d_win):
        drive = (counter_uniform(seed, int(t0) + s, gids) < drive_p).float() * f32(w_ext)
        v, i_syn, refrac, spikes = lif_update_plain(
            v, i_syn, refrac, fut[..., s] + drive, alive, **kw)
        cols.append(spikes)
        _deposit_plain(fut, spikes, src, w, delay, s, steps_lo, r_span)
    return v, i_syn, refrac, fut, torch.stack(cols)


def superstep_iaf_plain(
    countdown, fut, interval, alive, src, w, delay,
    *, d_win: int, steps_lo: int, r_span: int,
):
    """Fused ignore-and-fire window in plain PyTorch (any device).

    Returns ``(countdown, fut, spikes [D, A, n] bool)``.
    """
    _check("superstep_iaf", countdown, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    cols = []
    for s in range(d_win):
        spikes = (countdown == 0) & alive
        countdown = torch.where(spikes, interval - 1, countdown - 1)
        cols.append(spikes)
        _deposit_plain(fut, spikes, src, w, delay, s, steps_lo, r_span)
    return countdown, fut, torch.stack(cols)


def _require(name, dev, tensors: dict):
    """Every tensor contiguous, on ``dev`` (a CUDA device), of an allowed dtype."""
    for what, (x, ok) in tensors.items():
        if not x.is_cuda or x.device != dev or x.dtype not in ok or not x.is_contiguous():
            raise ValueError(f"{name} kernel: {what} must be a contiguous CUDA tensor "
                             f"of {ok} on {dev}, got {x.dtype} on {x.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


_F32, _I32, _BOOL = (torch.float32,), (torch.int32,), (torch.bool,)
_DELAYS = (torch.int8, torch.int32)


def lif_allocations(v, i_syn, refrac, d_win: int) -> dict:
    """What :func:`superstep_lif_cuda` allocates for a launch: the new
    ``v``, ``i_syn``, ``refrac`` and ``spikes [D, A, n]``, and the scratch:
    D spike bitmasks, each padded to 128 bytes (``masks``, ``stride``
    int32 words apart), and D x A per-area "spiked this cycle" flags with
    the grid barrier's arrival counter (``sync``, zeroed)."""
    a, n = v.shape
    dev = v.device
    n_words = -(-a * n // 32)
    stride = -(-n_words // 32) * 32
    return dict(v=torch.empty_like(v), i_syn=torch.empty_like(i_syn),
                refrac=torch.empty_like(refrac),
                spikes=torch.empty((d_win, a, n), dtype=torch.bool, device=dev),
                masks=torch.empty(d_win * stride, dtype=torch.int32, device=dev),
                sync=torch.zeros(d_win * a + 1, dtype=torch.int32, device=dev),
                stride=stride)


def iaf_allocations(countdown, d_win: int) -> dict:
    """What :func:`superstep_iaf_cuda` allocates for a launch: the new
    ``countdown`` and ``spikes [D, A, n]``, and the scratch: each source's
    D-bit ``pattern`` and the bitmask of sources that spiked in the window
    (``any_mask``, in whole 16-byte units)."""
    a, n = countdown.shape
    dev = countdown.device
    return dict(countdown=torch.empty_like(countdown),
                spikes=torch.empty((d_win, a, n), dtype=torch.bool, device=dev),
                pattern=torch.empty(a * n, dtype=torch.int32, device=dev),
                any_mask=torch.empty(-(-a * n // 128) * 4, dtype=torch.int32, device=dev))


def superstep_lif_meta(
    v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
    *, d_win: int, steps_lo: int, r_span: int, **params,
):
    """A launch priced on ``meta`` tensors: :func:`lif_allocations`, no
    arithmetic; returns what the kernel's wrapper returns."""
    _check("superstep_lif", v, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    out = lif_allocations(v, i_syn, refrac, d_win)
    return out["v"], out["i_syn"], out["refrac"], fut, out["spikes"]


def superstep_iaf_meta(
    countdown, fut, interval, alive, src, w, delay,
    *, d_win: int, steps_lo: int, r_span: int,
):
    """A launch priced on ``meta`` tensors: :func:`iaf_allocations`, no
    arithmetic; returns what the kernel's wrapper returns."""
    _check("superstep_iaf", countdown, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    out = iaf_allocations(countdown, d_win)
    return out["countdown"], fut, out["spikes"]


def superstep_lif_cuda(
    v, i_syn, refrac, fut, drive_p, gids, alive, src, w, delay, t0,
    *, d_win: int, steps_lo: int, r_span: int,
    p11: float, p21: float, p22: float, v_th: float, v_reset: float,
    t_ref_steps: int, seed: int, w_ext: float,
):
    """Launch the fused LIF kernel (one cooperative launch per window).

    ``v``, ``i_syn``, ``drive_p`` f32, ``refrac``, ``gids`` int32, ``alive``
    bool ``[A, n]``; ``fut`` f32 ``[A, n, W]``; ``src`` int32, ``w`` f32,
    ``delay`` int8/int32 ``[A, n, K]``; all contiguous on one CUDA device.
    Returns new state, ``fut`` (updated in place) and new spikes.
    """
    _check("superstep_lif", v, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    dev = v.device
    _require("superstep_lif", dev, dict(
        v=(v, _F32), i_syn=(i_syn, _F32), refrac=(refrac, _I32), fut=(fut, _F32),
        drive_p=(drive_p, _F32), gids=(gids, _I32), alive=(alive, _BOOL),
        src=(src, _I32), w=(w, _F32), delay=(delay, _DELAYS)))
    for what, x in (("i_syn", i_syn), ("refrac", refrac), ("drive_p", drive_p),
                    ("gids", gids), ("alive", alive)):
        if x.shape != v.shape:
            raise ValueError(f"superstep_lif kernel: {what} {tuple(x.shape)} != "
                             f"v {tuple(v.shape)}")
    a, n = v.shape
    k = src.shape[-1]
    out = lif_allocations(v, i_syn, refrac, d_win)
    v_o, i_o, r_o, spikes = out["v"], out["i_syn"], out["refrac"], out["spikes"]
    masks, sync, stride = out["masks"], out["sync"], out["stride"]
    lib = cuda.library("superstep_lif")
    with torch.cuda.device(dev):
        err = lib.superstep_lif_launch(
            v.data_ptr(), i_syn.data_ptr(), refrac.data_ptr(), drive_p.data_ptr(),
            gids.data_ptr(), alive.data_ptr(), v_o.data_ptr(), i_o.data_ptr(),
            r_o.data_ptr(), fut.data_ptr(), src.data_ptr(), w.data_ptr(),
            delay.data_ptr(), delay.element_size(), spikes.data_ptr(),
            masks.data_ptr(), sync.data_ptr(), sync.data_ptr() + 4 * d_win * a,
            a, n, k, fut.shape[-1], d_win, steps_lo, r_span, int(t0),
            int(seed) & _M32, f32(p11), f32(p21), f32(p22), f32(v_th),
            f32(v_reset), int(t_ref_steps), f32(w_ext), stride, _stream(dev))
    cuda.check("superstep_lif", err)
    cuda.launches["superstep_lif"] += 1
    return v_o, i_o, r_o, fut, spikes


def superstep_iaf_cuda(
    countdown, fut, interval, alive, src, w, delay,
    *, d_win: int, steps_lo: int, r_span: int,
):
    """Launch the fused ignore-and-fire kernels (spikes, then one deposit
    pass; ``src`` is streamed by bulk copies when ``K % 4 == 0`` and it is
    16-byte aligned, by ordinary loads otherwise). ``countdown``,
    ``interval`` int32 and ``alive`` bool ``[A, n]``;
    ``fut``, ``src``, ``w``, ``delay`` as for :func:`superstep_lif_cuda`.
    Returns a new countdown, ``fut`` (updated in place) and new spikes.
    """
    _check("superstep_iaf", countdown, fut, src, w, delay,
           d_win=d_win, steps_lo=steps_lo, r_span=r_span)
    if d_win > IAF_MAX_WINDOW:
        raise ValueError(f"superstep_iaf kernel: a window of D={d_win} cycles "
                         f"exceeds its {IAF_MAX_WINDOW}-bit spike patterns")
    dev = countdown.device
    _require("superstep_iaf", dev, dict(
        countdown=(countdown, _I32), fut=(fut, _F32), interval=(interval, _I32),
        alive=(alive, _BOOL), src=(src, _I32), w=(w, _F32), delay=(delay, _DELAYS)))
    for what, x in (("interval", interval), ("alive", alive)):
        if x.shape != countdown.shape:
            raise ValueError(f"superstep_iaf kernel: {what} {tuple(x.shape)} != "
                             f"countdown {tuple(countdown.shape)}")
    a, n = countdown.shape
    if a * n >= 1 << 31:
        raise ValueError(f"superstep_iaf kernel: {a * n} neurons; the kernel indexes "
                         f"sources in 31 bits")
    k = src.shape[-1]
    out = iaf_allocations(countdown, d_win)
    cd_o, spikes, pattern, any_mask = (out[f] for f in ("countdown", "spikes", "pattern",
                                                         "any_mask"))
    lib = cuda.library("superstep_iaf")
    with torch.cuda.device(dev):
        err = lib.superstep_iaf_launch(
            countdown.data_ptr(), interval.data_ptr(), alive.data_ptr(),
            cd_o.data_ptr(), fut.data_ptr(), src.data_ptr(), w.data_ptr(),
            delay.data_ptr(), delay.element_size(), spikes.data_ptr(),
            pattern.data_ptr(), any_mask.data_ptr(), a, n, k, fut.shape[-1],
            d_win, steps_lo, r_span, _stream(dev))
    cuda.check("superstep_iaf", err)
    cuda.launches["superstep_iaf"] += 1
    return cd_o, fut, spikes
