"""The benchmark's plain simulator: what the network does, step by step.

One step ``t`` of a neuron: read and clear its ring slot ``t % R``, add
the external drive, update the state, and for every spike deposit each
outgoing synapse's weight into the target's slot ``(t + delay) % R``.
Every weight lies on the 1/256 grid, so the ring's float32 sums are exact in
any order, and the window schedule (deliveries between areas lumped at a
window's end, every such delay being at least a window long) reaches the
same ring as this one step at a time.

* LIF (``iaf_psc_exp``, exact integration): ``i' = fma(i, p11, i_in)``,
  ``v' = fma(v, p22, f32(i * p21))``, each fused multiply-add rounded once
  to float32 (:func:`fma_f32` computes it exactly in float64), a spike at
  ``v' >= v_th`` outside the refractory period, then ``v = v_reset`` for
  ``t_ref`` steps. The drive is a Bernoulli impulse of ``w_ext`` at
  probability ``rate * (ext_rate / 2.5) * dt`` from a counter hash of
  ``(drive seed, t, gid)``. :func:`lif_replay` runs every step from ``t =
  0`` over outgoing synapse lists (CSR by global source id) that
  :func:`build_csr` sorts out of the drawn tables.
* Ignore-and-fire: neuron ``gid`` fires at every step ``t`` with ``t = gid
  (mod interval)``, whatever its input. Its state, spike counts and, for
  the last deliveries, its ring therefore have closed forms
  (:func:`iaf_outputs`): a deposit is still in the ring at the end ``T``
  only if ``t + delay >= T``.

``dtype`` sets the precision of the state and the ring: float32 as the
configuration states it, or a lower one for the control.
"""

from __future__ import annotations

import torch

from perfbench.reference.network import (M32, NEVER, NetDesc, chunk_budget, draw_rows, f32,
                                         global_sources, mix32, pathways, row_chunks)

__all__ = ["Block", "fma_f32", "build_csr", "lif_replay", "iaf_outputs", "for_each_draw"]


class Block:
    """The ``[A, n_pad]`` neuron grid whose rows the reference works out."""

    def __init__(self, desc: NetDesc):
        self.a_loc, self.n_loc = desc.n_areas, desc.n_pad

    def rows(self, device) -> torch.Tensor:
        """Global row ids ``[a_loc * n_loc]`` int64, area-major."""
        return torch.arange(self.a_loc * self.n_loc, device=device)


def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (``a``, ``c`` float32, ``b``
    exact in float32). The product is exact in float64; the float64 sum's
    error is kept (two-sum), and where the sum sits exactly halfway between
    two float32 values the error decides the side, so nothing is rounded
    twice."""
    p = a.double() * b
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    gap = s - r.double()
    toward = torch.where(gap > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nb = torch.nextafter(r, toward)
    tie = (gap != 0) & (gap.abs() * 2 == (nb.double() - r.double()).abs())
    return torch.where(tie & (err * gap > 0), nb, r)


def for_each_draw(desc: NetDesc, seed: int, block: Block, device, fn, *, full=True,
                  alive_only=False):
    """Call ``fn(pathway, rows, src, w, delay)`` over the block's target
    rows, drawn in chunks (``rows`` int64 global ids)."""
    rows = block.rows(device)
    if alive_only:
        sizes = torch.as_tensor(desc.sizes, device=device)
        rows = rows[(rows % desc.n_pad) < sizes[rows // desc.n_pad]]
    budget = chunk_budget(device)
    for p in pathways(desc):
        k = desc.k_intra if p == "intra" else desc.k_inter
        for chunk in row_chunks(rows, k, budget):
            fn(p, chunk, *draw_rows(desc, seed, chunk, p, full=full))


def build_csr(desc: NetDesc, seed: int, device):
    """Every synapse onto a live neuron, listed by global source id:
    ``(offsets [N + 1] int64, target [S] int32, weight [S] f32, delay [S])``
    with source ``g``'s entries at ``offsets[g]:offsets[g + 1]`` (any
    order: the ring's sums are exact)."""
    n = desc.n_rows
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    block = Block(desc)

    def count(p, rows, src, w, d):
        counts.add_(torch.bincount(global_sources(desc, rows, p, src).reshape(-1), minlength=n))

    for_each_draw(desc, seed, block, device, count, full=False, alive_only=True)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    dmax = max(desc.intra_max, desc.inter_max)
    tgt = torch.empty(total, dtype=torch.int32, device=device)
    wgt = torch.empty(total, dtype=torch.float32, device=device)
    dly = torch.empty(total, dtype=desc.delay_dtype(dmax), device=device)
    cursor = offsets[:-1].clone()
    del counts

    def fill(p, rows, src, w, d):
        k = src.shape[1]
        key, perm = torch.sort(global_sources(desc, rows, p, src).reshape(-1))
        rank = torch.arange(key.numel(), device=device) - torch.searchsorted(key, key)
        pos = cursor[key] + rank
        tgt[pos] = rows[perm // k].int()
        wgt[pos] = w.reshape(-1)[perm]
        dly[pos] = d.reshape(-1)[perm].to(dly.dtype)
        cursor.add_(torch.bincount(key, minlength=n))

    for_each_draw(desc, seed, block, device, fill, alive_only=True)
    return offsets, tgt, wgt, dly


def drive_uniform(drive_seed: int, t: int, gids: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``(drive seed, t, gid)``."""
    s = int(mix32(torch.tensor(int(drive_seed) & M32)))
    h = mix32((mix32((gids + s) & M32) + (int(t) & M32)) & M32)
    return h.float() * f32(1.0 / 4294967296.0)


def lif_replay(desc: NetDesc, csr, drive_seed: int, n_windows: int, device, *,
               dtype=torch.float32) -> dict:
    """``n_windows`` windows of the LIF network from rest, one step at a
    time: ``v``, ``i_syn``, ``refrac``, ``spike_count`` ``[A, n_pad]``,
    ``ring [A, n_pad, R]`` and ``area_counts [n_windows, A]`` (spikes a
    window and area)."""
    A, n_pad, R, D = desc.n_areas, desc.n_pad, desc.ring_len, desc.d
    n = A * n_pad
    offsets, tgt, wgt, dly = csr
    p = desc.lif_propagators()
    alive = desc.alive(device).reshape(-1)
    gids = torch.arange(n, dtype=torch.int64, device=device)
    drive_p = desc.rate_grid(device).reshape(-1) * f32(desc.ext_rate_hz / 2.5)
    drive_p = drive_p * f32(desc.dt_ms * 1e-3)
    w_ext = f32(desc.w_ext)
    ring = torch.zeros((n, R), dtype=dtype, device=device)
    v = torch.zeros(n, dtype=dtype, device=device)
    i_syn = torch.zeros(n, dtype=dtype, device=device)
    refrac = torch.zeros(n, dtype=torch.int32, device=device)
    count = torch.zeros(n, dtype=torch.int32, device=device)
    area_counts = torch.zeros((n_windows, A), dtype=torch.int64, device=device)
    exact = dtype == torch.float32
    wgt_c = wgt if exact else wgt.to(dtype)
    for t in range(n_windows * D):
        slot = t % R
        i_in = ring[:, slot].clone()
        ring[:, slot] = 0
        drive = (drive_uniform(drive_seed, t, gids) < drive_p).float() * w_ext
        refractory = refrac > 0
        if exact:
            i_new = fma_f32(i_syn, p["p11"], i_in + drive)
            v_prop = fma_f32(v, p["p22"], i_syn * p["p21"])
        else:  # the control: the same steps, rounded to ``dtype``
            i_new = (i_syn.float() * p["p11"] + (i_in.float() + drive)).to(dtype)
            v_prop = (v.float() * p["p22"] + (i_syn.float() * p["p21"])).to(dtype)
        v_new = torch.where(refractory, torch.full_like(v_prop, p["v_reset"]), v_prop)
        spk = (v_new >= p["v_th"]) & alive & ~refractory
        v = torch.where(spk, torch.full_like(v_new, p["v_reset"]), v_new)
        i_syn = i_new
        refrac = torch.where(spk, p["t_ref"], torch.clamp(refrac - 1, min=0)).to(torch.int32)
        count += spk.int()
        area_counts[t // D] += spk.view(A, n_pad).sum(1)
        ids = spk.nonzero().reshape(-1)
        if ids.numel() == 0:
            continue
        start = offsets[ids]
        cnt = offsets[ids + 1] - start
        total = int(cnt.sum())
        if total == 0:
            continue
        first = torch.cumsum(cnt, 0) - cnt
        owner = torch.repeat_interleave(torch.arange(ids.numel(), device=device), cnt,
                                        output_size=total)
        idx = (start - first)[owner] + torch.arange(total, device=device)
        dest = tgt[idx].long() * R + (t + dly[idx].long()) % R
        ring.view(-1).index_add_(0, dest, wgt_c[idx])
    return dict(v=v.view(A, n_pad), i_syn=i_syn.view(A, n_pad), refrac=refrac.view(A, n_pad),
                spike_count=count.view(A, n_pad), ring=ring.view(A, n_pad, R),
                area_counts=area_counts)


def iaf_outputs(desc: NetDesc, seed: int, block: Block, n_windows: int, device, *,
                dtype=torch.float32, on_draw=None) -> dict:
    """The ignore-and-fire network after ``n_windows`` windows, on the
    block's rows: ``countdown``, ``spike_count [a_loc, n_loc]``, ``ring
    [a_loc, n_loc, R]`` and ``area_counts [n_windows, a_loc]``.
    ``on_draw(pathway, rows, src, w, delay)`` sees every drawn chunk."""
    A, n_pad, R, D = desc.n_areas, desc.n_pad, desc.ring_len, desc.d
    T = n_windows * D
    interval = desc.iaf_interval(device).reshape(-1).long()
    gids = torch.arange(A * n_pad, device=device)
    alive = desc.alive(device).reshape(-1)
    phase = gids % interval
    rows = block.rows(device)
    iv, ph, al = interval[rows], phase[rows], alive[rows]
    countdown = torch.where(al, (ph - T) % iv, NEVER - T).to(torch.int32)
    fired = al & (ph <= T - 1)
    count = torch.where(fired, (T - 1 - ph) // iv + 1, 0).to(torch.int32)
    area = torch.arange(block.a_loc, device=device).repeat_interleave(block.n_loc)
    area_counts = torch.zeros(n_windows * block.a_loc, dtype=torch.int64, device=device)
    most = int(count.max()) if count.numel() else 0
    for m in range(most):
        t = ph + m * iv
        ok = fired & (t < T)
        area_counts.index_add_(0, (t // D * block.a_loc + area)[ok],
                               torch.ones_like(t)[ok])
    # The last firing of each source before T, and as many before it as a
    # delay can reach past T.
    last = T - 1 - ((T - 1 - phase) % interval)
    last = torch.where(alive & (phase <= T - 1), last, -1)
    dmax = max(desc.intra_max, desc.inter_max)
    back = int(dmax // int(interval[alive].min()) + 1) if bool(alive.any()) else 0
    ring = torch.zeros(block.a_loc * block.n_loc * R, dtype=dtype, device=device)
    local = torch.full((A * n_pad,), -1, dtype=torch.int64, device=device)
    local[rows] = torch.arange(rows.numel(), device=device)

    def deposit(p, chunk, src, w, d):
        if on_draw is not None:
            on_draw(p, chunk, src, w, d)
        g = global_sources(desc, chunk, p, src)
        row = local[chunk][:, None].expand_as(g)
        for m in range(back):
            t = last[g] - m * interval[g]
            ok = (t >= 0) & (t + d.long() >= T)
            if not bool(ok.any()):
                continue
            dest = row[ok] * R + (t[ok] + d.long()[ok]) % R
            ring.index_add_(0, dest, w[ok].to(dtype))

    for_each_draw(desc, seed, block, device, deposit)
    return dict(countdown=countdown.view(block.a_loc, block.n_loc),
                spike_count=count.view(block.a_loc, block.n_loc),
                ring=ring.view(block.a_loc, block.n_loc, R),
                area_counts=area_counts.view(n_windows, block.a_loc))

