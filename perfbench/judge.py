"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (:mod:`perfbench.reference`).

Every number is a count of disagreements, and every limit is 0: the
simulator is exact by construction (weights on the 1/256 grid, a counter
hash for every draw, the LIF step's two fused multiply-adds), so a sound run
agrees bit for bit and any departure is a fault. The numbers, in order:

* ``tables_differ``: incoming table entries (source, weight bits, delay)
  the run built that differ from the reference's draws, over every row;
* ``outgoing_differ``: source rows of the outgoing tables (where the route
  builds them) whose count or multiset of (target, weight bits, delay)
  differs from the reference's;
* ``spike_counts_differ``: neurons whose spike count over the run differs;
* ``area_windows_differ``: (window, area) spike counts that differ, over
  every window of the run, warm-up included;
* ``state_differ``: live neurons whose final state differs in any bit
  (ghost rows, the padding past an area's live neurons, never fire and are
  not compared);
* ``ring_differ``: entries of the final ring buffer on live rows that
  differ in any bit;
* ``overflow``: spikes the run's bounded event packets dropped.
"""

from __future__ import annotations

import torch

from perfbench.reference.network import entry_hash

__all__ = ["NAMES", "LIMITS", "TableCheck", "compare", "passed"]

NAMES = ("tables_differ", "outgoing_differ", "spike_counts_differ", "area_windows_differ",
         "state_differ", "ring_differ", "overflow")
LIMITS = {name: 0 for name in NAMES}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Float values as comparable integers (a lower precision widened to
    float32 first); integers as they are."""
    if x.is_floating_point():
        return x.float().contiguous().view(torch.int32)
    return x.long()


class TableCheck:
    """Counts the run's tables against the reference's draws, chunk by
    chunk (``__call__`` is a draw callback). ``net`` is the run's network
    (its ``[A, n_pad, K]`` tables indexed by global row); ``outgoing``
    also fingerprints every source's outgoing row (only where the draws
    cover every target row)."""

    def __init__(self, net, *, outgoing: bool):
        self.net = net
        self.differ = 0
        n = net.alive.numel()
        dev = net.alive.device
        self.outgoing = outgoing and net.tgt_intra is not None
        if self.outgoing:
            self.ref = {p: (torch.zeros(n, dtype=torch.int64, device=dev),
                            torch.zeros(n, dtype=torch.int64, device=dev))
                        for p in ("intra", "inter")}

    def __call__(self, pathway, rows, src, w, d):
        net = self.net
        k = src.shape[1]
        tables = ((net.src_intra, net.w_intra, net.delay_intra) if pathway == "intra"
                  else (net.src_inter, net.w_inter, net.delay_inter))
        got = [t.reshape(-1, k)[rows] for t in tables]
        self.differ += int((got[0] != src).sum() + (_bits(got[1]) != _bits(w)).sum()
                           + (got[2].long() != d.long()).sum())
        if self.outgoing:
            n_pad = net.n_pad
            if pathway == "intra":
                area = rows // n_pad
                source = area[:, None] * n_pad + src.long()
                target = (rows % n_pad)[:, None].expand_as(source)
            else:
                source = src.long()
                target = rows[:, None].expand_as(source)
            fp, count = self.ref[pathway]
            fp.index_add_(0, source.reshape(-1), entry_hash(target, w, d).reshape(-1))
            count.index_add_(0, source.reshape(-1), torch.ones_like(source).reshape(-1))

    def outgoing_differ(self) -> int:
        """Source rows whose outgoing row differs from the reference's."""
        if not self.outgoing:
            return 0
        net, bad = self.net, 0
        for p, tables in (("intra", (net.tgt_intra, net.wout_intra, net.dout_intra)),
                          ("inter", (net.tgt_inter, net.wout_inter, net.dout_inter))):
            if tables[0] is None or tables[0].shape[-1] == 0:
                bad += int((self.ref[p][1] != 0).sum())
                continue
            k = tables[0].shape[-1]
            tgt, w, d = (t.reshape(-1, k) for t in tables)
            fp_ref, count_ref = self.ref[p]
            for r0 in range(0, tgt.shape[0], 8192):
                t_, w_, d_ = tgt[r0:r0 + 8192], w[r0:r0 + 8192], d[r0:r0 + 8192]
                real = t_ != -1
                fp = torch.where(real, entry_hash(t_, w_, d_), 0).sum(1)
                cnt = real.sum(1)
                bad += int(((fp != fp_ref[r0:r0 + 8192]) | (cnt != count_ref[r0:r0 + 8192])).sum())
        return bad


def compare(run: dict, ref: dict, alive: torch.Tensor) -> dict:
    """Counts of disagreement between the run's outputs and the reference's
    (both dicts of tensors on one device: ``spike_count``, ``area_counts``,
    ``ring``, the state leaves; ``alive`` masks the ring's live rows)."""
    out = {}
    out["spike_counts_differ"] = int((run["spike_count"].long() != ref["spike_count"].long()).sum())
    a, b = run["area_counts"].long(), ref["area_counts"].long()
    if a.shape != b.shape:
        out["area_windows_differ"] = max(a.numel(), b.numel())
    else:
        out["area_windows_differ"] = int((a != b).sum())
    state = torch.zeros_like(alive)
    for leaf in ("v", "i_syn", "refrac", "countdown"):
        if leaf in ref:
            state |= _bits(run[leaf]) != _bits(ref[leaf])
    out["state_differ"] = int((state & alive).sum())
    ring = _bits(run["ring"]) != _bits(ref["ring"])
    out["ring_differ"] = int((ring & alive[..., None]).sum())
    return out


def passed(checks: dict) -> bool:
    return all(checks.get(name, 0) <= LIMITS[name] for name in NAMES)
