"""The benchmark's plain description of a network and its synapse draws.

Written from the model's description, not from the program: a network of
``A`` areas, each padded to ``n_pad`` rows (ghost rows past an area's live
neurons); every row draws ``k_intra`` sources in its own area and ``k_inter``
in the other areas its adjacency allows. Every synapse attribute is a pure
function of ``(seed, tag, flat index)``, the flat index being ``row * K +
k`` in its pathway's table:

* the hash is three rounds of a 32-bit finaliser (``mix32``) over the low
  and high words of the index and ``seed + tag * 0x85EBCA6B``;
* an intra source is ``hash(1) % size`` (an index within the area); an
  inter source picks its area by ``hash(2) % n_allowed`` among the allowed
  areas in ascending order, its neuron by ``hash(3) % size``, and is held
  as the global id ``area * n_pad + index``;
* a weight is ``(0.5 + u) * w_exc`` on the 1/256 grid, ``u`` uniform in
  (0, 1) from ``hash(4)`` (intra) or ``hash(5)`` (inter); a source whose
  index is at or past ``exc_fraction * size`` (truncated, at least 1) is
  inhibitory, its weight times ``-g`` in float32;
* a delay is a Box-Muller normal of ``hash(6), hash(7)`` (intra) or
  ``hash(8), hash(9)`` (inter), in steps of ``dt``, rounded half to even and
  clipped to ``[1, intra max]`` or ``[D, inter max]``.

The uint32 arithmetic runs in int64 masked to 32 bits, the normal draw in
float64 (on the device of the run, so that ``log`` and ``cos`` round as the
run's own draws do). Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

M32 = 0xFFFFFFFF
NEVER = np.iinfo(np.int32).max // 2  # countdown of a neuron that never fires


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + 0x9E3779B9) & M32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & M32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & M32
    return x ^ (x >> 15)


def counter_hash(seed: int, tag: int, idx: torch.Tensor) -> torch.Tensor:
    s0 = (int(seed) + int(tag) * 0x85EBCA6B) & M32
    lo, hi = idx & M32, idx >> 32
    return mix32(mix32((mix32((lo + s0) & M32) + hi) & M32))


def counter_uniform(seed: int, tag: int, idx: torch.Tensor) -> torch.Tensor:
    return (counter_hash(seed, tag, idx).double() + 0.5) * (2.0 ** -32)


def f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class NetDesc:
    """A network as the configuration file states it."""

    sizes: tuple[int, ...]
    rates_hz: tuple[float, ...]
    k_intra: int
    k_inter: int
    dt_ms: float
    d_min_inter_ms: float
    delay_intra_mean_ms: float
    delay_intra_std_ms: float
    delay_intra_max_ms: float
    delay_inter_mean_ms: float
    delay_inter_std_ms: float
    delay_inter_max_ms: float
    exc_fraction: float
    w_exc: float
    g: float
    ext_rate_hz: float
    w_ext: float
    lif: dict  # tau_m_ms, tau_syn_ms, c_m_pf, t_ref_ms, v_th_mv, v_reset_mv
    adjacency: tuple | None = None  # [A][A] source -> target, None: all-to-all

    @classmethod
    def from_config(cls, net: dict) -> "NetDesc":
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in net.items() if k in keys}
        kw["sizes"] = tuple(int(x) for x in net["sizes"])
        kw["rates_hz"] = tuple(float(x) for x in net["rates_hz"])
        if kw.get("adjacency") is not None:
            kw["adjacency"] = tuple(tuple(int(x) for x in row) for row in kw["adjacency"])
        return cls(**kw)

    @property
    def n_areas(self) -> int:
        return len(self.sizes)

    @property
    def n_pad(self) -> int:
        return max(self.sizes)

    @property
    def n_rows(self) -> int:
        return self.n_areas * self.n_pad

    @property
    def d(self) -> int:
        """Cycles a window: the shortest inter-area delay over ``dt``."""
        return int(round(self.d_min_inter_ms / self.dt_ms))

    @property
    def intra_max(self) -> int:
        return int(round(self.delay_intra_max_ms / self.dt_ms))

    @property
    def inter_max(self) -> int:
        return int(round(self.delay_inter_max_ms / self.dt_ms))

    @property
    def ring_len(self) -> int:
        """Slots a neuron holds: up to the longest delay, rounded up to a
        multiple of ``d``."""
        base = max(self.intra_max, self.inter_max) + 1
        return -(-base // self.d) * self.d

    def delay_dtype(self, hi: int) -> torch.dtype:
        return torch.int8 if hi <= 127 else torch.int32

    def adjacency_matrix(self) -> np.ndarray:
        a = self.n_areas
        adj = (np.ones((a, a), bool) if self.adjacency is None
               else np.asarray(self.adjacency, bool))
        adj = adj & ~np.eye(a, dtype=bool)
        return adj if self.k_inter > 0 else np.zeros((a, a), bool)

    def alive(self, device) -> torch.Tensor:
        """``[A, n_pad]`` bool: the live neurons come first in each area."""
        sizes = torch.as_tensor(self.sizes, device=device)
        return torch.arange(self.n_pad, device=device)[None, :] < sizes[:, None]

    def rate_grid(self, device) -> torch.Tensor:
        """``[A, n_pad]`` float32 rates, 0 on ghost rows."""
        rates = torch.as_tensor(np.asarray(self.rates_hz, np.float32), device=device)
        return torch.where(self.alive(device), rates[:, None], torch.zeros((), device=device))

    def lif_propagators(self) -> dict:
        """The exact-integration propagators of ``iaf_psc_exp`` over ``dt``,
        in float32."""
        p = self.lif
        tm, ts, cm, dt = p["tau_m_ms"], p["tau_syn_ms"], p["c_m_pf"], self.dt_ms
        if abs(tm - ts) < 1e-12:
            p21 = dt / cm * np.exp(-dt / tm)
        else:
            p21 = (tm * ts) / (cm * (tm - ts)) * (np.exp(-dt / tm) - np.exp(-dt / ts))
        return dict(p11=f32(np.exp(-dt / ts)), p21=f32(p21), p22=f32(np.exp(-dt / tm)),
                    v_th=f32(p["v_th_mv"]), v_reset=f32(p["v_reset_mv"]),
                    t_ref=int(round(p["t_ref_ms"] / dt)))

    def iaf_interval(self, device) -> torch.Tensor:
        """``[A, n_pad]`` int32 steps between two spikes of an
        ignore-and-fire neuron: ``round(1000 / (rate * dt))`` in float32, at
        least 1; a neuron at rate 0 never fires."""
        rate = self.rate_grid(device)
        steps = torch.div(torch.full_like(rate, 1000.0), rate * f32(self.dt_ms))
        interval = torch.clamp(torch.round(steps).nan_to_num(posinf=0).to(torch.int32), min=1)
        return torch.where(rate > 0, interval, NEVER).to(torch.int32)


def _weights(desc: NetDesc, seed: int, tag: int, idx, src_idx, size_of_src):
    exc = src_idx < torch.clamp((desc.exc_fraction * size_of_src.double()).long(), min=1)
    u = counter_uniform(seed, tag, idx)
    mag = (torch.round(((0.5 + u) * desc.w_exc) / (1.0 / 256.0)) * (1.0 / 256.0)).float()
    return torch.where(exc, mag, mag * -f32(desc.g))


def _delays(desc: NetDesc, seed: int, tags, idx, mean, std, lo, hi):
    u1 = counter_uniform(seed, tags[0], idx)
    u2 = counter_uniform(seed, tags[1], idx)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
    d = (mean + std * z) / desc.dt_ms
    return torch.clamp(torch.round(d), lo, hi).to(desc.delay_dtype(hi))


def draw_rows(desc: NetDesc, seed: int, rows: torch.Tensor, pathway: str, *,
              full: bool = True):
    """``(src, w, delay)`` ``[R, K]`` of the given global target rows (int64,
    on the device to draw on); ``w`` and ``delay`` are None unless
    ``full``. Intra sources are indices within the row's area, inter
    sources global ids."""
    dev = rows.device
    rows = rows.long()
    sizes = torch.as_tensor(desc.sizes, dtype=torch.int64, device=dev)
    area = rows // desc.n_pad
    if pathway == "intra":
        k = desc.k_intra
        idx = rows[:, None] * k + torch.arange(k, device=dev)[None, :]
        size = sizes[area][:, None]
        src = counter_hash(seed, 1, idx) % size
        if not full:
            return src.int(), None, None
        w = _weights(desc, seed, 4, idx, src, size)
        d = _delays(desc, seed, (6, 7), idx, desc.delay_intra_mean_ms,
                    desc.delay_intra_std_ms, 1, desc.intra_max)
        return src.int(), w, d
    if pathway != "inter":
        raise ValueError(f"unknown pathway {pathway!r}")
    k = desc.k_inter
    adj = desc.adjacency_matrix()
    n_allowed = adj.sum(axis=0)
    allowed = np.zeros((desc.n_areas, max(int(n_allowed.max(initial=0)), 1)), np.int64)
    for a in range(desc.n_areas):
        srcs = np.flatnonzero(adj[:, a])
        allowed[a, :len(srcs)] = srcs
    allowed = torch.as_tensor(allowed, device=dev)
    n_allowed = torch.as_tensor(n_allowed.astype(np.int64), device=dev)
    idx = rows[:, None] * k + torch.arange(k, device=dev)[None, :]
    pick = counter_hash(seed, 2, idx) % n_allowed[area][:, None]
    src_area = torch.gather(allowed[area], 1, pick)
    src_idx = counter_hash(seed, 3, idx) % sizes[src_area]
    src = (src_area * desc.n_pad + src_idx).int()
    if not full:
        return src, None, None
    w = _weights(desc, seed, 5, idx, src_idx, sizes[src_area])
    d = _delays(desc, seed, (8, 9), idx, desc.delay_inter_mean_ms, desc.delay_inter_std_ms,
                desc.d, desc.inter_max)
    return src, w, d


def global_sources(desc: NetDesc, rows: torch.Tensor, pathway: str, src: torch.Tensor):
    """``src`` as global source ids (intra sources are held per area)."""
    if pathway == "intra":
        return (rows.long() // desc.n_pad)[:, None] * desc.n_pad + src.long()
    return src.long()


def row_chunks(rows: torch.Tensor, k_total: int, budget: int = 1 << 26):
    """Consecutive slices of ``rows`` holding at most ``budget`` synapses."""
    step = max(1, budget // max(1, k_total))
    for r0 in range(0, rows.numel(), step):
        yield rows[r0:r0 + step]


def pathways(desc: NetDesc):
    return [p for p, k in (("intra", desc.k_intra), ("inter", desc.k_inter)) if k > 0]


def entry_hash(tgt: torch.Tensor, w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A 32-bit hash (as int64) of one outgoing entry (target, weight bits,
    delay): summed over a source's entries it fingerprints the row's
    multiset, whatever their order."""
    wbits = w.contiguous().view(torch.int32).long() & M32
    x = mix32(tgt.long() & M32)
    x = mix32(x ^ wbits)
    return mix32(x ^ (d.long() & M32))


def chunk_budget(device) -> int:
    """Synapses a draw takes at once: ~40 bytes of temporaries each."""
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(min(1 << 27, max(1 << 22, free // 120)))
    return 1 << 22


__all__ = ["NetDesc", "draw_rows", "global_sources", "row_chunks", "pathways", "entry_hash",
           "counter_hash", "counter_uniform", "mix32", "f32", "M32", "NEVER", "chunk_budget"]
