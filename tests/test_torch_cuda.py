"""The CUDA kernels against their plain versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests skip where there is no GPU
(they run on the card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Tolerance: bitwise, as for the CPU parity tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    EngineConfig, build_network, make_simulation, mam_benchmark_spec,
)
from repro_torch.core.neuron import LIFParams  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import cycle as cyc  # noqa: E402
from repro_torch.kernels import lif_update as lif  # noqa: E402
from repro_torch.kernels import spike_deliver as dlv  # noqa: E402
from test_torch_moe_routing import agreeing_rows, routing_tap  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def test_lif_update_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    n = 100_003
    p = LIFParams()
    kw = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
              v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps)
    xs = [torch.from_numpy(x).to(dev) for x in (
        rng.normal(13.0, 3.0, n).astype(np.float32),
        rng.normal(0.0, 300.0, n).astype(np.float32),
        rng.integers(-1, 5, n).astype(np.int32),
        rng.normal(0.0, 250.0, n).astype(np.float32),
        rng.random(n) < 0.9)]
    before = cuda.launches["lif_update"]
    got = lif.lif_update_cuda(*xs, **kw)
    torch.cuda.synchronize()
    assert cuda.launches["lif_update"] == before + 1
    for g, w in zip(got, lif.lif_update_plain(*xs, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
@pytest.mark.parametrize("per_area", [False, True])
def test_spike_deliver_kernel_matches_plain(dev, delay_dtype, per_area):
    rng = np.random.default_rng(1)
    a, n, k, lo, span = 3, 1000, 333, 10, 91
    spikes = torch.from_numpy((rng.random(a * n) < 0.05).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.integers(0, n if per_area else a * n, (a * n, k))
                           .astype(np.int32)).to(dev)
    w = torch.from_numpy((np.round(rng.normal(0, 60, (a * n, k)) * 256) / 256)
                         .astype(np.float32)).to(dev)
    delay = torch.from_numpy(rng.integers(lo - 2, lo + span + 2, (a * n, k))
                             .astype(delay_dtype)).to(dev)
    kw = dict(steps_lo=lo, r_span=span)
    if per_area:
        kw.update(rows_per_area=n, src_stride=n)
    got = dlv.spike_deliver_cuda(spikes, src, w, delay, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, dlv.spike_deliver_plain(spikes, src, w, delay, **kw))


def test_spike_deliver_kernel_with_a_bitmask_beyond_shared_memory(dev):
    """2.1M sources: the kernel's spike bitmask (262 KB) no longer fits a
    block's shared memory and is read from device memory instead."""
    rng = np.random.default_rng(2)
    n, k, n_src, lo, span = 2000, 256, 2_100_000, 1, 30
    spikes = torch.from_numpy((rng.random(n_src) < 0.05).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.integers(0, n_src, (n, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy((np.round(rng.normal(0, 60, (n, k)) * 256) / 256)
                         .astype(np.float32)).to(dev)
    delay = torch.from_numpy(rng.integers(lo, lo + span, (n, k)).astype(np.int8)).to(dev)
    got = dlv.spike_deliver_cuda(spikes, src, w, delay, steps_lo=lo, r_span=span)
    torch.cuda.synchronize()
    want = dlv.spike_deliver_plain(spikes, src, w, delay, steps_lo=lo, r_span=span)
    assert torch.equal(got, want) and bool(want.abs().sum() > 0)


@pytest.mark.parametrize("model", ["ignore_and_fire", "lif"])
def test_engine_on_the_card_matches_the_cpu(dev, model):
    spec = mam_benchmark_spec(n_areas=4, n_per_area=64, k_intra=16, k_inter=16,
                              rate_hz=30.0 if model == "ignore_and_fire" else 2.5)
    cfg = EngineConfig(neuron_model=model, delivery_backend="pallas")
    engs = {d: make_simulation(spec, cfg, device=d) for d in ("cuda", "cpu")}
    st = {d: e.init() for d, e in engs.items()}
    cuda.reset_launches()
    for _ in range(8):
        blk = {}
        for d, e in engs.items():
            st[d], blk[d] = e.window(st[d])
        assert torch.equal(blk["cuda"].cpu(), blk["cpu"])
        assert torch.equal(st["cuda"].ring.cpu(), st["cpu"].ring)
    assert cuda.launches["spike_deliver"] > 0
    assert (cuda.launches["lif_update"] > 0) == (model == "lif")


# (A, n, K): n not a multiple of 32 and K % 4 != 0 (chunks straddle areas,
# scalar src loads); and more 32-row chunks than the H100's 8,448
# co-resident warps (two 1024-thread blocks on each of 132 SMs), K % 4 == 0.
WINDOW_SHAPES = [(3, 1000, 333), (3, 100_003, 12)]
D_WIN, LO, SPAN = 10, 1, 30


def window_tables(dev, a, n, k, delay_dtype, seed, d_win=D_WIN):
    """Grid weights and fut (no -0.0, which no engine ring holds), delays
    reaching past both ends of the window."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return dict(
        fut=t((np.round(rng.normal(0, 300, (a, n, d_win + LO + SPAN - 1)) * 4) / 1024 + 0.0)
              .astype(np.float32)),
        alive=t(rng.random((a, n)) < 0.9),
        src=t(rng.integers(0, n, (a, n, k)).astype(np.int32)),
        w=t((np.round(rng.normal(0, 60, (a, n, k)) * 256) / 256).astype(np.float32)),
        delay=t(rng.integers(LO - 1, LO + SPAN + 2, (a, n, k)).astype(delay_dtype)))


def chunks_exceed_warps(a, n):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-a * n // 32) > sms * 64


def same(got, want):
    """Bitwise: dtype, shape and bytes (so -0.0 != +0.0)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=["ragged", "many_chunks"])
def test_superstep_lif_kernel_matches_plain(dev, shape, delay_dtype):
    a, n, k = shape
    x = window_tables(dev, a, n, k, delay_dtype, seed=5)
    rng = np.random.default_rng(6)
    t = lambda y: torch.from_numpy(y).to(dev)  # noqa: E731
    v = t(rng.uniform(0, 15, (a, n)).astype(np.float32))
    i_syn = t(rng.normal(6000, 2000, (a, n)).astype(np.float32))
    refrac = t(rng.integers(0, 25, (a, n)).astype(np.int32))
    drive_p = t(rng.uniform(0, 0.5, (a, n)).astype(np.float32))
    gids = torch.arange(a * n, dtype=torch.int32, device=dev).view(a, n)
    p = LIFParams()
    kw = dict(d_win=D_WIN, steps_lo=LO, r_span=SPAN, p11=p.p11, p21=p.p21, p22=p.p22,
              v_th=p.v_th_mv, v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps,
              seed=42, w_ext=87.75)
    args = lambda fut: (v, i_syn, refrac, fut, drive_p, gids, x["alive"],  # noqa: E731
                        x["src"], x["w"], x["delay"], 1230)
    before = cuda.launches["superstep_lif"]
    got = cyc.superstep_lif_cuda(*args(x["fut"].clone()), **kw)
    torch.cuda.synchronize()
    assert cuda.launches["superstep_lif"] == before + 1
    want = cyc.superstep_lif_plain(*args(x["fut"].clone()), **kw)
    same(got, want)
    assert bool((want[4].sum(dim=(1, 2)) > 0).all()), "every cycle must spike"
    if shape == WINDOW_SHAPES[1]:
        assert chunks_exceed_warps(a, n)


@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=["ragged", "many_chunks"])
def test_superstep_iaf_kernel_matches_plain(dev, shape, delay_dtype):
    a, n, k = shape
    x = window_tables(dev, a, n, k, delay_dtype, seed=7)
    rng = np.random.default_rng(8)
    countdown = torch.from_numpy(rng.integers(0, 2 * D_WIN, (a, n)).astype(np.int32)).to(dev)
    interval = torch.from_numpy(rng.integers(1, 13, (a, n)).astype(np.int32)).to(dev)
    args = lambda fut: (countdown, fut, interval, x["alive"], x["src"], x["w"],  # noqa: E731
                        x["delay"])
    kw = dict(d_win=D_WIN, steps_lo=LO, r_span=SPAN)
    before = cuda.launches["superstep_iaf"]
    got = cyc.superstep_iaf_cuda(*args(x["fut"].clone()), **kw)
    torch.cuda.synchronize()
    assert cuda.launches["superstep_iaf"] == before + 1
    want = cyc.superstep_iaf_plain(*args(x["fut"].clone()), **kw)
    same(got, want)
    assert bool((want[2].sum(dim=(1, 2)) > 0).all()), "every cycle must spike"
    if shape == WINDOW_SHAPES[1]:
        assert chunks_exceed_warps(a, n)


# The redesigned superstep_iaf's regimes: (A, n, K, D). K = 3000 spans
# five 512-synapse ring stages and a partial one; K = 333 (K % 4 != 0)
# takes the ordinary-load path; 800,000 neurons give a bitmask too large
# for shared memory beside the rings and queues (the limit is ~635,000 at
# D = 10, r_span = 30).
IAF_REGIMES = {
    "none_fire": (3, 1000, 3000, D_WIN),
    "all_fire_every_cycle": (3, 1000, 3000, D_WIN),
    "d_32": (3, 1000, 3000, 32),
    "k_3000_5pct": (3, 2000, 3000, D_WIN),
    "k_333_all_fire": (3, 1000, 333, D_WIN),
    "mask_beyond_smem": (2, 400_000, 8, D_WIN),
}


@pytest.mark.parametrize("regime", list(IAF_REGIMES))
def test_superstep_iaf_kernel_regimes(dev, regime):
    """Bitwise against the plain version: no source fires (fut unchanged,
    zero rows included), all fire in every cycle (full queues on every
    chunk), D = 32 (full 32-bit patterns), K = 3000, K = 333, a bitmask read
    through L2; delays reach outside the window in every regime."""
    a, n, k, d_win = IAF_REGIMES[regime]
    x = window_tables(dev, a, n, k, np.int8, seed=9, d_win=d_win)
    x["fut"][0, :10] = 0.0
    rng = np.random.default_rng(10)
    ints = lambda lo, hi: torch.from_numpy(  # noqa: E731
        rng.integers(lo, hi, (a, n)).astype(np.int32)).to(dev)
    if regime == "none_fire":
        countdown, interval = ints(d_win, 4 * d_win), ints(1, 13)
    elif regime in ("all_fire_every_cycle", "k_333_all_fire"):
        countdown, interval = ints(0, 1), ints(1, 2)
    elif regime == "d_32":
        countdown = ints(0, 40)
        interval = torch.where(torch.from_numpy(rng.random((a, n)) < 0.3).to(dev), 1,
                               ints(2, 12))
    else:
        countdown, interval = ints(0, 200), ints(1, 13)
    outside = (x["delay"] < LO) | (x["delay"] >= LO + SPAN)
    assert bool(outside.any()) and not bool(outside.all())
    lib = cuda.library("superstep_iaf")
    assert lib.superstep_iaf_mask_in_smem(a * n, d_win, SPAN) == (regime != "mask_beyond_smem")
    args = lambda fut: (countdown, fut, interval, x["alive"], x["src"], x["w"],  # noqa: E731
                        x["delay"])
    kw = dict(d_win=d_win, steps_lo=LO, r_span=SPAN)
    before = cuda.launches["superstep_iaf"]
    got = cyc.superstep_iaf_cuda(*args(x["fut"].clone()), **kw)
    torch.cuda.synchronize()
    assert cuda.launches["superstep_iaf"] == before + 1
    want = cyc.superstep_iaf_plain(*args(x["fut"].clone()), **kw)
    same(got, want)
    spikes = want[2]
    if regime == "none_fire":
        assert not bool(spikes.any())
        same(got[1:2], (x["fut"],))
    elif regime in ("all_fire_every_cycle", "k_333_all_fire"):
        assert bool((spikes == x["alive"]).all())
    elif regime == "d_32":
        assert bool(spikes.all(dim=0).any()), "some source must fire in all 32 cycles"
    else:
        assert bool((spikes.sum(dim=(1, 2)) > 0).all()), "every cycle must spike"


@pytest.mark.parametrize("case", ["ragged", "unaligned"])
def test_lif_update_kernel_on_ragged_and_unaligned_inputs(dev, case):
    """N % 4 != 0: the last neurons take the scalar tail. Views that start
    one element past a 16-byte boundary (1 byte for alive): the kernel
    launches on them and takes its scalar path for all of N; the wrapper
    does not refuse them."""
    rng = np.random.default_rng(11)
    n = 1001 if case == "ragged" else 4096
    p = LIFParams()
    kw = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
              v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps)
    xs = [torch.from_numpy(x).to(dev) for x in (
        rng.normal(13.0, 3.0, n + 1).astype(np.float32),
        rng.normal(0.0, 300.0, n + 1).astype(np.float32),
        rng.integers(-1, 5, n + 1).astype(np.int32),
        rng.normal(0.0, 250.0, n + 1).astype(np.float32),
        rng.random(n + 1) < 0.9)]
    xs = [x[1:] if case == "unaligned" else x[:n] for x in xs]
    assert all(x.is_contiguous() and x.numel() == n for x in xs)
    if case == "unaligned":
        assert all(x.data_ptr() % 16 != 0 for x in xs[:4]) and xs[4].data_ptr() % 4 != 0
    before = cuda.launches["lif_update"]
    got = lif.lif_update_cuda(*xs, **kw)
    torch.cuda.synchronize()
    assert cuda.launches["lif_update"] == before + 1
    want = lif.lif_update_plain(*xs, **kw)
    assert int(want[3].sum()) > 0
    same(got, want)


@pytest.mark.parametrize("model", ["ignore_and_fire", "lif"])
def test_fused_engine_on_the_card_matches_the_cpu(dev, model):
    spec = mam_benchmark_spec(n_areas=4, n_per_area=64, k_intra=16, k_inter=16,
                              rate_hz=30.0 if model == "ignore_and_fire" else 2.5)
    cfg = EngineConfig(neuron_model=model, delivery_backend="pallas",
                       superstep_kernel=True)
    engs = {d: make_simulation(spec, cfg, device=d) for d in ("cuda", "cpu")}
    st = {d: e.init() for d, e in engs.items()}
    cuda.reset_launches()
    for _ in range(8):
        blk = {}
        for d, e in engs.items():
            st[d], blk[d] = e.window(st[d])
        assert torch.equal(blk["cuda"].cpu(), blk["cpu"])
        assert torch.equal(st["cuda"].ring.cpu(), st["cpu"].ring)
        for name in vars(st["cpu"].neuron):
            assert torch.equal(getattr(st["cuda"].neuron, name).cpu(),
                               getattr(st["cpu"].neuron, name))
    fused = "superstep_lif" if model == "lif" else "superstep_iaf"
    assert cuda.launches[fused] == 8 and cuda.launches["lif_update"] == 0


# flash_attention: (B, S, H, Hkv, Dh, window, k_len). G = H / Hkv in
# {1, 4, 7}; Dh in {64, 80, 128} (the published widths), 16 (the reduced
# configs) and 32; a window, k_len < Sk, and both together, where rows past
# k_len + window - 1 have no valid key and take the mean of v over all keys.
# The tensor-core route's edges: many 128-row tiles with G = 7 and diagonal
# tiles (S 2048), k_len not a multiple of its key tile (128 keys for Dh <= 64,
# 64 above), a window smaller than one key tile, and G = 1 at Dh 128.
FLASH_CASES = [
    (2, 1024, 14, 2, 64, 0, 1024),
    (1, 1024, 32, 8, 80, 300, 1024),
    (1, 512, 8, 8, 128, 0, 512),
    (2, 512, 7, 1, 64, 0, 389),
    (1, 1024, 4, 1, 80, 200, 700),
    (2, 64, 4, 2, 16, 5, 40),
    (1, 2048, 14, 2, 64, 0, 2048),
    (2, 512, 8, 2, 32, 0, 512),
    (1, 1024, 14, 2, 64, 0, 777),
    (1, 1024, 8, 2, 128, 0, 1000),
    (2, 1024, 14, 2, 64, 50, 1024),
    (1, 2048, 4, 4, 128, 0, 2048),
]


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    x = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    """f32: max abs difference <= 2e-5 (the JAX kernel test's bar). bf16:
    both compute in f32 and round once, so elementwise within one bf16 ulp
    of the larger of the two values plus the f32 bar (near zero, an f32
    difference of 1e-6 is many bf16 ulps)."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, hkv, dh, window, k_len = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
               for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    before = cuda.launches["flash_attention"]
    got = fa.flash_attention_cuda(q, k, v, window, k_len)
    torch.cuda.synchronize()
    assert cuda.launches["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, window, k_len)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
    else:
        bound = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + 2e-5
        assert bool((diff <= bound).all()), float((diff / bound).max())


def test_flash_attention_kernel_refuses_what_it_was_not_built_for(dev):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 64, 4, 48, device=dev)
    kv = torch.zeros(1, 64, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, kv, kv, 0, 64)
    q, kv = q[..., :16].half(), kv[..., :16].half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, kv, kv, 0, 64)


def test_flash_attention_bf16_route_refuses_what_it_was_not_built_for(dev):
    """The tensor-core route raises on a head dim it was not built for and
    on a tensor that is not contiguous or not 16-byte aligned; it never
    gives way to another."""
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 64, 4, 48, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 2, 48, device=dev, dtype=torch.bfloat16)
    before = cuda.launches["flash_attention"]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, kv, kv, 0, 64)
    q = torch.zeros(1, 4, 64, 64, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not contiguous"):
        fa.flash_attention_cuda(q, kv, kv, 0, 64)
    # Contiguous, but one element (2 bytes) past a 16-byte boundary: TMA
    # and the 16-byte Q loads cannot read it.
    q = torch.zeros(64 * 4 * 64 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 64, 4, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention_cuda(q, kv, kv, 0, 64)
    # The library refuses it too, without launching.
    lib = cuda.library("flash_attention")
    out = torch.empty(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    err = lib.flash_attention_launch(
        q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(), 1, 1, 64, 64, 4, 2, 64,
        0, 64, torch.cuda.current_stream(dev).cuda_stream)
    assert "misaligned" in lib.error_string(err).decode()
    assert cuda.launches["flash_attention"] == before


# event_deliver: (packet rows, S, N_src rows, K_out); K_out % 4 != 0 in the
# second and third.
EVENT_SHAPES = [(10, 300, 5000, 64), (4, 70, 2000, 333), (1, 1, 100, 7)]


def as_outgoing_rows(tgt):
    """Rows as the outgoing tables hold them (the kernel's precondition):
    real targets ascending, -1 padding at the end."""
    key = np.where(tgt < 0, np.iinfo(np.int64).max, tgt.astype(np.int64))
    key.sort(axis=1)
    return np.where(key == np.iinfo(np.int64).max, -1, key).astype(np.int32)


def event_inputs(dev, rows, s_max, n_src, k, delay_dtype, per_area, seed):
    """Outgoing tables with -1 padding (rows ascending, as built), grid
    weights, a ring without -0.0, and packets with real ids, padding ids
    (>= n_src and < 0) and repeats."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    n_tgt = n_src
    bound = n_src // rows if per_area else n_src
    tgt = rng.integers(0, bound, (n_src, k)).astype(np.int32)
    tgt[rng.random((n_src, k)) < 0.1] = -1
    ids = rng.integers(-3, bound + 5, (rows, s_max)).astype(np.int32)
    ring = np.round(rng.normal(0, 300, (n_tgt, 110)) * 4) / 1024 + 0.0
    return dict(
        ring=t(ring.astype(np.float32)), ids=t(ids), tgt=t(as_outgoing_rows(tgt)),
        w=t((np.round(rng.normal(0, 60, (n_src, k)) * 256) / 256).astype(np.float32)),
        d=t(rng.integers(1, 101, (n_src, k)).astype(delay_dtype)))


@pytest.mark.parametrize("per_area", [False, True], ids=["cycles", "areas"])
@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
@pytest.mark.parametrize("shape", EVENT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_event_deliver_kernel_matches_plain(dev, shape, delay_dtype, per_area):
    from repro_torch.kernels import event_deliver as evt

    rows, s_max, n_src, k = shape
    n_src -= n_src % rows
    x = event_inputs(dev, rows, s_max, n_src, k, delay_dtype, per_area, seed=sum(shape))
    kw = dict(rows_per_area=n_src // rows if per_area else None)
    before = cuda.launches["event_deliver"]
    got = evt.event_deliver_cuda(x["ring"].clone(), x["ids"], x["tgt"], x["w"], x["d"],
                                 1234, **kw)
    torch.cuda.synchronize()
    assert cuda.launches["event_deliver"] == before + 1
    want = evt.event_deliver_plain(x["ring"].clone(), x["ids"], x["tgt"], x["w"], x["d"],
                                   1234, **kw)
    same([got], [want])
    assert not torch.equal(want, x["ring"])


# Packet sizes (S of 4 rows, 160 to 192,000 entries, nearly all of them
# real) that make the kernel take both regimes, the unsliced one with 8 and
# 4 warps an entry and the sliced one with 8, 4, 2 and 1 parts a segment,
# with 3 resident 256-thread blocks per SM on the H100's 132 SMs (2 in the
# sliced regime).
@pytest.mark.parametrize("per_area", [False, True], ids=["cycles", "areas"])
@pytest.mark.parametrize("s_max", [40, 70, 250, 400, 800, 1500, 3000, 6000, 12000, 24000,
                                   48000])
def test_event_deliver_kernel_every_group_size_matches_plain(dev, s_max, per_area):
    from repro_torch.kernels import event_deliver as evt

    # 20,000 table and ring rows keep every partial sum far below 2^13, where
    # the ring's 1/1024 grid stays exact in f32, at 192,000 entries too.
    x = event_inputs(dev, 4, s_max, 20_000, 333, np.int8, per_area, seed=9)
    kw = dict(rows_per_area=5000 if per_area else None)
    got = evt.event_deliver_cuda(x["ring"].clone(), x["ids"], x["tgt"], x["w"], x["d"], 5,
                                 **kw)
    torch.cuda.synchronize()
    same([got], [evt.event_deliver_plain(x["ring"].clone(), x["ids"], x["tgt"], x["w"],
                                         x["d"], 5, **kw)])


@pytest.mark.parametrize("case", ["padding_only", "empty"])
def test_event_deliver_kernel_on_packets_without_spikes(dev, case):
    from repro_torch.kernels import event_deliver as evt

    x = event_inputs(dev, 10, 50, 1000, 37, np.int8, False, seed=5)
    ids = (torch.full_like(x["ids"], 1000) if case == "padding_only"
           else x["ids"][:, :0].contiguous())
    before = cuda.launches["event_deliver"]
    got = evt.event_deliver_cuda(x["ring"].clone(), ids, x["tgt"], x["w"], x["d"], 7)
    torch.cuda.synchronize()
    assert cuda.launches["event_deliver"] == before + (case == "padding_only")
    same([got], [x["ring"]])
    same([got], [evt.event_deliver_plain(x["ring"].clone(), ids, x["tgt"], x["w"], x["d"], 7)])


# Dense packets over rings of many slices: (ring rows, K_out, S of 4 rows).
# "three_l2": a ring of three times the L2 and 128,000 entries of 48
# targets, more than one add per ring sector; "parts": 3.5 slices of rings
# and 3,200 entries of 512 targets, few enough for several warps (parts) a
# segment; "odd_k": 3.5 slices, K_out 333 and tables whose element count is
# not a multiple of the 8 a vector load reads.
SLICING_CASES = {"three_l2": (None, 48, 32_000), "parts": (3.5, 512, 800),
                 "odd_k": (3.5, 333, 1600)}


def slicing_inputs(dev, case, delay_dtype, per_area, seed=11):
    """Inputs that the kernel slices (no knob sets that): beside random
    sources, one source whose targets straddle each slice boundary, 4,000
    sources that all target one hot row, twice each, and the tables' last
    row, fired, with no padding, so the kernel reads up to the tables'
    end."""
    from repro_torch.kernels import event_deliver as evt

    r, areas = 110, 4
    slices, k, s_max = SLICING_CASES[case]
    slice_rows = evt.slice_rows(r, dev)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    n = 3 * l2 // (4 * r) if slices is None else int(slices * slice_rows)
    n -= n % areas
    if case == "odd_k" and n * k % 8 == 0:
        n -= areas  # n % 8 == 4 then, and k is odd
    area = n // areas
    assert n // slice_rows >= 3
    x = event_inputs(dev, areas, s_max, n, k, delay_dtype, per_area, seed)
    tgt = x["tgt"].cpu().numpy()
    rng = np.random.default_rng(seed)
    special = []
    for b in range(slice_rows, n, slice_rows):  # a source at each boundary
        lo = b - k // 2 - (area * (b // area) if per_area else 0)
        row = np.clip(np.arange(lo, lo + k), 0, (area if per_area else n) - 1)
        src = b if per_area else int(rng.integers(0, n))
        tgt[src] = row
        special.append(src)
    hot = int(rng.integers(0, area if per_area else n))
    hot_src = rng.choice(area if per_area else n, 4000, replace=False)
    tgt[hot_src, :2] = hot
    tgt[hot_src] = as_outgoing_rows(tgt[hot_src])
    tgt[n - 1] = np.sort(rng.integers(0, area if per_area else n, k))
    x["tgt"] = torch.from_numpy(tgt).to(dev)
    ids = x["ids"].cpu().numpy()
    hot_ids = min(1000, s_max // 2)
    if per_area:  # each special source in its own area's packet
        for src in special:
            ids[src // area, int(rng.integers(0, s_max))] = src % area
        ids[0, s_max - hot_ids:] = hot_src[:hot_ids]  # area 0's rows hold the hot sources
        ids[areas - 1, -1] = area - 1
    else:
        ids[0, :len(special)] = special
        ids[1, :hot_ids] = hot_src[:hot_ids]
        ids[2, -1] = n - 1
    x["ids"] = torch.from_numpy(ids).to(dev)
    return x, slice_rows, l2


@pytest.mark.parametrize("per_area", [False, True], ids=["cycles", "areas"])
@pytest.mark.parametrize("delay_dtype", [np.int8, np.int32])
@pytest.mark.parametrize("case", list(SLICING_CASES))
def test_event_deliver_kernel_over_many_slices(dev, case, delay_dtype, per_area):
    """Rings of many slices, a quarter of the L2 each (the kernel derives
    that from the card): segments that straddle slice boundaries, one hot
    target row that takes thousands of adds, bitwise the plain version."""
    from repro_torch.kernels import event_deliver as evt

    x, slice_rows, l2 = slicing_inputs(dev, case, delay_dtype, per_area)
    n = x["ring"].shape[0]
    assert slice_rows == max(1, l2 // 4 // (110 * 4))
    if case == "three_l2":
        assert x["ring"].numel() * 4 >= 3 * l2 - 4 * 110 * 4
    if case == "odd_k":
        assert x["tgt"].numel() % 8 != 0
    kw = dict(rows_per_area=n // 4 if per_area else None)
    before = cuda.launches["event_deliver"]
    got = evt.event_deliver_cuda(x["ring"].clone(), x["ids"], x["tgt"], x["w"], x["d"], 77,
                                 **kw)
    torch.cuda.synchronize()
    assert cuda.launches["event_deliver"] == before + 1
    want = evt.event_deliver_plain(x["ring"].clone(), x["ids"], x["tgt"], x["w"], x["d"], 77,
                                   **kw)
    same([got], [want])
    assert not torch.equal(want, x["ring"])


# The development builds that force one regime, on a sparse packet (40
# entries a row) and a dense one (3,000): each regime on both.
@pytest.mark.parametrize("per_area", [False, True], ids=["cycles", "areas"])
@pytest.mark.parametrize("s_max", [40, 3000])
@pytest.mark.parametrize("regime", ["sliced", "unsliced"])
def test_event_deliver_forced_regimes_match_plain(dev, regime, s_max, per_area):
    from repro_torch.kernels import event_deliver as evt

    x = event_inputs(dev, 4, s_max, 20_000, 333, np.int32, per_area, seed=13)
    kw = dict(rows_per_area=5000 if per_area else None)
    before = dict(cuda.launches)
    got = evt.event_deliver_forced(regime, x["ring"].clone(), x["ids"], x["tgt"], x["w"],
                                   x["d"], 21, **kw)
    torch.cuda.synchronize()
    assert cuda.launches == before  # a measurement build: not counted
    same([got], [evt.event_deliver_plain(x["ring"].clone(), x["ids"], x["tgt"], x["w"],
                                         x["d"], 21, **kw)])


def test_event_deliver_kernel_ignores_what_its_scratch_holds(dev):
    """The scratch is kept between launches: its cursors may hold anything
    (positions left by another packet), and each launch leaves its two
    counters zero."""
    from repro_torch.kernels import event_deliver as evt

    x, _, _ = slicing_inputs(dev, "parts", np.int8, False)
    args = (x["ids"], x["tgt"], x["w"], x["d"], 77)
    want = evt.event_deliver_plain(x["ring"].clone(), *args)
    first = evt.event_deliver_cuda(x["ring"].clone(), *args)
    buf = evt._scratches[x["ring"].device, torch.cuda.current_stream(dev).cuda_stream]
    gen = torch.Generator(device=dev).manual_seed(5)
    buf[2:] = torch.randint(0, 600, (buf.numel() - 2,), device=dev, generator=gen)
    second = evt.event_deliver_cuda(x["ring"].clone(), *args)
    torch.cuda.synchronize()
    same([first, second], [want, want])
    assert buf[:2].tolist() == [0, 0]


def test_event_deliver_kernel_refuses_misaligned_tables(dev):
    from repro_torch.kernels import event_deliver as evt

    x = event_inputs(dev, 2, 16, 200, 37, np.int8, False, seed=3)
    before = cuda.launches["event_deliver"]
    for name in ("tgt", "w", "d"):
        y = dict(x)
        y[name] = torch.cat([x[name].view(-1)[:1], x[name].view(-1)])[1:].view(200, 37)
        with pytest.raises(ValueError, match=f"{name} must start on a"):
            evt.event_deliver_cuda(x["ring"].clone(), x["ids"], y["tgt"], y["w"], y["d"], 0)
    assert cuda.launches["event_deliver"] == before


def test_red_probe_is_not_a_launch_of_the_scatter(dev):
    from repro_torch.kernels import event_deliver as evt

    buf = torch.zeros(1 << 20, device=dev)
    before = dict(cuda.launches)
    evt.red_probe(buf, adds=4, threads=1024)
    torch.cuda.synchronize()
    assert float(buf.sum()) == 4 * 1024 and cuda.launches == before


# Event engine configs on the card against the CPU: (name, model, config).
EVENT_ENGINES = [
    ("iaf", "ignore_and_fire", {}),
    ("iaf_conventional", "ignore_and_fire", dict(schedule="conventional")),
    ("iaf_legacy", "ignore_and_fire", dict(superstep=False)),
    ("iaf_fused", "ignore_and_fire", dict(superstep_kernel=True)),
    ("iaf_adaptive", "ignore_and_fire", dict(adaptive_exchange=True, s_max_floor=4)),
    ("iaf_adaptive_overlap", "ignore_and_fire",
     dict(adaptive_exchange=True, overlap_exchange=True, s_max_floor=4)),
    ("iaf_overflow", "ignore_and_fire", dict(s_max_headroom=0.0, s_max_floor=1)),
    ("lif", "lif", dict(fused_update=True)),
    ("lif_fused", "lif", dict(superstep_kernel=True)),
    ("lif_overlap", "lif", dict(overlap_exchange=True)),
]


@pytest.mark.parametrize("name,model,kw", EVENT_ENGINES, ids=[c[0] for c in EVENT_ENGINES])
def test_event_engine_on_the_card_matches_the_cpu(dev, name, model, kw):
    spec = mam_benchmark_spec(n_areas=4, n_per_area=64, k_intra=16, k_inter=16,
                              rate_hz=30.0 if model == "ignore_and_fire" else 2.5)
    if name == "iaf_overflow":
        spec = mam_benchmark_spec(n_areas=2, n_per_area=64, k_intra=4, k_inter=4,
                                  rate_hz=2000.0)
    cfg = EngineConfig(neuron_model=model, delivery_backend="event", **kw)
    engs = {d: make_simulation(spec, cfg, device=d) for d in ("cuda", "cpu")}
    st = {d: e.init() for d, e in engs.items()}
    cuda.reset_launches()
    for _ in range(30 if model == "lif" else 8):  # LIF spikes from ~2 ms on
        blk = {}
        for d, e in engs.items():
            st[d], blk[d] = e.window(st[d])
        assert torch.equal(blk["cuda"].cpu(), blk["cpu"])
        assert torch.equal(st["cuda"].ring.cpu(), st["cpu"].ring)
        assert int(st["cuda"].overflow) == int(st["cpu"].overflow)
        for field in vars(st["cpu"].neuron):
            assert torch.equal(getattr(st["cuda"].neuron, field).cpu(),
                               getattr(st["cpu"].neuron, field))
    assert cuda.launches["event_deliver"] > 0 and cuda.launches["spike_deliver"] == 0
    assert (int(st["cpu"].overflow) > 0) == (name == "iaf_overflow")
    assert int(st["cpu"].spike_count.sum()) > 0


def test_card_state_with_a_device_overflow_round_trips_through_a_checkpoint(dev, tmp_path):
    """Static event packets that drop spikes keep ``overflow`` as an int32
    device scalar: save (host copies on the caller's thread) and
    ``restore_sim`` give back every leaf bitwise, on the card, and the
    resumed windows equal the uninterrupted ones."""
    from repro_torch.core import schedule as schedule_lib

    spec = mam_benchmark_spec(n_areas=2, n_per_area=64, k_intra=4, k_inter=4,
                              rate_hz=2000.0)
    net = build_network(spec, seed=12, outgoing=True, device=dev)
    eng = make_simulation(spec, EngineConfig(
        neuron_model="ignore_and_fire", delivery_backend="event", s_max_headroom=0.0,
        s_max_floor=1), net=net, device=dev)
    st = eng.init()
    for _ in range(3):
        st, _ = eng.window(st)
    assert isinstance(st.overflow, torch.Tensor) and st.overflow.is_cuda
    assert int(st.overflow) > 0
    ckpt = schedule_lib.SimCheckpointer(str(tmp_path), eng, net, every=0)
    ckpt.save(st)
    ckpt.close()
    back, info = schedule_lib.restore_sim(str(tmp_path), eng, net)
    assert info["step"] == 3 and back.t == st.t
    assert back.overflow.is_cuda and back.overflow.dtype == torch.int32
    for a, b in ((back.ring, st.ring), (back.spike_count, st.spike_count),
                 (back.neuron.countdown, st.neuron.countdown), (back.overflow, st.overflow)):
        assert a.is_cuda and torch.equal(a, b)
    for _ in range(3):
        st, blk = eng.window(st)
        back, blk_back = eng.window(back)
        assert torch.equal(blk, blk_back)
    assert torch.equal(back.ring, st.ring) and int(back.overflow) == int(st.overflow)


def test_launcher_on_the_card_matches_the_cpu(dev, tmp_path):
    """``python -m repro_torch.launch.simulate`` with ``--device cuda`` and
    ``--device cpu``: exit 0 and the same spike counts."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    counts = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.npz"
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate", "--device", device,
             "--areas", "4", "--n-per-area", "256", "--k", "64", "--backend", "event",
             "--compare", "--compare-adaptive", "--t-ms", "20", "--spikes-out", str(out)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
        assert run.returncode == 0, run.stderr
        counts[device] = np.load(out)["spike_count"]
    assert counts["cuda"].sum() > 0
    assert np.array_equal(counts["cuda"], counts["cpu"])


@pytest.mark.parametrize("schedule", ["structure_aware", "conventional"])
def test_mam_driver_on_the_card_matches_the_cpu(dev, schedule):
    """``repro_torch.mam_simulation.simulate`` (the paper's driver: the
    32-area MAM at scale 0.002, LIF on ``scatter``) on the card and on the
    CPU, 200 ms: the same per-area spike counts, ``t``, ring and neuron
    state, bitwise."""
    from repro_torch import mam_simulation
    from repro_torch.core import mam_spec

    spec = mam_spec(scale=0.002)
    cfg = EngineConfig(neuron_model="lif", schedule=schedule, delivery_backend="scatter")
    card = mam_simulation.simulate(spec, cfg, device=dev, t_ms=200.0)
    host = mam_simulation.simulate(spec, cfg, device="cpu", t_ms=200.0)
    assert host.counts.sum() > 0 and card.overflow == host.overflow == 0
    assert np.array_equal(card.counts, host.counts) and card.state.t == host.state.t
    assert torch.equal(card.state.ring.cpu(), host.state.ring)
    for leaf in ("v", "i_syn", "refrac"):
        assert torch.equal(getattr(card.state.neuron, leaf).cpu(),
                           getattr(host.state.neuron, leaf)), leaf


# ---------------------------------------------------------------------------
# LM training


def _train_run(arch, mode, device, steps=3):
    """Reduced ``arch`` in f32: ``steps`` steps of the sync trainer, or of
    the hierarchical one (2 pods, int8) and a sync, from the weights drawn
    on the CPU (seed 0) and the synthetic batches. Returns the per-step
    losses and grad norms and the final parameters, on the host."""
    import copy

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.hierarchical import HierarchicalConfig
    from repro_torch.train.steps import make_train_artifacts

    bundle = get_arch(arch, reduced=True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    hier = HierarchicalConfig(sync_every=steps, compression="int8") if mode == "hier" else None
    art = make_train_artifacts(bundle, opt_cfg, hier_cfg=hier, n_pods=2)
    params = copy.deepcopy(bundle.model.init_params(torch.Generator().manual_seed(0)))
    params = params.to(device).requires_grad_()
    opt = adamw_init(params, opt_cfg)
    if hier is not None:
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    ds = SyntheticLM(bundle.cfg.vocab, 32, 4, seed=2)
    out = []
    for step in range(steps):
        batch = host_batch(ds.batch(step), device, n_pods=None if hier is None else 2)
        params, opt, m = art.step_fn(params, opt, batch)
        out.append((m["loss"].cpu(), m["grad_norm"].cpu()))
    if hier is not None:
        params, sync = art.sync_fn(params, sync)
    return out, {n: p.detach().cpu() for n, p in params.named_parameters()}


def _params_close(got, want, *, steps, int8, lr=1e-3) -> None:
    """``tests/test_torch_train.py``'s bar for parameters after ``steps``
    AdamW steps: every element within ``2 * lr * steps`` (the normalised
    step can flip with the sign of a gradient within rounding of zero), and
    99% of them within 1e-5 of the largest parameter, plus one step of an
    int8 grid spanning ``2 * lr * steps`` after an int8 sync."""
    top = max(float(x.abs().max()) for x in want.values())
    bar = 1e-5 * top + (2 * lr * steps / 127 if int8 else 0.0)
    close = total = 0
    for name, x in want.items():
        err = (got[name] - x).abs()
        assert float(err.max()) <= 2 * lr * steps, name
        close += int((err <= bar).sum())
        total += err.numel()
    assert close >= 0.99 * total, close / total


@pytest.mark.parametrize("mode", ["sync", "hier"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmo-1b", "gemma3-27b"])
def test_train_steps_on_the_card_match_the_cpu(dev, arch, mode):
    """The training step (loss, autograd, AdamW, the int8 sync) card ==
    CPU: losses and grad norms within 1e-4 relative at every step, the
    parameters within ``tests/test_torch_train.py``'s bar; no kernel
    launches."""
    before = dict(cuda.launches)
    card, p_card = _train_run(arch, mode, dev)
    assert dict(cuda.launches) == before
    host, p_host = _train_run(arch, mode, "cpu")
    for (lc, gc), (lh, gh) in zip(card, host):
        assert float((lc - lh).abs().max() / lh.abs().max()) < 1e-4
        assert float((gc - gh).abs().max() / gh.abs().max()) < 1e-4
    _params_close(p_card, p_host, steps=3, int8=mode == "hier")


def _mesh_hier_run(mesh, device):
    """Reduced qwen2-0.5b in f32, the hierarchical int8 trainer (2 pods,
    sync every 2): 2 local steps, a sync, 1 more, from weights drawn on
    ``device`` (seed 0). On ``mesh`` (pod, data, model) = (2, 2, 1) this
    rank's shards and batch slice; without one the one-device trainer at
    ``n_micro`` 2. Returns the losses and the whole state, on the host."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.hierarchical import HierarchicalConfig
    from repro_torch.optim.tree import named_leaves
    from repro_torch.train.steps import make_train_artifacts

    bundle = get_arch("qwen2-0.5b", reduced=True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    art = make_train_artifacts(bundle, opt_cfg, mesh, batch_axes=("data",), n_pods=2,
                               n_micro=1 if mesh else 2,
                               hier_cfg=HierarchicalConfig(sync_every=2, compression="int8"))
    params = bundle.model.init_params(
        torch.Generator(device=device).manual_seed(0)).requires_grad_()
    opt = adamw_init(params, opt_cfg)
    sync = art.hier.init_sync_state(params)
    params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    params, opt, sync = art.shard(params, "params"), art.shard(opt, "opt"), art.shard(sync, "sync")
    ds = SyntheticLM(bundle.cfg.vocab, 32, 4, seed=2)
    losses = []
    for step in range(3):
        if step == 2:
            params, sync = art.sync_fn(params, sync)
        b = ds.batch(step)
        b = host_batch(b, mesh, ("data",), "pod") if mesh else host_batch(b, device, n_pods=2)
        params, opt, m = art.step_fn(params, opt, b)
        losses.append(m["loss"].cpu())
    state = {part: {n: x.detach().cpu() for n, x in named_leaves(art.gather(tree, part)).items()}
             for part, tree in (("params", params), ("opt", opt), ("sync", sync))}
    return losses, state


def train_mesh_rank(mesh, payload):
    """One rank of the card test's world, on the GPU."""
    return _mesh_hier_run(mesh, mesh.device)


def test_hierarchical_int8_on_four_gloo_ranks_on_the_card_is_bitwise_one_device(dev, tmp_path):
    """Four gloo ranks sharing the card run the hierarchical int8 trainer
    on (pod, data, model) = (2, 2, 1); every rank's losses and gathered
    parameters, moments, counts, anchor and residuals are bitwise the
    one-device trainer's on the card at ``n_micro`` 2."""
    from test_torch_comm import run_world

    losses, state = _mesh_hier_run(None, dev)
    ranks = run_world(tmp_path, (2, 2, 1), ("pod", "data", "model"),
                      "test_torch_cuda:train_mesh_rank", device=None)
    as_bytes = lambda x: x.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    for r, (got_losses, got_state) in enumerate(ranks):
        pod = r // 2
        for got, want in zip(got_losses, losses):
            assert torch.equal(as_bytes(got), as_bytes(want[pod:pod + 1])), r
        for part, tree in state.items():
            assert got_state[part].keys() == tree.keys()
            for n, x in tree.items():
                assert x.dtype == got_state[part][n].dtype, (r, n)
                assert torch.equal(as_bytes(got_state[part][n]), as_bytes(x)), (r, part, n)


def test_flash_attention_refuses_grad_on_the_card(dev):
    """The kernel has no backward: with an input that requires grad its
    entry point raises before any launch; under ``no_grad`` it launches."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 512, 2, 64, device=dev, generator=g).requires_grad_()
    k, v = (torch.randn(1, 512, 1, 64, device=dev, generator=g) for _ in range(2))
    before = cuda.launches["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, 0, 512)
    assert cuda.launches["flash_attention"] == before
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, 0, 512)
    assert cuda.launches["flash_attention"] == before + 1 and not out.requires_grad


# ---------------------------------------------------------------------------
# The six other LM families: MoE (llama4, grok), mamba2, zamba2, whisper and
# internvl, reduced, in f32, card == CPU


FAMILY_ARCHS = ["llama4-maverick-400b-a17b", "grok-1-314b", "mamba2-2.7b", "zamba2-1.2b",
                "whisper-medium", "internvl2-76b"]


def _family_run(bundle, params, toks, extra, device, calls):
    """Forward, then prefill of all but 4 tokens and 4 decode steps, on
    ``device``: the logits of each, and the routing recorded per call."""
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.train.steps import make_serve_artifacts

    moved = {k: v.to(device) for k, v in extra.items()}
    t = toks.to(device)
    out, routing = [], []
    with torch.inference_mode():
        out.append(bundle.model.forward(params, t, **moved)[0].cpu())
        routing.append(list(calls)); calls.clear()
        s = t.shape[1] - 4
        art = make_serve_artifacts(bundle, ShapeSpec("check", "prefill", t.shape[1], 2),
                                   cache_dtype=torch.float32)
        logits, state = art.prefill_fn(params, {"tokens": t[:, :s], **moved})
        out.append(logits.cpu())
        routing.append(list(calls)); calls.clear()
        for i in range(s, s + 4):
            logits, state = art.decode_fn(params, state, t[:, i:i + 1], i)
            out.append(logits.cpu())
            routing.append(list(calls)); calls.clear()
    return out, routing


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_the_card_matches_the_cpu(dev, arch, monkeypatch):
    """Reduced ``arch`` in f32, the same weights on both devices, with
    ``FLASH_THRESHOLD`` lowered to 16 so the transformer families' forward
    launches the kernel (``use_pallas_attention=True``): the forward within
    1e-4 of the largest logit, prefill + 4 decode steps within 5e-4; MoE
    outputs held only on rows whose expert choices agree."""
    import copy

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 16)
    pallas = arch in ("llama4-maverick-400b-a17b", "grok-1-314b", "internvl2-76b")
    bundle = get_arch(arch, reduced=True, **({"use_pallas_attention": True} if pallas else {}))
    gen = torch.Generator().manual_seed(0)
    host = bundle.model.init_params(gen)
    card = copy.deepcopy(host).to(dev)
    toks = torch.randint(0, bundle.cfg.vocab, (2, 32), generator=gen)
    extra = {n: torch.randn(make(2, 32).shape, generator=gen)
             for n, make in bundle.extra_inputs.items()}
    calls = routing_tap(monkeypatch)
    before = cuda.launches["flash_attention"]
    got, r_card = _family_run(bundle, card, toks, extra, dev, calls)
    assert cuda.launches["flash_attention"] - before == (bundle.cfg.n_layers if pallas else 0)
    want, r_host = _family_run(bundle, host, toks, extra, "cpu", calls)
    for i, (g, w) in enumerate(zip(got, want)):
        rows = torch.from_numpy(agreeing_rows(r_card[i], r_host[i])) if r_host[i] \
            else slice(None)
        err = float((g[rows] - w[rows]).abs().max() / w[rows].abs().max())
        assert err <= (1e-4 if i == 0 else 5e-4), (i, err)


def test_moe_forward_through_the_kernel_matches_the_streaming_path(dev, monkeypatch):
    """Reduced llama4 on the card in f32 with ``FLASH_THRESHOLD`` lowered:
    the kernel (one launch a layer, both the dense and the MoE sub-layer)
    against the streaming path within 1e-4 of the largest logit, where the
    expert choices agree."""
    import dataclasses

    import repro_torch.models.transformer as tr
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 16)
    plain = get_arch("llama4-maverick-400b-a17b", reduced=True)
    kernel = dataclasses.replace(plain, model=tr.Transformer(
        dataclasses.replace(plain.cfg, use_pallas_attention=True)))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = plain.model.init_params(gen)
    toks = torch.randint(0, plain.cfg.vocab, (2, 64), generator=gen, device=dev)
    calls = routing_tap(monkeypatch)
    with torch.inference_mode():
        before = cuda.launches["flash_attention"]
        got, _ = kernel.model.forward(params, toks)
        assert cuda.launches["flash_attention"] - before == plain.cfg.n_layers
        r_kernel = list(calls)
        calls.clear()
        want, _ = plain.model.forward(params, toks)
    rows = torch.from_numpy(agreeing_rows(r_kernel, calls))
    got, want = got.cpu()[rows], want.cpu()[rows]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
