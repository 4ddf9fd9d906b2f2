"""The port's flash attention (plain version and dispatch) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Tolerance: max abs difference 2e-5, the JAX kernel test's bar
(tests/test_kernels.py); both sides compute in f32 and differ only in the
order of their sums. The split-P test holds bf16 outputs to the card tests'
bar: one bf16 ulp of the larger value + 2e-5, per element.
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as tl


def _qkv(rng, b, s, h, hkv, dh):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh))]


# The four cases of tests/test_kernels.py, and one where rows past
# k_len + window - 1 have no valid key at all.
@pytest.mark.parametrize("b,s,h,hkv,dh,window,klen", [
    (2, 64, 4, 2, 16, 0, 64),
    (1, 128, 8, 4, 32, 17, 128),
    (2, 64, 4, 2, 16, 0, 40),
    (1, 64, 2, 2, 16, 5, 64),
    (1, 64, 7, 1, 16, 5, 30),
])
def test_plain_matches_jax_kernel_in_interpret_mode(b, s, h, hkv, dh, window, klen):
    rng = np.random.default_rng(h * s + window)
    q, k, v = _qkv(rng, b, s, h, hkv, dh)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(window),
        jnp.int32(klen), bq=32, bk=32))
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), window, klen, bq=32, bk=32)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) < 2e-5


@pytest.mark.parametrize("window,klen", [(0, 1024), (300, 1024), (0, 700)])
def test_plain_at_default_blocks_matches_streaming_attention(window, klen):
    """512-row blocks (the kernel's defaults) against the port's streaming
    path, which the JAX package holds the kernel to."""
    rng = np.random.default_rng(window + klen)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 1024, 4, 2, 16))
    pos = torch.arange(1024, dtype=torch.int32).expand(1, 1024)
    got = flash_attention_plain(q, k, v, window, klen)
    want = tl._streaming_attention(q, k, v, pos, pos, klen, window)
    assert float((got - want).abs().max()) < 2e-5


def test_plain_and_kernel_wrapper_refuse_blocks_that_do_not_divide():
    """The JAX wrapper asserts Sq % bq == 0 and Sk % bk == 0 (bq, bk capped
    at the sequence length); the port raises for the same shapes."""
    q = torch.zeros(1, 600, 2, 16)
    kv = torch.zeros(1, 600, 1, 16)
    with pytest.raises(AssertionError):
        flash_attention_pallas(*(jnp.asarray(x.numpy()) for x in (q, kv, kv)),
                               jnp.int32(0), jnp.int32(600))
    with pytest.raises(ValueError, match="Sq % bq"):
        flash_attention_plain(q, kv, kv, 0, 600)
    with pytest.raises(ValueError, match="Sq % bq"):
        ops.flash_attention(q, kv, kv, 0, 600)
    flash_attention_plain(q[:, :500], kv[:, :500], kv[:, :500], 0, 500)  # bq = bk = 500


def test_ops_takes_the_plain_version_on_the_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(3)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 64, 4, 2, 16))
    before = dict(cuda.launches)
    got = ops.flash_attention(q, k, v, 0, 64)
    assert torch.equal(got, flash_attention_plain(q, k, v, 0, 64))
    assert cuda.launches == before
    # meta tensors (the dry run) take the kernel's meta rule: its output, no launch
    priced = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0, 64)
    assert priced.is_meta and priced.shape == q.shape and priced.dtype == q.dtype
    assert cuda.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(SimpleNamespace(device=torch.device("xpu"), requires_grad=False),
                            k, v, 0, 64)


def test_bf16_inputs_are_computed_in_f32_and_cast_once():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(rng, 1, 64, 4, 2, 16))
    got = flash_attention_plain(q, k, v, 0, 64)
    want = flash_attention_plain(q.float(), k.float(), v.float(), 0, 64).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _pv_emulated(q, k, v, window, k_len, *, split, bk):
    """flash_attention_plain's loop with P fed to the PV product as the
    tensor cores take it: rounded once to bf16, or split into two bf16 terms
    P_hi = bf16(P), P_lo = bf16(P - P_hi), both multiplied by V into one f32
    sum (the CUDA kernel's bf16 route)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4).float()
    q_pos = torch.arange(sq)[:, None]
    m = torch.full((b, hkv, g, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, dh))
    for k0 in range(0, sk, bk):
        kb = k[:, k0:k0 + bk].permute(0, 2, 1, 3).float()[:, :, None]
        vb = v[:, k0:k0 + bk].permute(0, 2, 1, 3).float()[:, :, None]
        logits = torch.matmul(qg, kb.transpose(-1, -2)) * scale
        k_pos = k0 + torch.arange(bk)[None, :]
        d = q_pos - k_pos
        mask = (d >= 0) & ((window <= 0) | (d < window)) & (k_pos < k_len)
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        p_hi = p.bfloat16().float()
        pv = torch.matmul(p_hi, vb)
        if split:
            pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


# Cases of tests/test_torch_cuda.py's FLASH_CASES with S cut to 256 (and
# windows and k_len with it).
@pytest.mark.parametrize("case", [
    (2, 256, 14, 2, 64, 0, 256),
    (1, 256, 32, 8, 80, 60, 256),
    (2, 256, 7, 1, 64, 0, 189),
    (1, 256, 4, 1, 80, 50, 170),
    (2, 64, 4, 2, 16, 5, 40),
], ids=lambda c: "x".join(map(str, c)))
def test_split_p_keeps_the_bf16_bar_and_single_rounding_does_not(case):
    """Why the kernel's bf16 route splits P: against the plain version (f32
    P), the split keeps every bf16 output within the card tests' bar (one
    bf16 ulp of the larger value + 2e-5); P rounded once to bf16, as a
    textbook tensor-core kernel does, puts several percent of the outputs
    outside it."""
    b, s, h, hkv, dh, window, k_len = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(rng, b, s, h, hkv, dh))
    want = flash_attention_plain(q, k, v, window, k_len, bk=64).float()

    def outside(split):
        got = _pv_emulated(q, k, v, window, k_len, split=split, bk=64).float()
        big = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
        bound = torch.exp2(torch.floor(torch.log2(big)) - 7) + 2e-5
        return float(((got - want).abs() > bound).float().mean())

    assert outside(split=True) == 0.0
    assert outside(split=False) > 0.01
