"""The port's flash attention (plain version and dispatch) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Tolerance: max abs difference 2e-5, the JAX kernel test's bar
(tests/test_kernels.py); both sides compute in f32 and differ only in the
order of their sums.
"""

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
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0, 64)


def test_bf16_inputs_are_computed_in_f32_and_cast_once():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(rng, 1, 64, 4, 2, 16))
    got = flash_attention_plain(q, k, v, 0, 64)
    want = flash_attention_plain(q.float(), k.float(), v.float(), 0, 64).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
