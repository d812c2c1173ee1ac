"""Port packed-qkv attention (simple_tad_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel (flash_attention_qkv, interpret
mode), B=2, H=2, Dh=64.

Tolerances: fp32 atol/rtol 3e-5 (as tests/test_flash_attention.py's packed
test); bf16 atol 2e-2 (one bf16 ulp at |out| <= 4).  The CUDA kernel
itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops.flash_attention import (
    flash_attention_qkv as jax_flash_attention_qkv)
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops.attention import dot_product_attention_qkv

B, H, D = 2, 2, 64
SCALE = D ** -0.5
DTYPES = {"float32": (torch.float32, jnp.float32, 3e-5, 3e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 0.0)}


def _qkv(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, 3 * H * D)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [136, 120, 32])   # 120: JAX zero-pads to 128
def test_attention_matches_pallas_kernel(n, dtype):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    qkv = _qkv(n)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_attention_qkv(jnp.asarray(qkv).astype(jdt),
                                       num_heads=H, scale=SCALE)
    want = np.asarray(want.astype(jnp.float32))
    got = fa.flash_attention_qkv(torch.from_numpy(qkv).to(tdt), H, SCALE)
    assert got.dtype == tdt and got.shape == (B, n, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


def test_plain_is_safe_from_exp2_overflow():
    """Scores far beyond exp2's fp32 range (the max-free TPU form would
    overflow) still give the softmax of the exact math."""
    qkv = torch.from_numpy(_qkv(48, seed=3)) * 40.0
    got = fa.flash_attention_qkv_plain(qkv, H, SCALE)
    q, k, v = qkv.view(B, 48, 3, H, D).permute(2, 0, 3, 1, 4).double()
    p = torch.softmax((q * SCALE) @ k.transpose(-1, -2), dim=-1)
    want = (p @ v).permute(0, 2, 1, 3).reshape(B, 48, H * D)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_dispatch_cpu_takes_plain_path():
    qkv = torch.from_numpy(_qkv(32))
    before = fa.LAUNCHES
    got = dot_product_attention_qkv(qkv, num_heads=H, scale=SCALE)
    assert fa.LAUNCHES == before
    assert torch.equal(got, fa.flash_attention_qkv_plain(qkv, H, SCALE))


def test_dispatch_rejects_dropout_and_other_devices():
    qkv = torch.from_numpy(_qkv(32))
    with pytest.raises(NotImplementedError):
        dot_product_attention_qkv(qkv, num_heads=H, scale=SCALE,
                                  dropout_rate=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_qkv(qkv.to("meta"), H, SCALE)
