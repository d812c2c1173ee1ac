"""Port LayerNorm (simple_tad_tpu_torch.ops.ln) against the JAX package's
Pallas kernel (simple_tad_tpu.ops.ln.fused_layernorm, interpret mode).

Tolerances: fp32 atol 1e-5 (summation order); bf16 atol 2e-2, one bf16 ulp
at |y| <= 4 (the two frameworks may round the last bit differently).
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops.ln import fused_layernorm
from simple_tad_tpu_torch.ops import ln

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 40, 128), (7, 384)])
def test_layernorm_matches_pallas_kernel(shape, dtype):
    tdt, jdt, atol = DTYPES[dtype]
    x, w, b = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want = fused_layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                               jnp.asarray(b), eps=1e-6)
    want = np.asarray(want.astype(jnp.float32))
    got = ln.layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                       torch.from_numpy(b), eps=1e-6)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_layernorm_out_dtype():
    x, w, b = _inputs((5, 256), seed=1)
    got = ln.layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(b), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = ln.layernorm_plain(torch.from_numpy(x).bfloat16().float(),
                              torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_cpu_tensor_takes_plain_path():
    x, w, b = _inputs((3, 128))
    before = ln.LAUNCHES
    got = ln.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    assert ln.LAUNCHES == before
    want = ln.layernorm_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert torch.equal(got, want)


def test_other_device_raises():
    x = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layernorm(x, torch.ones(128, device="meta"),
                     torch.zeros(128, device="meta"))
