"""The port's training attention and LayerNorm gradient
(simple_tad_tpu_torch.ops.flash_attention, ops.ln) against the JAX
package's packed training kernels in interpret mode.

The plain C1 (forward with lse) and C2 (backward) are held to
_flash_fwd_packed_qkv_impl and _flash_bwd_packed_qkv_impl, B=2, H=2,
Dh=64, N in {120, 136}, with several key blocks on the JAX side
(SIMPLE_TAD_ATTN_BWD_BQ=64).  Tolerances: fp32 out 3e-5 (as
tests/test_torch_attention.py), lse 1e-5, dqkv 1e-4 (the backward sums N
products per element in another order); bf16 out 2e-2 (one bf16 ulp at
|out| <= 4), lse 1e-4 (the same rounded probabilities summed in another
order), dqkv 3e-2 absolute plus 1e-2 relative (bf16 outputs, one ulp of
the largest gradients).  The CUDA kernels are held to the plain versions
on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops import flash_attention as jfa
from simple_tad_tpu.ops.ln import fused_layernorm
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln

B, H, D = 2, 2, 64
SCALE = D ** -0.5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(out=(3e-5, 3e-5), lse=(1e-5, 0.0), grad=(1e-4, 1e-4)),
       "bfloat16": dict(out=(2e-2, 0.0), lse=(1e-4, 0.0), grad=(3e-2, 1e-2))}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1], err_msg=msg)


def _jax_lse_to_bhn(lse):
    """JAX lse layout (B, head groups, N, heads per group) -> (B, H, N)."""
    b, ng, n, hpg = lse.shape
    return np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, ng * hpg, n)


@pytest.fixture
def several_key_blocks(monkeypatch):
    monkeypatch.setenv("SIMPLE_TAD_ATTN_BWD_BQ", "64")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [120, 136])
def test_plain_training_attention_matches_pallas(n, dtype,
                                                 several_key_blocks):
    tdt, jdt = DTYPES[dtype]
    tol = TOL[dtype]
    qkv = _rand((B, n, 3 * H * D), 0)
    dout = _rand((B, n, H * D), 1)
    jqkv = jnp.asarray(qkv).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = jfa._flash_fwd_packed_qkv_impl(jqkv, H, SCALE, 0)
        jgrad = jfa._flash_bwd_packed_qkv_impl(
            jqkv, jout, jlse, jnp.asarray(dout).astype(jdt), H, SCALE, 0)
    out, lse = fa.flash_attention_qkv_fwd_lse(
        torch.from_numpy(qkv).to(tdt), H, SCALE)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (B, H, n)
    _close(out.float(), jout.astype(jnp.float32), tol["out"], "out")
    _close(lse, _jax_lse_to_bhn(jlse), tol["lse"], "lse")
    # the backward on the JAX forward's own residuals
    got = fa.flash_attention_qkv_bwd(
        torch.from_numpy(qkv).to(tdt),
        torch.from_numpy(np.array(jout.astype(jnp.float32))).to(tdt),
        torch.from_numpy(_jax_lse_to_bhn(jlse)),
        torch.from_numpy(dout).to(tdt), H, SCALE)
    assert got.dtype == tdt and got.shape == (B, n, 3 * H * D)
    _close(got.float(), jgrad.astype(jnp.float32), tol["grad"], "dqkv")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_function_gradient_matches_jax_grad(dtype,
                                                      several_key_blocks):
    """FlashAttentionQKV through autograd against jax.grad of the JAX
    package's flash_attention_qkv (its packed custom VJP)."""
    tdt, jdt = DTYPES[dtype]
    n = 120
    qkv = _rand((B, n, 3 * H * D), 2)
    w = _rand((B, n, H * D), 3)

    def jloss(x):
        out = jfa.flash_attention_qkv(x, num_heads=H, scale=SCALE)
        return jnp.sum(out.astype(jnp.float32) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss)(jnp.asarray(qkv).astype(jdt))
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    before = fa.LAUNCHES
    (fa.flash_attention_qkv(x, H, SCALE).float()
     * torch.from_numpy(w)).sum().backward()
    assert fa.LAUNCHES == before          # the CPU takes the plain versions
    _close(x.grad.float(), want.astype(jnp.float32), TOL[dtype]["grad"])


def test_attention_function_gradcheck_float64():
    """The plain Function's analytic gradient in float64 against finite
    differences."""
    x = torch.from_numpy(_rand((1, 6, 3 * 2 * 8), 4)).double()
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: fa.FlashAttentionQKV.apply(t, 2, 8 ** -0.5), (x,),
        eps=1e-6, atol=1e-6)


def test_attention_without_grad_is_the_inference_path():
    x = torch.from_numpy(_rand((B, 32, 3 * H * D), 5))
    with torch.no_grad():
        got = fa.flash_attention_qkv(x.requires_grad_(True), H, SCALE)
    assert got.grad_fn is None
    assert torch.equal(got, fa.flash_attention_qkv_plain(x.detach(), H,
                                                         SCALE))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layernorm_gradient_matches_jax_grad(dtype, monkeypatch):
    """LayerNormFn's gradients against jax.grad of the JAX package's
    fused_layernorm (Pallas forward in interpret mode, its custom VJP).
    Tolerance: fp32 1e-5; bf16 dx 1e-2 (one bf16 ulp), dweight/dbias 1e-4
    relative (fp32 sums of bf16 products in another order)."""
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LN", "force")
    tdt, jdt = DTYPES[dtype]
    x = _rand((4, 32, 128), 6) * 2 + 0.5
    wgt = _rand((128,), 7) * 0.2 + 1
    bias = _rand((128,), 8) * 0.1
    g = _rand((4, 32, 128), 9)

    def jloss(x, s, b):
        y = fused_layernorm(x, s, b, eps=1e-6, out_dtype=jdt)
        return jnp.sum(y.astype(jnp.float32) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x).astype(jdt), jnp.asarray(wgt), jnp.asarray(bias))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(wgt).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = ln.LayerNormFn.apply(xt, wt, bt, 1e-6, tdt)
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == tdt and wt.grad.dtype == torch.float32
    dx_tol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-2)
    _close(xt.grad.float(), want[0].astype(jnp.float32), dx_tol, "dx")
    _close(wt.grad, want[1], (1e-4, 1e-4), "dweight")
    _close(bt.grad, want[2], (1e-4, 1e-4), "dbias")
