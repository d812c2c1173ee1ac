"""Port separate-operand attention (ops.flash_attention.flash_attention and
flash_attention_i8d), RMSNorm->int8 (ops.ln.rmsnorm_quant) and their
dispatch (ops.attention) against the JAX package's Pallas kernels in
interpret mode: the key-grid kernels (SIMPLE_TAD_ATTN_KV_GRID forces the
grid InternVideo2's N = 2049 takes) and the single-pass ones, B=2, H=2.

Tolerances, each with its reason:
  * bf16/fp32 attention: fp32 atol/rtol 3e-5, bf16 atol 2e-2 (as
    tests/test_torch_attention.py: summation order; one bf16 ulp);
  * int8 attention codes: at most 1 apart, at most 1% of codes apart (a
    code moves only where its fp32 value sits within a rounding error of a
    half-integer), and a control (probabilities not rounded to bf16) that
    exceeds the share;
  * RMSNorm->int8 codes: equal bit for bit (the same fp32 operations in
    the same order; read on this CPU, no code differs).
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from simple_tad_tpu.ops.flash_attention import (
    flash_attention_i8d as jax_flash_attention_i8d)
from simple_tad_tpu.ops.ln import fused_rmsnorm_quant
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln
from simple_tad_tpu_torch.ops.attention import (dot_product_attention,
                                                dot_product_attention_i8_sep,
                                                quantize_per_head)

B, H = 2, 2
DTYPES = {"float32": (torch.float32, jnp.float32, 3e-5, 3e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 0.0)}
CODE_SHARE = 0.01


def code_diff(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d > 0).mean())


def _qkv(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, 3 * H * d)).astype(np.float32)


@pytest.fixture(params=["single_pass", "2", "3"])
def kv_grid(request, monkeypatch):
    """The JAX launcher's plan: single-pass, or a forced key grid of 2 or 3
    steps (the 2049-token plan's kernel at a small N)."""
    if request.param != "single_pass":
        monkeypatch.setenv("SIMPLE_TAD_ATTN_KV_GRID", request.param)
    return request.param


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_sep_matches_pallas_kernel(dtype, kv_grid):
    """q and k contiguous, v read in place as the column block of the qkv
    tensor (row stride 3C), against the JAX flash_attention on the same
    values."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    d, n = 64, 130
    C = H * d
    qkv = torch.from_numpy(_qkv(n, d)).to(tdt)
    q, k = qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous()
    v = qkv[..., 2 * C:]
    assert v.stride(1) == 3 * C
    # each JAX call is one jitted program: the interpret-mode kernels' host
    # callbacks then run inside one dispatch (eager op-by-op dispatch around
    # them can deadlock on a loaded CPU)
    fn = jax.jit(functools.partial(jax_flash_attention, scale=d ** -0.5))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(jnp.asarray(t.float().reshape(B, n, H, d).numpy()
                                ).astype(jdt) for t in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32)).reshape(B, n, C)
    got = dot_product_attention(q, k, v, num_heads=H, scale=d ** -0.5)
    assert got.dtype == tdt and got.shape == (B, n, C)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(
        got, fa.flash_attention_qkv_plain(qkv, H, d ** -0.5), rtol=0, atol=0)


def _codes(n, d, seed):
    """int8 q, k, v (B, n, H*d) codes and a (3, H) absmax."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (3, B, n, H * d)).astype(np.int8)
    amax = rng.uniform(2.0, 6.0, (3, H)).astype(np.float32)
    return [torch.from_numpy(c) for c in codes], torch.from_numpy(amax)


def attention_i8d_control(q, k, v, amax, scale, out_amax, n_valid):
    """The plain separate-operand int8 attention without rounding the
    probabilities to bf16 before PV and the denominator."""
    qh, kh, vh = (t.view(B, t.shape[1], H, -1).transpose(1, 2)
                  for t in (q, k, v))
    kh, vh = kh[:, :, :n_valid], vh[:, :, :n_valid]
    sq, sk, sv = (amax * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    s = s * (sq * sk * scale * fa.LOG2E)
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    o = torch.matmul(p, (vh.float() * sv).to(torch.bfloat16).float())
    o = (o / p.sum(dim=-1, keepdim=True)).transpose(1, 2)
    return ln.quantize_static(o.reshape(q.shape), out_amax)


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_i8d_matches_pallas_kernel(d, masked, kv_grid):
    """Separate int8 operands against the JAX flash_attention_i8d with
    out_amax; ``masked``: keys at or beyond n_valid = N - 5 are masked (the
    TPU kernels' mask_keys); d = 40: the JAX launcher pads the head to 64,
    the port's kernel to 48, and zero codes keep both exact."""
    n = 136
    n_valid = n - 5 if masked else None
    (q, k, v), amax = _codes(n, d, seed=d + masked)
    scale = d ** -0.5
    out_amax = fa.attention_i8d_plain_f32(q, k, v, amax, H, scale,
                                          n_valid).abs().amax() * 0.9
    fn = jax.jit(functools.partial(jax_flash_attention_i8d, num_heads=H,
                                   scale=scale, n_valid=n_valid))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(jnp.asarray(t.numpy().reshape(B, n, H, d))
                    for t in (q, k, v)), jnp.asarray(amax.numpy()),
                  out_amax=jnp.asarray(out_amax.numpy()))
    want = np.asarray(want).reshape(B, n, H * d)
    got = fa.flash_attention_i8d(q, k, v, amax, H, scale, out_amax, n_valid)
    assert got.dtype == torch.int8 and got.shape == (B, n, H * d)
    assert np.abs(got.numpy()).max() == 127
    worst, share = code_diff(got.numpy(), want)
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    _, c_share = code_diff(attention_i8d_control(
        q, k, v, amax, scale, out_amax, n_valid).numpy(), want)
    assert c_share > CODE_SHARE, c_share


def test_attention_i8d_masks_keys_beyond_n_valid():
    """Masked keys are left out: changing them changes nothing."""
    (q, k, v), amax = _codes(40, 64, seed=9)
    args = (amax, H, 0.125, torch.tensor(0.4), 33)
    got = fa.flash_attention_i8d(q, k, v, *args)
    k2, v2 = k.clone(), v.clone()
    k2[:, 33:], v2[:, 33:] = 127, -127
    assert torch.equal(fa.flash_attention_i8d(q, k2, v2, *args), got)
    assert not torch.equal(fa.flash_attention_i8d(q, k2, v2, *args[:-1]),
                           got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 128), (7, 384)])
def test_rmsnorm_quant_matches_pallas_kernel(shape, dtype):
    """Per-head inverse scales (the q/k-norm sites), some below the largest
    |y| so codes clip; codes equal bit for bit."""
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    inv = np.repeat(127.0 / rng.uniform(1.5, 4.0, 2), C // 2).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    fn = jax.jit(functools.partial(fused_rmsnorm_quant, eps=1e-6))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                             jnp.asarray(inv)))
    got = ln.rmsnorm_quant(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                           torch.from_numpy(inv))
    assert got.dtype == torch.int8 and got.shape == shape
    assert np.abs(got.numpy()).max() == 127
    np.testing.assert_array_equal(got.numpy(), want)


def test_i8_sep_dispatch_quantizes_per_head():
    """dot_product_attention_i8_sep quantizes float operands per head as the
    JAX IV2Attention's q8 does (round half to even, clip at 127) and passes
    int8 codes through."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 24, H * 64)).astype(
        np.float32)) for _ in range(3))
    amax = torch.tensor([[2.0, 3.0], [2.5, 1.5], [3.0, 2.0]])
    out_amax = torch.tensor(0.5)
    q8 = quantize_per_head(q, amax[0], H)
    half = torch.tensor([[1.0 / 127, -3.0 / 127] * 64])  # exact halves
    assert torch.equal(quantize_per_head(half.expand(1, 1, -1) * 0.5,
                                         torch.ones(H), H).flatten()[:2],
                       torch.tensor([0, -2], dtype=torch.int8))
    inv = (127.0 / amax[0]).repeat_interleave(64)
    assert torch.equal(q8, torch.clamp(torch.round(q * inv), -127, 127).to(
        torch.int8))
    k8, v8 = quantize_per_head(k, amax[1], H), quantize_per_head(v, amax[2], H)
    want = fa.flash_attention_i8d_plain(q8, k8, v8, amax, H, 0.125, out_amax)
    for qq in (q, q8):
        got = dot_product_attention_i8_sep(qq, k, v, amax, out_amax,
                                           num_heads=H, scale=0.125)
        assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="head dim"):
        dot_product_attention_i8_sep(q[..., :12], k[..., :12], v[..., :12],
                                     amax, out_amax, num_heads=H, scale=0.2)


def test_cpu_tensors_take_plain_versions():
    """On the CPU the wrappers run the plain versions and count no launch;
    the separate-operand attention trains through FlashAttention (the
    plain C3) and refuses dropout."""
    (q, k, v), amax = _codes(40, 64, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 128)).astype(np.float32))
    f = torch.randn(B, 40, H * 64)
    before = (fa.SEP_LAUNCHES, fa.I8_SEP_LAUNCHES, ln.RMSQ_LAUNCHES)
    assert torch.equal(fa.flash_attention(f, f, f, H, 0.125),
                       fa.flash_attention_plain(f, f, f, H, 0.125))
    a8 = (q, k, v, amax, H, 0.125, torch.tensor(0.3))
    assert torch.equal(fa.flash_attention_i8d(*a8),
                       fa.flash_attention_i8d_plain(*a8))
    rq = (x, torch.ones(128), torch.full((128,), 40.0))
    assert torch.equal(ln.rmsnorm_quant(*rq), ln.rmsnorm_quant_plain(*rq))
    assert (fa.SEP_LAUNCHES, fa.I8_SEP_LAUNCHES, ln.RMSQ_LAUNCHES) == before
    counts = (fa.SEP_FWD_LSE_LAUNCHES, fa.SEP_BWD_LAUNCHES)
    out = fa.flash_attention(f.requires_grad_(), f, f, H, 0.125)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(),
                       fa.flash_attention_plain(*(f.detach(),) * 3, H, 0.125))
    out.sum().backward()
    assert (fa.SEP_FWD_LSE_LAUNCHES, fa.SEP_BWD_LAUNCHES) == counts
    with pytest.raises(NotImplementedError, match="C4"):
        dot_product_attention(f, f, f, num_heads=H, scale=0.1,
                              dropout_rate=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        ln.rmsnorm_quant(*(t.to("meta") for t in rq))
