"""Port int8 ops (simple_tad_tpu_torch.ops.quant, ops.ln.layernorm_quant,
ops.flash_attention.flash_attention_qkv_i8d) against the JAX package's
(ops/quant.py; the Pallas kernels _ln_quant_kernel and
_fwd_kernel_nomax_packed_q8io in interpret mode).

Tolerances, each with its reason:
  * weight codes and scales: equal bit for bit (the same numpy math);
  * int8 GEMMs: the int32 products exact, the fp32 rescale within 1e-6
    relative (one fp32 rounding of the scale product);
  * int8 codes of LayerNorm->int8 and of the int8 attention: at most 1
    apart, and at most 1% of codes apart (a code moves only where the fp32
    value sits within a rounding error of a half-integer); each has a
    control, the plain version with one required step left out, that
    exceeds the share.
The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.ops import quant as jax_quant
from simple_tad_tpu.ops.flash_attention import (
    flash_attention_qkv_i8d as jax_attention_i8d)
from simple_tad_tpu.ops.ln import fused_layernorm_quant
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln, quant
from simple_tad_tpu_torch.ops.attention import (dot_product_attention_qkv_i8,
                                                static_attention_route)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import TINY, perturbed_jax_params

CODE_SHARE = 0.01      # share of int8 codes that may differ (by exactly 1)


def code_diff(got, want):
    """-> (largest |code difference|, share of codes that differ)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d > 0).mean())


def test_quantize_weight_matches_jax_bitwise():
    w = np.random.default_rng(0).normal(0, 0.05, (128, 384)).astype(
        np.float32)
    w[:, 3] = 0.0                                  # a dead output channel
    got_q, got_s = quant.quantize_weight(w)
    want_q, want_s = jax_quant.quantize_weight(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))


def test_quantize_vit_params_matches_jax_bitwise():
    """The port's codes and scales from the fp32 state dict are the JAX
    package's from the same fp32 params, bit for bit; a bf16 state (not
    the masters) is refused."""
    params = perturbed_jax_params(JaxViTConfig(**TINY), seed=3)
    got = quant.quantize_vit_params(tc.from_jax_params(params))
    want = tc.from_jax_params(jax_quant.quantize_vit_params(params))
    assert sorted(got) == sorted(want)
    n_q = 0
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy().view(np.uint8),
                                      want[key].numpy().view(np.uint8), key)
        n_q += key.endswith(".weight_q")
    assert n_q == 4 * TINY["depth"]
    bf16 = {k: v.bfloat16() for k, v in tc.from_jax_params(params).items()}
    with pytest.raises(TypeError, match="fp32 masters"):
        quant.quantize_vit_params(bf16)


def _gemm_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    w_q, w_s = quant.quantize_weight(rng.normal(0, 0.05, (k, n)))
    return x, w_q, w_s


@pytest.mark.parametrize("mode", ["dynamic", "static_float", "static_int8"])
def test_int8_matmul_matches_jax(mode):
    x, w_q, w_s = _gemm_inputs(24, 256, 128, seed=1)
    amax = np.float32(np.abs(x).max() * 0.9)       # clips a few inputs
    wt = torch.from_numpy(np.ascontiguousarray(w_q.T))
    if mode == "static_int8":
        x = np.clip(np.round(x * (127.0 / amax)), -127, 127).astype(np.int8)
    args = (jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_s))
    if mode == "dynamic":
        want = jax_quant.int8_matmul(*args)
        got = quant.int8_matmul(torch.from_numpy(x), wt, torch.from_numpy(w_s))
    else:
        want = jax_quant.int8_matmul_static(*args, jnp.asarray(amax))
        got = quant.int8_matmul_static(torch.from_numpy(x), wt,
                                       torch.from_numpy(w_s),
                                       torch.tensor(amax))
    assert got.dtype == torch.float32 and got.shape == (24, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


def test_int8_product_is_exact_at_k3072():
    """127^2 * 3072 > 2^24: the int32 product must not go through fp32.
    The port's int8 GEMM equals the int64 product; an fp32 matmul (the
    control) does not."""
    rng = np.random.default_rng(2)
    x = rng.choice(np.array([-127, 127], np.int8), (32, 3072))
    w = rng.choice(np.array([-127, 127], np.int8), (16, 3072))
    x[0], x[1] = w[0], w[1]
    x[0, 0] *= -1                 # |sums| of 25 significant bits
    x[1, :7] *= -1
    exact = x.astype(np.int64) @ w.astype(np.int64).T
    assert np.abs(exact).max() > 2 ** 24
    got = quant._int_mm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exact)
    control = torch.from_numpy(x).float() @ torch.from_numpy(w).float().T
    assert not np.array_equal(control.double().numpy(), exact)


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, w, b


def layernorm_quant_control(x, weight, bias, amax, eps=1e-6):
    """The plain LayerNorm->int8 with the unbiased variance."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    y = xc * torch.rsqrt(var + eps) * weight + bias
    return ln.quantize_static(y, amax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 128), (7, 384)])
def test_layernorm_quant_matches_pallas_kernel(shape, dtype):
    x, w, b = _ln_inputs(shape)
    amax = np.float32(3.0)         # below the largest |y|: some codes clip
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_layernorm_quant(
            jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b),
            jnp.asarray(amax), eps=1e-6))
    xt = torch.from_numpy(x).to(tdt)
    args = (torch.from_numpy(w), torch.from_numpy(b), torch.tensor(amax))
    got = ln.layernorm_quant(xt, *args)
    assert got.dtype == torch.int8 and got.shape == shape
    assert np.abs(got.numpy()).max() == 127
    worst, share = code_diff(got.numpy(), want)
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    _, c_share = code_diff(layernorm_quant_control(xt, *args).numpy(), want)
    assert c_share > CODE_SHARE, c_share


def _qkv_i8(n, heads=2, dim=64, batch=2, seed=0):
    """Per-head int8 codes of random qkv, with their (3, H) absmax."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch, n, 3 * heads * dim)).astype(np.float32)
    amax = np.abs(qkv.reshape(batch, n, 3, heads, dim)).max(
        axis=(0, 1, 4)).astype(np.float32)
    inv = np.repeat((127.0 / amax).reshape(-1), dim)
    return (np.clip(np.round(qkv * inv), -127, 127).astype(np.int8), amax,
            qkv)


def attention_i8_control(qkv_i8, amax, heads, scale, out_amax):
    """The plain int8 attention without rounding the probabilities to bf16
    before PV and the denominator."""
    B, N, C3 = qkv_i8.shape
    q, k, v = fa._split_heads(qkv_i8, heads)
    sq, sk, sv = (amax * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * fa.LOG2E)
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    vf = (v.float() * sv).to(torch.bfloat16).float()
    o = torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True)
    return ln.quantize_static(o.permute(0, 2, 1, 3).reshape(B, N, C3 // 3),
                              out_amax)


@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("n", [136, 200])
def test_attention_i8_matches_pallas_kernel(n, dim):
    """B2 against the JAX launcher, whose packed layout takes head dims
    that divide 128: ViT-B's 64 and 128 (the port's wide wgmma tiles on the
    card)."""
    heads = 2
    scale = dim ** -0.5
    qkv_i8, amax, _ = _qkv_i8(n, heads, dim)
    q8, a = torch.from_numpy(qkv_i8), torch.from_numpy(amax)
    out_amax = fa.attention_i8_plain_f32(q8, a, heads, scale).abs().max()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_attention_i8d(
            jnp.asarray(qkv_i8), jnp.asarray(amax), num_heads=heads,
            scale=scale, out_amax=jnp.asarray(out_amax.numpy())))
    got = fa.flash_attention_qkv_i8d(q8, a, heads, scale, out_amax)
    assert got.dtype == torch.int8 and got.shape == (2, n, heads * dim)
    assert np.abs(got.numpy()).max() == 127
    worst, share = code_diff(got.numpy(), want)
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    _, c_share = code_diff(
        attention_i8_control(q8, a, heads, scale, out_amax).numpy(), want)
    assert c_share > CODE_SHARE, c_share


def test_attention_i8_dispatch_quantizes_per_head():
    """dot_product_attention_qkv_i8 quantizes float qkv against the
    per-head absmax as the JAX Attention module does; head dims the
    int8-storage kernel cannot take have a route of their own, as in the
    TPU program (B3 where the packed kernel takes them, else bf16
    attention)."""
    qkv_i8, amax, qkv = _qkv_i8(48, seed=4)
    out_amax = torch.tensor(0.5)
    a = torch.from_numpy(amax)
    got = dot_product_attention_qkv_i8(torch.from_numpy(qkv), a, out_amax,
                                       num_heads=2, scale=0.125)
    want = fa.flash_attention_qkv_i8d_plain(torch.from_numpy(qkv_i8), a, 2,
                                            0.125, out_amax)
    assert torch.equal(got, want)
    # (N, C, H, qkv_i8) -> the JAX static ViT's branch on the TPU
    routes = {(1568, 768, 12, True): "i8",      # ViT-B
              (1568, 768, 12, False): "q8",     # SIMPLE_TAD_QKV_I8=0
              (1568, 768, 6, True): "q8",       # Dh 128
              (1568, 1280, 16, True): "float",  # ViT-H, Dh 80
              (8, 48, 2, True): "float",        # Dh 24
              (4608, 768, 12, True): "float",   # img_size 384
              (1568, 576, 9, True): "float"}    # C % 128 != 0
    for (n, c, h, i8), route in routes.items():
        assert static_attention_route(n, c, h, i8) == route, (n, c, h, i8)


def test_cpu_tensors_take_plain_versions():
    """On the CPU the wrappers run the plain versions: no kernel launch is
    counted, and the results are the plain results."""
    x, w, b = _ln_inputs((3, 128))
    qkv_i8, amax, _ = _qkv_i8(40, seed=5)
    before = (ln.QUANT_LAUNCHES, fa.I8_LAUNCHES)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            torch.tensor(2.5))
    assert torch.equal(ln.layernorm_quant(*args),
                       ln.layernorm_quant_plain(*args))
    a8 = (torch.from_numpy(qkv_i8), torch.from_numpy(amax), 2, 0.125,
          torch.tensor(0.3))
    assert torch.equal(fa.flash_attention_qkv_i8d(*a8),
                       fa.flash_attention_qkv_i8d_plain(*a8))
    assert (ln.QUANT_LAUNCHES, fa.I8_LAUNCHES) == before
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layernorm_quant(*(t.to("meta") for t in args))
