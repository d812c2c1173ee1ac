"""Port the static int8 ViT's two opt-in serving variants against the JAX
package's: the residual add + LayerNorm->int8 of the deferred-residual carry
(ops.ln.add_layernorm_quant, kernel E1; JAX fused_add_layernorm_quant,
Pallas _add_ln_quant_kernel) and the int8-compute attention
(ops.flash_attention.flash_attention_qkv_int8, kernel E2; JAX
flash_attention_qkv_int8, Pallas _fwd_kernel_int8_packed), each Pallas
kernel in interpret mode, on inputs made from a seed with numpy.  Then
their routes and the models that take them.

Tolerances, each with its reason:
  * E1's sum: equal bit for bit (one fp32 add rounded to the dtype on both
    sides);
  * E1's codes: at most 1 apart, in at most 1% of codes (the Pallas row
    sums run in another order, as at C = 640 in
    tests/test_torch_quant_vit.py); a control (the unbiased variance)
    beyond that share, and a gross one (the LayerNorm of the residual
    alone);
  * E2's bf16 outputs: where XLA's exp2 and torch's differ by an ulp, a
    probability code at a .5 boundary may flip.  One flipped code moves an
    output of a row by at most sv * 254 / (l - 1) (|v - out / sv| <= 254,
    l the row's code sum), plus a bf16 rounding of either side (2^-8 of
    the output, twice); at most 1% of outputs may differ.  The control (the
    probabilities left unrounded) and the max-free softmax of B2 (no
    maximum subtracted) exceed that share.  Against the numpy emulation of
    the JAX tests (its log2e applied after the subtraction, in float64):
    the JAX test's own bound, 2% of the largest output;
  * the add_lnq model equals the same static model without it exactly, on
    the CPU as on the card (the JAX package's own contract for the carry,
    tests/test_quant.py).
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops import attention as jax_attention
from simple_tad_tpu.ops.flash_attention import (
    flash_attention_qkv_int8 as jax_attention_int8)
from simple_tad_tpu.ops.ln import fused_add_layernorm_quant
from simple_tad_tpu_torch.models import create_model, layers
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln, quant
from simple_tad_tpu_torch.ops.attention import (
    dot_product_attention_qkv_int8, int8_attn_supported,
    quantize_per_head, static_attention_route)
from tests.test_torch_quant import (CODE_SHARE, _ln_inputs, code_diff,
                                    layernorm_quant_control)
from tests.test_torch_vit import TINY, one_torch_thread  # noqa: F401

OUT_SHARE = 0.01     # share of E2's bf16 outputs that may differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 37, 128), (3, 37, 768)])
def test_add_layernorm_quant_matches_pallas_kernel(shape, dtype):
    branch, w, b = _ln_inputs(shape, seed=1)
    residual = _ln_inputs(shape, seed=2)[0]
    amax = np.float32(3.0)         # below the largest |y|: some codes clip
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want_sum, want = fused_add_layernorm_quant(
            jnp.asarray(branch).astype(jdt), jnp.asarray(residual).astype(jdt),
            jnp.asarray(w), jnp.asarray(b), jnp.asarray(amax), eps=1e-6)
    bt, rt = (torch.from_numpy(t).to(tdt) for t in (branch, residual))
    args = (torch.from_numpy(w), torch.from_numpy(b), torch.tensor(amax))
    total, got = ln.add_layernorm_quant(bt, rt, *args)
    assert total.dtype == tdt and got.dtype == torch.int8
    assert total.shape == got.shape == shape
    np.testing.assert_array_equal(total.float().numpy(),
                                  np.asarray(want_sum, np.float32))
    assert np.abs(got.numpy()).max() == 127
    worst, share = code_diff(got.numpy(), np.asarray(want))
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    # the codes are B1's of the stored sum
    assert torch.equal(got, ln.layernorm_quant_plain(total, *args))
    for control in (layernorm_quant_control(total, *args),
                    ln.layernorm_quant_plain(rt, *args)):
        assert code_diff(control.numpy(), np.asarray(want))[1] > CODE_SHARE


def _int8_qkv(B, N, H, D, seed):
    """Random int8 codes and a (3, H) absmax drawn from U(0.5, 4), as the
    JAX package's test of the kernel draws them."""
    rng = np.random.default_rng(seed)
    qkv = rng.integers(-127, 128, (B, N, 3 * H * D)).astype(np.int8)
    amax = rng.uniform(0.5, 4.0, (3, H)).astype(np.float32)
    return qkv, amax


def _emulate_int8_attention(qkv_i8, amax, num_heads, scale):
    """Float emulation of the int8 static attention kernel's exact math
    (a copy of tests/test_flash_attention.py:_emulate_int8_attention)."""
    B, N, C3 = qkv_i8.shape
    C = C3 // 3
    D = C // num_heads
    q8 = qkv_i8[:, :, :C].astype(np.int32)
    k8 = qkv_i8[:, :, C:2 * C].astype(np.int32)
    v8 = qkv_i8[:, :, 2 * C:].astype(np.int32)
    out = np.zeros((B, N, C), np.float32)
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        sq = amax[0, h] / 127.0
        sk = amax[1, h] / 127.0
        sv = amax[2, h] / 127.0
        s = np.einsum("bnd,bmd->bnm", q8[:, :, sl], k8[:, :, sl])
        s = s.astype(np.float32) * (sq * sk * scale)
        m = s.max(axis=-1, keepdims=True)
        p8 = np.round(np.exp2((s - m) * 1.4426950408889634) * 127.0)
        o = np.einsum("bnm,bmd->bnd", p8, v8[:, :, sl]).astype(np.float32)
        l = p8.sum(axis=-1, keepdims=True).astype(np.float32)
        out[:, :, sl] = o / l * sv
    return out


def _int8_variant(qkv_i8, amax, heads, scale, *, round_p=True,
                  max_free=False):
    """The plain E2 with a required step left out -> bf16 (B, N, C): the
    probabilities not rounded to codes (``round_p=False``), or the row
    maximum not subtracted (``max_free``, B2's softmax: its integer running
    maximum gives the max-free result)."""
    q, k, v = fa._split_heads(qkv_i8, heads)
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * fa.LOG2E)
    m = torch.ceil(s.amax(dim=-1, keepdim=True)) if max_free \
        else s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * 127.0
    if round_p:
        p = torch.round(p)
    o = torch.matmul(p.double(), v.double()).float()
    return fa._merge_heads((o / p.sum(dim=-1, keepdim=True) * sv).to(
        torch.bfloat16))


def _code_effect(qkv_i8, amax, heads, scale):
    """(B, N, C) fp32: what one flipped probability code can move each
    output by, sv * 254 / (l - 1) of its row, plus a bf16 rounding of
    either side."""
    p, _, sv = fa.int8_attention_codes(qkv_i8, amax, heads, scale)
    l = p.sum(dim=-1, keepdim=True)
    D = qkv_i8.shape[-1] // 3 // heads
    return fa._merge_heads((sv * 254.0 / (l - 1)).expand(*l.shape[:-1], D))


def _out_diff(got, want):
    """-> (share of outputs that differ, |got - want| (B, N, C) fp32)."""
    d = (got.float() - want.float()).abs()
    return float((d > 0).float().mean()), d


@pytest.mark.parametrize("B,N,H,D", [(2, 256, 2, 64),    # the JAX test's
                                     (2, 131, 2, 64),    # JAX pads to 136
                                     (2, 96, 4, 32)])
def test_attention_int8_matches_pallas_kernel(B, N, H, D):
    scale = D ** -0.5
    qkv_i8, amax = _int8_qkv(B, N, H, D, seed=N + H)
    with pltpu.force_tpu_interpret_mode():
        want = torch.from_numpy(np.asarray(jax_attention_int8(
            jnp.asarray(qkv_i8), jnp.asarray(amax), num_heads=H,
            scale=scale), np.float32))
    q8, a = torch.from_numpy(qkv_i8), torch.from_numpy(amax)
    got = fa.flash_attention_qkv_int8(q8, a, H, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, H * D)
    share, d = _out_diff(got, want)
    bound = _code_effect(q8, a, H, scale) + want.abs() * 2 ** -7
    assert share <= OUT_SHARE and bool((d <= bound).all()), share
    for control in (_int8_variant(q8, a, H, scale, round_p=False),
                    _int8_variant(q8, a, H, scale, max_free=True)):
        assert _out_diff(control, want)[0] > OUT_SHARE
    emulated = _emulate_int8_attention(qkv_i8, amax, H, scale)
    np.testing.assert_allclose(got.float().numpy(), emulated,
                               atol=0.02 * np.abs(emulated).max(), rtol=0.02)


def test_int8_dispatch_and_gate(monkeypatch):
    """dot_product_attention_qkv_int8 quantizes float qkv per head as the
    int8-storage route does; int8_attn_supported and the 'int8' route
    follow the JAX gate (SIMPLE_TAD_FORCE_INT8_ATTN=1 off the TPU), whatever
    qkv_i8 says."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 48, 384)).astype(
        np.float32))
    amax = qkv.view(2, 48, 3, 2, 64).abs().amax(dim=(0, 1, 4))
    got = dot_product_attention_qkv_int8(qkv, amax, num_heads=2, scale=0.125)
    want = fa.flash_attention_qkv_int8_plain(
        quantize_per_head(qkv, amax.reshape(-1), 6), amax, 2, 0.125)
    assert torch.equal(got, want)
    geometries = [(1568, 768, 12), (1568, 768, 6), (1568, 1280, 16),
                  (8, 48, 2), (4608, 768, 12), (1568, 576, 9),
                  (4096, 768, 12), (4097, 768, 12), (200, 128, 16)]
    monkeypatch.setenv("SIMPLE_TAD_FORCE_INT8_ATTN", "1")
    for n, c, h in geometries:
        jax_gate = jax_attention.int8_attn_supported(n, c, h)
        assert int8_attn_supported(n, c, h) == jax_gate, (n, c, h)
        for qkv_i8 in (True, False):
            route = static_attention_route(n, c, h, qkv_i8, True)
            if jax_gate:
                assert route == "int8"
            else:
                assert route == static_attention_route(n, c, h, qkv_i8)
    assert static_attention_route(1568, 768, 12, True) == "i8"


def _static(cfg, state, x, **options):
    model = quant.quantize_and_calibrate(
        dataclasses.replace(cfg, **options), state, [x], device="cpu")
    with torch.inference_mode():
        return model, model(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_add_lnq_model_equals_unfused_exactly(dtype, monkeypatch):
    """The deferred-residual carry computes the static model's function bit
    for bit: the same logits with and without add_lnq, with 2 E1 calls a
    block on the CPU (the plain versions) and no LayerNorm->int8 call."""
    fp32 = create_model("vit_small_patch16_224", device="cpu",
                        generator=torch.Generator().manual_seed(5),
                        **dict(TINY, init_values=0.1))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 32, 32, 3)).astype(np.float32))
    cfg = dataclasses.replace(fp32.cfg, dtype=dtype)
    state = fp32.state_dict()
    _, base = _static(cfg, state, x)
    calls = {"add": 0, "lnq": 0}

    def counted(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(layers, "add_layernorm_quant",
                        counted("add", layers.add_layernorm_quant))
    monkeypatch.setattr(layers, "layernorm_quant",
                        counted("lnq", layers.layernorm_quant))
    model, got = _static(cfg, state, x, add_lnq=True)
    assert model._carry() and model.blocks[0].gamma_1 is not None
    assert calls == {"add": 2 * cfg.depth, "lnq": 0}
    assert torch.equal(got, base)
    # with int8_attn and the fused GEMMs as well: still exactly the model
    # without the carry
    _, want = _static(cfg, state, x, int8_attn=True, fused_w8a8=True,
                      fused_mlp=True)
    _, got = _static(cfg, state, x, int8_attn=True, fused_w8a8=True,
                     fused_mlp=True, add_lnq=True)
    assert torch.equal(got, want)


def test_add_lnq_leaves_other_widths_alone():
    """At a width whose norms are not LayerNorm->int8 (embed_dim % 128 !=
    0) the JAX program takes no carry, and neither does the port."""
    fp32 = create_model("vit_small_patch16_224", device="cpu",
                        generator=torch.Generator().manual_seed(6),
                        **dict(TINY, embed_dim=96, num_heads=2))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, 32, 32, 3)).astype(np.float32))
    state = fp32.state_dict()
    model, got = _static(fp32.cfg, state, x, add_lnq=True)
    assert not model._carry()
    assert torch.equal(got, _static(fp32.cfg, state, x)[1])


def test_layernorm_quant_with_residual_in_calib_mode():
    """The calibration twin of a norm given a residual (the JAX
    LayerNormQuant's calib branch): the plain add, then the LayerNorm, whose
    output absmax is recorded -> (sum, LayerNorm of the sum)."""
    norm = layers.LayerNormQuant(128, mode="calib")
    norm.init_weights()
    rng = np.random.default_rng(7)
    x, r = (torch.from_numpy(rng.standard_normal((3, 5, 128)).astype(
        np.float32)) for _ in range(2))
    total, y = norm(x, residual=r)
    assert torch.equal(total, r + x)
    assert torch.equal(y, norm(r + x))
    assert torch.equal(norm.observed["act_amax"], y.abs().amax())
