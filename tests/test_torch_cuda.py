"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up jax for the rest of the suite.)

Tolerances: fp32 atol/rtol 1e-5 (summation order); bf16 atol/rtol 1e-2
(about one bf16 ulp, 2^-7 relative); int8 codes at most 1 apart in at most
1% of codes (a code moves only where its fp32 value sits within a
rounding error of a half-integer; chip_smoke.py reads the shares against
controls).
"""

import dataclasses

import numpy as np
import pytest
import torch

from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1568, 768), (3, 5, 100), (17, 4096),
                                   (2, 1280)])
def test_layernorm_kernel_matches_plain(shape, dtype, cuda):
    C = shape[-1]
    x = (_randn(shape, 0, cuda) * 2 + 0.5).to(dtype)
    w = _randn((C,), 1, cuda) * 0.2 + 1
    b = _randn((C,), 2, cuda) * 0.1
    before = ln.LAUNCHES
    got = ln.layernorm(x, w, b)
    torch.cuda.synchronize()
    assert ln.LAUNCHES == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               ln.layernorm_plain(x, w, b).float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_layernorm_kernel_out_dtype(cuda):
    x = _randn((64, 384), 3, cuda).bfloat16()
    w, b = torch.ones(384, device=cuda), torch.zeros(384, device=cuda)
    got = ln.layernorm(x, w, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, ln.layernorm_plain(
        x, w, b, out_dtype=torch.float32), **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", [(2, 1568, 12, 64), (2, 200, 2, 64),
                                         (3, 97, 16, 80), (1, 130, 3, 128),
                                         (2, 33, 4, 8)])
def test_attention_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    qkv = _randn((b, n, 3 * heads * d), 4, cuda).to(dtype)
    before = fa.LAUNCHES
    got = fa.flash_attention_qkv(qkv, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1 and got.dtype == dtype
    torch.testing.assert_close(
        got.float(), fa.flash_attention_qkv_plain(qkv, heads, d ** -0.5
                                                  ).float(), **TOL[dtype])


@pytest.mark.cuda
def test_attention_kernel_rejects_unsupported_head_dim(cuda):
    qkv = torch.zeros((1, 8, 3 * 2 * 12), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_qkv(qkv, 2, 0.25)


@pytest.mark.cuda
def test_tiny_vit_forward_goes_through_kernels(cuda):
    from simple_tad_tpu_torch.models import create_model
    model = create_model("vit_small_patch16_224", device=cuda,
                         generator=torch.Generator().manual_seed(0),
                         img_size=32, depth=2, dtype=torch.bfloat16,
                         init_scale=1.0)
    x = _randn((2, 16, 32, 32, 3), 5, cuda)
    ln_before, fa_before = ln.LAUNCHES, fa.LAUNCHES
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    assert ln.LAUNCHES - ln_before == 5 and fa.LAUNCHES - fa_before == 2
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


I8_SHARE = 0.01


def _code_diff(got, want):
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1568, 768), (3, 5, 384), (17, 100),
                                   (2, 1280)])
def test_layernorm_quant_kernel_matches_plain(shape, dtype, cuda):
    C = shape[-1]
    x = (_randn(shape, 6, cuda) * 2 + 0.5).to(dtype)
    w = _randn((C,), 7, cuda) * 0.2 + 1
    b = _randn((C,), 8, cuda) * 0.1
    amax = ln.layernorm_plain(x, w, b, out_dtype=torch.float32).abs().max()
    before = ln.QUANT_LAUNCHES
    got = ln.layernorm_quant(x, w, b, amax)
    torch.cuda.synchronize()
    assert ln.QUANT_LAUNCHES == before + 1 and got.dtype == torch.int8
    worst, share = _code_diff(got, ln.layernorm_quant_plain(x, w, b, amax))
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


def _qkv_i8(b, n, heads, d, seed, device):
    qkv = _randn((b, n, 3 * heads * d), seed, device)
    amax = qkv.view(b, n, 3, heads, d).abs().amax(dim=(0, 1, 4))
    inv = (127.0 / amax).reshape(-1).repeat_interleave(d)
    return torch.clamp(torch.round(qkv * inv), -127, 127).to(torch.int8), amax


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d", [(2, 1568, 12, 64), (2, 200, 2, 64),
                                         (3, 97, 16, 80), (1, 130, 3, 128),
                                         (2, 33, 4, 16)])
def test_attention_i8_kernel_matches_plain(b, n, heads, d, cuda):
    qkv_i8, amax = _qkv_i8(b, n, heads, d, 9, cuda)
    scale = d ** -0.5
    out_amax = fa.attention_i8_plain_f32(qkv_i8, amax, heads,
                                         scale).abs().max()
    before = fa.I8_LAUNCHES
    got = fa.flash_attention_qkv_i8d(qkv_i8, amax, heads, scale, out_amax)
    torch.cuda.synchronize()
    assert fa.I8_LAUNCHES == before + 1 and got.dtype == torch.int8
    want = fa.flash_attention_qkv_i8d_plain(qkv_i8, amax, heads, scale,
                                            out_amax)
    worst, share = _code_diff(got, want)
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


@pytest.mark.cuda
def test_attention_i8_kernel_rejects_unsupported_head_dim(cuda):
    qkv = torch.zeros((1, 8, 3 * 2 * 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_qkv_i8d(qkv, torch.ones(3, 2, device=cuda), 2,
                                   0.2, torch.ones((), device=cuda))


@pytest.mark.cuda
def test_tiny_int8_vit_forward_goes_through_kernels(cuda):
    """Static int8 ViT-S (2 layers) calibrated on one batch: each forward
    runs the LayerNorm->int8 kernel twice and the int8 attention once per
    block, the LayerNorm kernel once (fc_norm) and never the bf16
    attention."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    masters = create_model("vit_small_patch16_224", device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           img_size=32, depth=2, init_scale=1.0)
    cfg = dataclasses.replace(masters.cfg, dtype=torch.bfloat16)
    x = _randn((2, 32, 384), 10, cuda).bfloat16()
    model = quantize_and_calibrate(cfg, masters.state_dict(), [x],
                                   device=cuda, tokens_input=True)
    counts = (ln.LAUNCHES, ln.QUANT_LAUNCHES, fa.LAUNCHES, fa.I8_LAUNCHES)
    with torch.inference_mode():
        logits = model(x, tokens_input=True)
    torch.cuda.synchronize()
    after = (ln.LAUNCHES, ln.QUANT_LAUNCHES, fa.LAUNCHES, fa.I8_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 4, 0, 2)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
