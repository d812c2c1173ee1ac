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


# The persistent warp-a-row kernels of csrc/layernorm.cu: one row; a row
# count that is no multiple of a block's warps; more rows than the grid's
# warps (at most 132 SMs x 64); 1, 2 (lanes uneven at 384), 3 and 4 chunks
# a lane in registers (256, 384, 768, 1024), and wider rows read again at
# each pass (1280, 4096)
ROW_KERNEL_ROWS = [(1, 768), (133, 768), (9001, 768), (9001, 384)]
ROW_KERNEL_WIDTHS = [(97, 256), (61, 1024), (45, 1280), (33, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1568, 768), (3, 5, 384), (17, 100),
                                   (2, 1280)] + ROW_KERNEL_ROWS
                         + ROW_KERNEL_WIDTHS)
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


# Training attention (C1 forward with lse, C2 backward).  lse is fp32: in
# fp32 atol 1e-4 (a sum of up to N probabilities in another order); in bf16
# one probability may round to the other neighbour (its exp2 and the score
# sum run in another order), which moves lse by at most log2(1 + 2^-7) =
# 0.0112: atol 1.2e-2.  The fp32 backward sums up to N = 1568 products per
# element in another order than the plain version: atol/rtol 1e-4.
TRAIN_CASES = [(2, 1568, 12, 64), (2, 200, 2, 64), (3, 97, 16, 80),
               (1, 130, 3, 128), (2, 33, 4, 32)]
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=1.2e-2, rtol=0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", TRAIN_CASES)
def test_attention_fwd_lse_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    qkv = _randn((b, n, 3 * heads * d), 11, cuda).to(dtype)
    before = fa.FWD_LSE_LAUNCHES
    out, lse = fa.flash_attention_qkv_fwd_lse(qkv, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.FWD_LSE_LAUNCHES == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (b, heads, n)
    want_out, want_lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              d ** -0.5)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", TRAIN_CASES)
def test_attention_fwd_lse_out_is_the_inference_out(b, n, heads, d, dtype,
                                                    cuda):
    """C1 is A1 with an lse store: the same output, bit for bit."""
    qkv = _randn((b, n, 3 * heads * d), 16, cuda).to(dtype)
    out, _ = fa.flash_attention_qkv_fwd_lse(qkv, heads, d ** -0.5)
    assert torch.equal(out, fa.flash_attention_qkv(qkv, heads, d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", TRAIN_CASES)
def test_attention_bwd_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    scale = d ** -0.5
    qkv = _randn((b, n, 3 * heads * d), 12, cuda).to(dtype)
    dout = _randn((b, n, heads * d), 13, cuda).to(dtype)
    out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
    before = fa.BWD_LAUNCHES
    got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads, scale)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    want = fa.flash_attention_qkv_bwd_plain(qkv, out, lse, dout, heads, scale)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_function_gradients_match_plain_function(dtype, cuda,
                                                           monkeypatch):
    """Gradients through FlashAttentionQKV (kernels) equal those through the
    same Function routed to the plain versions."""
    b, n, heads, d = 2, 200, 4, 64
    x = _randn((b, n, 3 * heads * d), 14, cuda).to(dtype)
    w = _randn((b, n, heads * d), 15, cuda).to(dtype)

    def grad():
        qkv = x.clone().requires_grad_(True)
        (fa.flash_attention_qkv(qkv, heads, d ** -0.5).float()
         * w.float()).sum().backward()
        return qkv.grad

    counts = (fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES)
    got = grad()
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES) == (
        counts[0], counts[1] + 1, counts[2] + 1)
    monkeypatch.setattr(fa, "flash_attention_qkv_fwd_lse",
                        fa.flash_attention_qkv_fwd_lse_plain)
    monkeypatch.setattr(fa, "flash_attention_qkv_bwd",
                        fa.flash_attention_qkv_bwd_plain)
    want = grad()
    torch.testing.assert_close(got.float(), want.float(), **BWD_TOL[dtype])


@pytest.mark.cuda
def test_attention_bwd_kernel_rejects_bad_lse(cuda):
    qkv = torch.zeros((1, 8, 3 * 2 * 64), device=cuda, dtype=torch.bfloat16)
    out = torch.zeros((1, 8, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_qkv_bwd(qkv, out, torch.zeros(1, 2, 8, device=cuda,
                                                         dtype=torch.bfloat16),
                                   out, 2, 0.125)


@pytest.mark.cuda
def test_tiny_vit_train_step_goes_through_kernels(cuda):
    """One train step of a 2-layer ViT-S with fp32 masters computed in bf16
    runs C1 and C2 once per block (C2 on its wgmma kernels: head dim 64),
    the LayerNorm kernel 5 times and the inference attention never;
    gradients reach the fp32 masters."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    model = create_model("vit_small_patch16_224", device=cuda,
                         generator=torch.Generator().manual_seed(0),
                         img_size=32, depth=2, dtype=torch.bfloat16,
                         param_dtype=torch.float32, drop_path_rate=0.2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    state = TrainState.create(model, FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=1e-3, layer_decay=0.75,
        depth=2), gen)
    step = make_finetune_train_step(create_criterion("crossentropy"))
    batch = {"video": _randn((2, 16, 32, 32, 3), 17, cuda).bfloat16(),
             "label": torch.tensor([0, 1], device=cuda)}
    counts = (ln.LAUNCHES, fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES,
              fa.BWD_WGMMA_LAUNCHES, fa.BWD_MMA_LAUNCHES)
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    after = (ln.LAUNCHES, fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES,
             fa.BWD_WGMMA_LAUNCHES, fa.BWD_MMA_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (5, 0, 2, 2, 2, 0)
    assert torch.isfinite(metrics["loss"]) and logits.shape == (2, 2)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert not torch.equal(p, before[n]), n


# InternVideo2's separate-operand kernels: A1 on separate q/k/v with v read
# in place from the qkv tensor (row stride 3C), D2 (int8 storage, separate
# operands, keys masked at n_valid) and D3 (RMSNorm->int8).
SEP_CASES = [(2, 2049, 6, 64), (2, 200, 2, 64), (3, 97, 4, 80),
             (1, 130, 3, 128), (2, 33, 4, 8)]


def _sep_operands(b, n, heads, d, seed, device, dtype):
    """q, k contiguous (B, N, C) and v the strided column block of a
    (B, N, 3C) tensor, as InternVideo2's attention gives them."""
    C = heads * d
    qkv = _randn((b, n, 3 * C), seed, device).to(dtype)
    v = qkv[..., 2 * C:]
    assert v.stride(1) == 3 * C
    return qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(), v, qkv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", SEP_CASES)
def test_attention_sep_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    q, k, v, qkv = _sep_operands(b, n, heads, d, 18, cuda, dtype)
    before = fa.SEP_LAUNCHES
    got = fa.flash_attention(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.SEP_LAUNCHES == before + 1 and got.dtype == dtype
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, heads, d ** -0.5
                                              ).float(), **TOL[dtype])
    # the packed call reads the same values through one stride pair: the
    # same kernel, the same result bit for bit
    assert torch.equal(got, fa.flash_attention_qkv(qkv, heads, d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d,n_valid", [
    (2, 2049, 6, 64, None), (2, 2049, 6, 64, 2040), (2, 200, 2, 40, 190),
    (1, 130, 16, 88, None), (2, 33, 4, 16, 1)])
def test_attention_i8d_kernel_matches_plain(b, n, heads, d, n_valid, cuda):
    """v strided from an int8 (B, N, 3C) tensor; d = 40 runs padded to 48,
    d = 88 in place."""
    qkv_i8, amax = _qkv_i8(b, n, heads, d, 19, cuda)
    C = heads * d
    q, k, v = (qkv_i8[..., :C].contiguous(), qkv_i8[..., C:2 * C].contiguous(),
               qkv_i8[..., 2 * C:])
    scale = d ** -0.5
    out_amax = fa.attention_i8d_plain_f32(q, k, v, amax, heads, scale,
                                          n_valid).abs().max()
    before = fa.I8_SEP_LAUNCHES
    got = fa.flash_attention_i8d(q, k, v, amax, heads, scale, out_amax,
                                 n_valid)
    torch.cuda.synchronize()
    assert fa.I8_SEP_LAUNCHES == before + 1 and got.dtype == torch.int8
    want = fa.flash_attention_i8d_plain(q, k, v, amax, heads, scale,
                                        out_amax, n_valid)
    worst, share = _code_diff(got, want)
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


@pytest.mark.cuda
def test_attention_i8_packed_equals_separate_call(cuda):
    """B2's packed call and D2's separate call on views of one int8 qkv
    run the same kernel: the same codes bit for bit."""
    qkv_i8, amax = _qkv_i8(2, 300, 12, 64, 20, cuda)
    C = 768
    out_amax = torch.tensor(0.2, device=cuda)
    packed = fa.flash_attention_qkv_i8d(qkv_i8, amax, 12, 0.125, out_amax)
    sep = fa.flash_attention_i8d(qkv_i8[..., :C], qkv_i8[..., C:2 * C],
                                 qkv_i8[..., 2 * C:], amax, 12, 0.125,
                                 out_amax)
    assert torch.equal(packed, sep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4 * 2049, 384), (3, 5, 100), (17, 4096),
                                   (2, 1408)] + ROW_KERNEL_ROWS
                         + ROW_KERNEL_WIDTHS)
def test_rmsnorm_quant_kernel_matches_plain(shape, dtype, cuda):
    """Per-head inverse scales (6 heads' worth of columns, as at the q/k-norm
    sites); (3, 5, 100) takes the kernel for widths that are not a multiple
    of 8."""
    C = shape[-1]
    x = (_randn(shape, 21, cuda) * 2 + 0.5).to(dtype)
    w = _randn((C,), 22, cuda) * 0.2 + 1
    y = x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)) * w
    amax = y.reshape(-1, C).abs().amax(0)
    inv = 127.0 / amax.view(-1).max().expand(C).clone()
    inv[: C // 2] *= 1.3                          # some codes clip
    before = ln.RMSQ_LAUNCHES
    got = ln.rmsnorm_quant(x, w, inv)
    torch.cuda.synchronize()
    assert ln.RMSQ_LAUNCHES == before + 1 and got.dtype == torch.int8
    worst, share = _code_diff(got, ln.rmsnorm_quant_plain(x, w, inv))
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


def _tiny_iv2(device, **kw):
    from simple_tad_tpu_torch.models import create_model
    return create_model("internvideo2_small_patch14_224", device=device,
                        generator=torch.Generator().manual_seed(0),
                        img_size=28, num_frames=4, depth=2, init_scale=1.0,
                        init_values=0.1, **kw)


@pytest.mark.cuda
def test_tiny_iv2_forward_goes_through_kernels(cuda):
    """bf16 IV2-S (2 layers): one separate-operand attention launch per
    block, and no packed attention or LayerNorm kernel (its norms are plain
    PyTorch, as the JAX package leaves them to XLA)."""
    model = _tiny_iv2(cuda, dtype=torch.bfloat16)
    x = _randn((2, 4, 28, 28, 3), 23, cuda)
    counts = (ln.LAUNCHES, fa.LAUNCHES, fa.SEP_LAUNCHES)
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    after = (ln.LAUNCHES, fa.LAUNCHES, fa.SEP_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (0, 0, 2)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fused_rmsq", [False, True])
def test_tiny_int8_iv2_forward_goes_through_kernels(fused_rmsq, cuda):
    """Static int8 IV2-S (2 layers): D2 once per block, no bf16 attention;
    with fused_rmsq, D3 four times per block (norm1, norm2, q-norm,
    k-norm)."""
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    masters = _tiny_iv2("cpu")
    cfg = dataclasses.replace(masters.cfg, dtype=torch.bfloat16,
                              fused_rmsq=fused_rmsq)
    x = _randn((2, 16, 384), 24, cuda).bfloat16()
    model = quantize_and_calibrate(cfg, masters.state_dict(), [x],
                                   device=cuda, tokens_input=True)
    names = ("RMSQ_LAUNCHES", "I8_SEP_LAUNCHES", "SEP_LAUNCHES",
             "I8_LAUNCHES")
    owners = (ln, fa, fa, fa)
    counts = [getattr(m, n) for m, n in zip(owners, names)]
    with torch.inference_mode():
        logits = model(x, tokens_input=True)
    torch.cuda.synchronize()
    after = [getattr(m, n) for m, n in zip(owners, names)]
    assert [a - b for a, b in zip(after, counts)] == [
        8 if fused_rmsq else 0, 2, 0, 0]
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


# InternVideo2's training attention (C3): C1 and C2 on separate operands, v
# the strided column block of a (B, N, 3C) tensor; C1's and C2's bounds.
SEP_TRAIN_CASES = [(2, 2049, 6, 64), (2, 200, 2, 64), (3, 97, 4, 88),
                   (1, 130, 3, 128), (2, 33, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", SEP_TRAIN_CASES)
def test_attention_sep_fwd_lse_kernel_matches_plain(b, n, heads, d, dtype,
                                                    cuda):
    q, k, v, _ = _sep_operands(b, n, heads, d, 25, cuda, dtype)
    before = fa.SEP_FWD_LSE_LAUNCHES
    out, lse = fa.flash_attention_fwd_lse(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.SEP_FWD_LSE_LAUNCHES == before + 1
    assert out.dtype == dtype and lse.shape == (b, heads, n)
    want_out, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v, heads,
                                                          d ** -0.5)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", SEP_TRAIN_CASES)
def test_attention_sep_bwd_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    scale = d ** -0.5
    q, k, v, _ = _sep_operands(b, n, heads, d, 26, cuda, dtype)
    dout = _randn((b, n, heads * d), 27, cuda).to(dtype)
    out, lse = fa.flash_attention_fwd_lse_plain(q, k, v, heads, scale)
    before = fa.SEP_BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, heads, scale)
    torch.cuda.synchronize()
    assert fa.SEP_BWD_LAUNCHES == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, heads, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape and g.is_contiguous()
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_sep_training_on_packed_views_equals_packed(dtype, cuda):
    """C3 on the q, k, v column views of one qkv tensor reads the values C1
    and C2 read through one stride pair: the same kernels, the same results
    bit for bit."""
    b, n, heads, d = 2, 300, 4, 64
    C, scale = heads * d, d ** -0.5
    qkv = _randn((b, n, 3 * C), 28, cuda).to(dtype)
    dout = _randn((b, n, C), 29, cuda).to(dtype)
    views = (qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:])
    out, lse = fa.flash_attention_fwd_lse(*views, heads, scale)
    pout, plse = fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
    assert torch.equal(out, pout) and torch.equal(lse, plse)
    grads = fa.flash_attention_bwd(*views, out, lse, dout, heads, scale)
    assert torch.equal(torch.cat(grads, -1),
                       fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads,
                                                  scale))


@pytest.mark.cuda
def test_attention_sep_training_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((1, 8, 128), device=cuda, dtype=torch.bfloat16)
    bad_lse = torch.zeros(1, 2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, bad_lse, q, 2, 0.125)
    strided = torch.zeros((1, 8, 256), device=cuda,
                          dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="column"):
        fa.flash_attention_fwd_lse(q, q, strided, 2, 0.125)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="column"):
        fa.flash_attention_bwd(q, strided, q, q, lse, q, 2, 0.125)


# The backward's routes (fa.attention_bwd_route): bf16 at head dims 64 to
# 128 takes the wgmma kernels (TMA ring, wgmma products; tiles 64, 96 or
# 128 columns wide), bf16 at 8 to 56 the mma.sync kernels, fp32 the
# CUDA-core kernels.  The wgmma kernels are held to the plain versions at
# the 64-row tile edges and at IV2-S's N = 2049 (a 1-row last tile), packed
# and on separate operands with v strided, under BWD_TOL, at head dim 64
# and at every head dim of the wider tiles (72 to 128: tiles that hold
# columns of the next head, and at 72, 88, 104 and 120 odd heads' tiles
# that start 8 columns early); two launches on the same inputs are
# bit-equal (no atomics, one summation order).
ROUTE_COUNTERS = {"wgmma": "BWD_WGMMA_LAUNCHES",
                  "mma_sync": "BWD_MMA_LAUNCHES", "fp32": "BWD_F32_LAUNCHES"}


def _route_counts():
    return {route: getattr(fa, name) for route, name in ROUTE_COUNTERS.items()}


def _bwd_both_layouts(layout, b, n, heads, d, seed, device, dtype):
    """-> (kernel call, plain call) of the packed (C2) or separate (C3-bwd,
    v strided) backward on seeded inputs, both returning (B, N, 3C)."""
    scale = d ** -0.5
    q, k, v, qkv = _sep_operands(b, n, heads, d, seed, device, dtype)
    dout = _randn((b, n, heads * d), seed + 1, device).to(dtype)
    out, lse = fa.flash_attention_fwd_lse_plain(q, k, v, heads, scale)
    if layout == "packed":
        return (lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads,
                                                   scale),
                lambda: fa.flash_attention_qkv_bwd_plain(qkv, out, lse, dout,
                                                         heads, scale))
    return (lambda: torch.cat(fa.flash_attention_bwd(
                q, k, v, out, lse, dout, heads, scale), -1),
            lambda: torch.cat(fa.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, heads, scale), -1))


BWD_WGMMA_CASES = ([(n, 64) for n in (1, 63, 64, 65, 129, 2049)]
                   + [(n, d) for d in range(72, fa.MAX_HEAD_DIM + 1, 8)
                      for n in (1, 63, 65, 2049)])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "separate"])
@pytest.mark.parametrize("n,d", BWD_WGMMA_CASES)
def test_attention_bwd_wgmma_kernels_match_plain(n, d, layout, cuda):
    kernel, plain = _bwd_both_layouts(layout, 2, n, 3, d, 40, cuda,
                                      torch.bfloat16)
    before = _route_counts()
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    after = _route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        "wgmma": 2, "mma_sync": 0, "fp32": 0}
    assert torch.equal(got, again), "two launches differ"
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), plain().float(),
                               **BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 48, 64, 72, 80, 88, 96, 104, 112,
                               120, 128])
def test_attention_bwd_routes_by_head_dim(d, dtype, cuda):
    """Each head dim takes the route attention_bwd_route names, counted on
    that route only, and matches the plain version there."""
    route = fa.attention_bwd_route(dtype, d)
    kernel, plain = _bwd_both_layouts("separate", 2, 129, 2, d, 41, cuda,
                                      dtype)
    before = _route_counts()
    got = kernel()
    torch.cuda.synchronize()
    after = _route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    torch.testing.assert_close(got.float(), plain().float(), **BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 88, 120])
def test_attention_bwd_wgmma_writes_each_gradient_column_once(d, cuda):
    """C2 on the wgmma route at head dims whose tiles hold columns of the
    next head (80, 88, 120) and, at 88 and 120, odd heads' tiles that start
    8 columns early, into a gradient buffer filled with NaN first: every
    column of [dq | dk | dv] is written (none is left NaN), each with the
    value a launch into a fresh buffer gives and the plain version's (a
    block that stored a neighbouring head's columns from its own tile
    would leave them wrong)."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    b, n, heads = 2, 129, 5
    scale = d ** -0.5
    C = heads * d
    qkv = _randn((b, n, 3 * C), 48, cuda).to(torch.bfloat16)
    dout = _randn((b, n, C), 49, cuda).to(torch.bfloat16)
    out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
    want = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads, scale)
    delta = fa.flash_attention_delta(out, dout, heads)
    dqkv = torch.full_like(qkv, float("nan"))
    lib = kbuild.load()
    code = lib.stt_attention_bwd(
        *fa._qkv_pointers(qkv, C), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *fa._qkv_pointers(dqkv, C), b, n, heads, d,
        n * 3 * C, 3 * C, n * C, C, n * 3 * C, 3 * C,
        float(scale * fa.LOG2E), float(scale),
        kbuild.dtype_code(torch.bfloat16),
        torch.cuda.current_stream(cuda).cuda_stream)
    kbuild.check(code, "attention_bwd")
    torch.cuda.synchronize()
    assert fa.attention_bwd_route(torch.bfloat16, d) == "wgmma"
    assert not torch.isnan(dqkv).any(), "a gradient column left unwritten"
    assert torch.equal(dqkv, want)
    torch.testing.assert_close(
        dqkv.float(), fa.flash_attention_qkv_bwd_plain(
            qkv, out, lse, dout, heads, scale).float(),
        **BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_attention_bwd_route_is_the_kernel_dispatch(cuda):
    """attention_bwd_route names the kernels csrc/attention_train.cu's
    dispatch launches (stt_attention_bwd_route), at every head dim the
    entry points take; the ones they refuse are refused by both."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    lib = kbuild.load()
    for dtype in DTYPES:
        code = kbuild.dtype_code(dtype)
        for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
            assert fa.BWD_ROUTES[lib.stt_attention_bwd_route(code, d)] == \
                fa.attention_bwd_route(dtype, d), (dtype, d)
        for d in (0, 12, 136):
            assert lib.stt_attention_bwd_route(code, d) == -1
            with pytest.raises(ValueError):
                fa.attention_bwd_route(dtype, d)


# The bf16 attention forward's routes (A1 packed and separate, C1, C3-fwd,
# B3 packed and separate, C4-fwd; csrc/attention.cu): the wgmma kernel at
# head dims 64 to 128 (tiles 64, 96 or 128 wide), the mma.sync kernel at
# 8 to 56, counted per route over every entry point.  Two launches of one
# call agree bit for bit (no atomics, one summation order).
FWD_ROUTE_COUNTERS = {"wgmma": "FWD_WGMMA_LAUNCHES",
                      "mma_sync": "FWD_MMA_LAUNCHES",
                      "fp32": "FWD_F32_LAUNCHES"}
FWD_ENTRIES = ["A1", "A1-sep", "C1", "C3-fwd", "B3", "B3-sep"]


def _fwd_route_counts():
    return {route: getattr(fa, name)
            for route, name in FWD_ROUTE_COUNTERS.items()}


def _fwd_entry(entry, b, n, heads, d, seed, device, dtype):
    """-> (kernel call, plain call) of one forward entry point on seeded
    inputs: the packed qkv, or separate q, k and v with v its strided
    column block; B3-sep masks keys at or beyond max(1, n - 5)."""
    scale = d ** -0.5
    q, k, v, qkv = _sep_operands(b, n, heads, d, seed, device, dtype)
    sep = (q, k, v, heads, scale)
    out_amax = fa.flash_attention_plain(*sep).float().abs().max()
    n_kv = max(1, n - 5)
    return {
        "A1": (lambda: fa.flash_attention_qkv(qkv, heads, scale),
               lambda: fa.flash_attention_qkv_plain(qkv, heads, scale)),
        "A1-sep": (lambda: fa.flash_attention(*sep),
                   lambda: fa.flash_attention_plain(*sep)),
        "C1": (lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
               lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                            scale)),
        "C3-fwd": (lambda: fa.flash_attention_fwd_lse(*sep),
                   lambda: fa.flash_attention_fwd_lse_plain(*sep)),
        "B3": (lambda: fa.flash_attention_qkv_q8(qkv, heads, scale,
                                                 out_amax),
               lambda: fa.flash_attention_qkv_q8_plain(qkv, heads, scale,
                                                       out_amax)),
        "B3-sep": (lambda: fa.flash_attention_q8(*sep, out_amax, n_kv),
                   lambda: fa.flash_attention_q8_plain(*sep, out_amax,
                                                       n_kv)),
    }[entry]


def _check_fwd(entry, got, want, dtype):
    if entry.startswith("B3"):
        worst, share = _code_diff(got, want)
        assert worst <= 1 and share <= I8_SHARE, (worst, share)
        return
    if isinstance(got, tuple):                     # (out, lse)
        torch.testing.assert_close(got[1], want[1], **LSE_TOL[dtype])
        got, want = got[0], want[0]
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", FWD_ENTRIES)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1568, 2049])
@pytest.mark.parametrize("d", [64, 80, 88, 128])
def test_attention_fwd_wgmma_kernel_matches_plain(d, n, entry, cuda):
    """Every forward entry on the wgmma kernel at head dim 64 and at
    ViT-H's 80, IV2-1B's 88 (in 96-column tiles that start 8 columns
    early on odd heads) and IV2-6B's 128, at ragged N (one valid query row
    or key in the last tile), B3-sep with keys masked: two launches
    bit-equal, on the plain version."""
    kernel, plain = _fwd_entry(entry, 2, n, 3, d, 42, cuda, torch.bfloat16)
    before = _fwd_route_counts()
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    after = _fwd_route_counts()
    assert {r: after[r] - before[r] for r in after} == {
        "wgmma": 2, "mma_sync": 0, "fp32": 0}
    for g, a in zip(got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(g, a), "two launches differ"
    _check_fwd(entry, got, plain(), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 48, 56, 64, 72, 80, 88, 96, 104, 112,
                               120, 128])
def test_attention_fwd_routes_by_head_dim(d, dtype, cuda):
    """Each head dim takes the route attention_fwd_route names, counted on
    that route only, and matches the plain version there."""
    route = fa.attention_fwd_route(dtype, d)
    for entry in FWD_ENTRIES:
        kernel, plain = _fwd_entry(entry, 2, 129, 2, d, 43, cuda, dtype)
        before = _fwd_route_counts()
        got = kernel()
        torch.cuda.synchronize()
        after = _fwd_route_counts()
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}, entry
        _check_fwd(entry, got, plain(), dtype)


@pytest.mark.cuda
def test_attention_fwd_route_is_the_kernel_dispatch(cuda):
    """attention_fwd_route names the kernel csrc/attention.cu's dispatch
    launches (stt_attention_fwd_route), at every head dim the entry points
    take; the ones they refuse are refused by both."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    lib = kbuild.load()
    for dtype in DTYPES:
        code = kbuild.dtype_code(dtype)
        for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
            assert fa.FWD_ROUTES[lib.stt_attention_fwd_route(code, d)] == \
                fa.attention_fwd_route(dtype, d), (dtype, d)
        for d in (0, 12, 136):
            assert lib.stt_attention_fwd_route(code, d) == -1
            with pytest.raises(ValueError):
                fa.attention_fwd_route(dtype, d)


@pytest.mark.cuda
def test_tiny_iv2_train_step_goes_through_kernels(cuda):
    """One train step of a 2-layer IV2-S with fp32 masters computed in bf16
    runs C3-fwd and C3-bwd once per block (C3-bwd on its wgmma kernels)
    and no other kernel (RMSNorm,
    LayerScale and the pooling head are plain PyTorch); gradients reach
    every fp32 master and the update moves every block parameter (the
    pooling head's key biases have a zero gradient in exact arithmetic)."""
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    model = _tiny_iv2(cuda, dtype=torch.bfloat16, param_dtype=torch.float32,
                      drop_path_rate=0.1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    state = TrainState.create(model, FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=1e-3, layer_decay=0.75,
        depth=2), gen)
    step = make_finetune_train_step(create_criterion("crossentropy"))
    batch = {"video": _randn((2, 4, 28, 28, 3), 30, cuda).bfloat16(),
             "label": torch.tensor([0, 1], device=cuda)}
    names = ("LAUNCHES", "SEP_LAUNCHES", "FWD_LSE_LAUNCHES", "BWD_LAUNCHES",
             "SEP_FWD_LSE_LAUNCHES", "SEP_BWD_LAUNCHES", "BWD_WGMMA_LAUNCHES",
             "BWD_MMA_LAUNCHES")
    counts = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    after = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    assert [a - b for a, b in zip(after, counts)] == [0, 0, 0, 0, 2, 2, 2, 0,
                                                      0]
    assert torch.isfinite(metrics["loss"]) and logits.shape == (2, 2)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        if n.startswith("blocks."):
            assert not torch.equal(p, before[n]), n


# Static int8 GEMMs (B4).  Without an activation the kernel's output is the
# plain version's bit for bit (an exact int32 product, then the same fp32
# multiply and add and one cast).  With GELU, CUDA's tanhf / erff need not
# round as PyTorch's GELU kernel does: fp32 outputs within 1e-5.  The MLP
# re-quantizes the GELU output, so a code can flip where it sits at a
# half-integer; a flip moves one row's outputs by one hidden code's share:
# at most 2% of outputs differ, all within 2% of max |y|.
def _gemm_operands(m, k, n, x_dtype, seed, device):
    from simple_tad_tpu_torch.ops.quant import quantize_weight
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    amax = torch.tensor(float(x.abs().max()) * 0.9)       # some codes clip
    if x_dtype == torch.int8:
        x = ln.quantize_static(x, amax)
    w_q, w_s = quantize_weight(rng.normal(0, 0.05, (k, n)))
    return (x.to(x_dtype).to(device),
            torch.from_numpy(np.ascontiguousarray(w_q.T)).to(device),
            torch.from_numpy(w_s).to(device), amax.to(device),
            torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)
                             ).to(device))


def _rows_plain(plain, x, *rest):
    """``plain`` on x's rows: torch._int_mm on the card takes more than 16
    rows, so a shorter x is padded with zero rows (each output row depends
    on its own row alone) and the result cut back."""
    m = x.shape[0]
    if m > 16:
        return plain(x, *rest)
    pad = torch.zeros((32 - m, x.shape[1]), dtype=x.dtype, device=x.device)
    return plain(torch.cat([x, pad]), *rest)[:m]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,x_dtype,bias,act,out", [
    (1000, 768, 2304, torch.int8, False, None, torch.bfloat16),   # qkv
    (1000, 768, 768, torch.int8, True, None, torch.bfloat16),     # proj
    (333, 3072, 768, torch.float32, True, None, torch.bfloat16),  # fc2
    (257, 384, 1536, torch.bfloat16, True, "gelu_tanh", torch.float32),
    (130, 256, 200, torch.float32, True, "gelu_erf", torch.float32),
    (64, 64, 8, torch.int8, False, None, torch.float32),
    (40, 96, 136, torch.bfloat16, False, "gelu_erf", torch.bfloat16),
    # M at and around the 128-row block, N past a 128- or 256-column block
    # (an fp32 x takes 256 columns a block), K 96 (a half 64-deep stage)
    (1, 768, 768, torch.int8, True, None, torch.bfloat16),
    (127, 384, 1152, torch.bfloat16, False, None, torch.bfloat16),
    (128, 96, 264, torch.float32, True, None, torch.float32),
    (129, 768, 2304, torch.int8, False, "gelu_tanh", torch.bfloat16),
    (129, 96, 8, torch.bfloat16, True, None, torch.float32),
    (1, 3072, 776, torch.float32, True, None, torch.bfloat16)])
def test_w8a8_gemm_kernel_matches_plain(m, k, n, x_dtype, bias, act, out,
                                        cuda):
    from simple_tad_tpu_torch.ops import int8_gemm, quant
    x, w_q, w_s, amax, b = _gemm_operands(m, k, n, x_dtype, 30, cuda)
    args = (x, w_q, w_s, amax, b if bias else None, act, out)
    before = (int8_gemm.GEMM_LAUNCHES, quant.INT_MM_CALLS)
    got = int8_gemm.w8a8_gemm(*args)
    torch.cuda.synchronize()
    assert (int8_gemm.GEMM_LAUNCHES, quant.INT_MM_CALLS) == (
        before[0] + 1, before[1])
    assert torch.equal(int8_gemm.w8a8_gemm(*args), got)  # one sum order
    want = _rows_plain(int8_gemm.w8a8_gemm_plain, *args)
    assert got.dtype == out and got.shape == (m, n)
    if act is None:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL[out])


def _mlp_operands(m, dim, hidden, x_dtype, seed, device):
    x, w1, s1, amax1, b1 = _gemm_operands(m, dim, hidden, x_dtype, seed,
                                          device)
    _, w2, s2, _, b2 = _gemm_operands(8, hidden, dim, torch.float32,
                                      seed + 1, device)
    from simple_tad_tpu_torch.ops import int8_gemm
    h = _rows_plain(int8_gemm.w8a8_gemm_plain, x, w1, s1, amax1, b1,
                    "gelu_tanh", torch.float32)
    return x, w1, s1, amax1, b1, w2, s2, h.abs().max() * 0.9, b2


@pytest.mark.cuda
@pytest.mark.parametrize("m,dim,hidden,x_dtype,act,out", [
    (1000, 384, 1536, torch.bfloat16, "gelu_tanh", torch.bfloat16),
    (777, 768, 3072, torch.int8, "gelu_erf", torch.float32),
    (100, 128, 512, torch.float32, "gelu_tanh", torch.float32),
    (65, 256, 96, torch.bfloat16, "gelu_erf", torch.bfloat16),
    # the widths use_fused_mlp took on with the two-launch MLP: ViT-L,
    # IV2-1B, and dims that are multiples of 32 only; M 1 and 129
    (129, 1024, 4096, torch.bfloat16, "gelu_tanh", torch.bfloat16),
    (127, 1408, 6144, torch.int8, "gelu_erf", torch.float32),
    (1, 768, 3072, torch.int8, "gelu_tanh", torch.bfloat16),
    (128, 96, 160, torch.float32, "gelu_erf", torch.float32)])
def test_w8a8_mlp_kernel_matches_plain(m, dim, hidden, x_dtype, act, out,
                                       cuda):
    from simple_tad_tpu_torch.ops import int8_gemm
    ops = _mlp_operands(m, dim, hidden, x_dtype, 31, cuda)
    before = int8_gemm.MLP_LAUNCHES
    got = int8_gemm.w8a8_mlp(*ops, act, out)
    torch.cuda.synchronize()
    assert int8_gemm.MLP_LAUNCHES == before + 1
    assert torch.equal(int8_gemm.w8a8_mlp(*ops, act, out), got)
    want = _rows_plain(int8_gemm.w8a8_mlp_plain, *ops, act, out)
    assert got.dtype == out and got.shape == (m, dim)
    share = float((got != want).float().mean())
    scale = float(want.float().abs().max())
    assert share <= 0.02, share
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=0.02 * scale)
    # control: fc1's bias left out
    control = _rows_plain(int8_gemm.w8a8_mlp_plain, *ops[:4], None,
                          *ops[5:], act, out)
    assert float((control != want).float().mean()) > 0.02


@pytest.mark.cuda
def test_w8a8_kernels_reject_what_they_do_not_take(cuda):
    from simple_tad_tpu_torch.ops import int8_gemm
    x, w_q, w_s, amax, b = _gemm_operands(64, 48, 64, torch.int8, 32, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_gemm.w8a8_gemm(x, w_q, w_s, amax, b)
    # the MLP takes dim and hidden that are multiples of 32 (IV2-1B's 1408
    # x 6144 among them); a dim of 48 takes the per-GEMM route
    assert int8_gemm.use_fused_mlp(1408, 6144)
    assert not int8_gemm.use_fused_mlp(48, 64)
    ops = _mlp_operands(32, 48, 64, torch.bfloat16, 33, cuda)
    with pytest.raises(ValueError, match="use_fused_mlp"):
        int8_gemm.w8a8_mlp(*ops)


# B3: A1 with the int8 output epilogue, packed and on separate operands
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", [(2, 1568, 12, 64), (2, 200, 2, 64),
                                         (3, 97, 16, 80), (1, 130, 3, 128),
                                         (2, 33, 4, 8)])
def test_attention_q8_kernel_matches_plain(b, n, heads, d, dtype, cuda):
    qkv = _randn((b, n, 3 * heads * d), 34, cuda).to(dtype)
    scale = d ** -0.5
    out_amax = fa.flash_attention_qkv_plain(qkv, heads, scale).float(
        ).abs().max() * 0.9
    before = fa.Q8_LAUNCHES
    got = fa.flash_attention_qkv_q8(qkv, heads, scale, out_amax)
    torch.cuda.synchronize()
    assert fa.Q8_LAUNCHES == before + 1 and got.dtype == torch.int8
    worst, share = _code_diff(got, fa.flash_attention_qkv_q8_plain(
        qkv, heads, scale, out_amax))
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d,n_valid", [
    (2, 2049, 6, 64, None), (2, 200, 2, 64, 190), (3, 97, 4, 88, None),
    (2, 33, 4, 64, 1)])
def test_attention_q8_sep_kernel_matches_plain(b, n, heads, d, n_valid,
                                               dtype, cuda):
    q, k, v, _ = _sep_operands(b, n, heads, d, 35, cuda, dtype)
    scale = d ** -0.5
    out_amax = fa.flash_attention_plain(q, k, v, heads, scale).float(
        ).abs().max()
    before = fa.Q8_SEP_LAUNCHES
    got = fa.flash_attention_q8(q, k, v, heads, scale, out_amax, n_valid)
    torch.cuda.synchronize()
    assert fa.Q8_SEP_LAUNCHES == before + 1 and got.dtype == torch.int8
    worst, share = _code_diff(got, fa.flash_attention_q8_plain(
        q, k, v, heads, scale, out_amax, n_valid))
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


def _launches():
    from simple_tad_tpu_torch.ops import int8_gemm, quant
    return {"lnq": ln.QUANT_LAUNCHES, "rmsq": ln.RMSQ_LAUNCHES,
            "i8": fa.I8_LAUNCHES, "i8_sep": fa.I8_SEP_LAUNCHES,
            "q8": fa.Q8_LAUNCHES, "q8_sep": fa.Q8_SEP_LAUNCHES,
            "sep": fa.SEP_LAUNCHES, "gemm": int8_gemm.GEMM_LAUNCHES,
            "mlp": int8_gemm.MLP_LAUNCHES, "int_mm": quant.INT_MM_CALLS,
            "add_lnq": ln.ADD_QUANT_LAUNCHES, "int8": fa.INT8_LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("qkv_i8", [True, False])
def test_tiny_int8_vit_fused_forward_goes_through_kernels(qkv_i8, cuda):
    """Static int8 ViT-S (2 layers) with fused_w8a8 and fused_mlp: per
    block two LayerNorm->int8, one int8 attention (B2, or B3 with
    qkv_i8=False), two GEMM kernels (qkv, proj), one MLP kernel and no
    torch._int_mm; the logits within the int8 bound of the unfused
    model's."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    masters = create_model("vit_small_patch16_224", device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           img_size=32, depth=2, init_scale=1.0)
    x = _randn((2, 32, 384), 36, cuda).bfloat16()
    base = dataclasses.replace(masters.cfg, dtype=torch.bfloat16,
                               qkv_i8=qkv_i8)
    unfused = quantize_and_calibrate(base, masters.state_dict(), [x],
                                     device=cuda, tokens_input=True)
    model = quantize_and_calibrate(
        dataclasses.replace(base, fused_w8a8=True, fused_mlp=True),
        masters.state_dict(), [x], device=cuda, tokens_input=True)
    before = _launches()
    with torch.inference_mode():
        logits = model(x, tokens_input=True)
    torch.cuda.synchronize()
    after = _launches()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    attn = {"i8": 2} if qkv_i8 else {"q8": 2}
    assert got == {"lnq": 4, "gemm": 4, "mlp": 2, **attn}, got
    with torch.inference_mode():
        want = unfused(x, tokens_input=True)
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, want, rtol=0,
                               atol=2.5e-2 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("qkv_i8,fused_rmsq", [(True, False), (True, True),
                                               (False, False)])
def test_tiny_int8_iv2_fused_forward_goes_through_kernels(qkv_i8, fused_rmsq,
                                                          cuda):
    """Static int8 IV2-S (2 layers) with fused_w8a8 and fused_mlp: per
    block D2 (or B3 on separate operands with qkv_i8=False), two GEMM
    kernels, one MLP kernel, no torch._int_mm; with fused_rmsq four D3."""
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    masters = _tiny_iv2("cpu")
    cfg = dataclasses.replace(masters.cfg, dtype=torch.bfloat16,
                              fused_rmsq=fused_rmsq, fused_w8a8=True,
                              fused_mlp=True, qkv_i8=qkv_i8)
    x = _randn((2, 16, 384), 37, cuda).bfloat16()
    model = quantize_and_calibrate(cfg, masters.state_dict(), [x],
                                   device=cuda, tokens_input=True)
    before = _launches()
    with torch.inference_mode():
        logits = model(x, tokens_input=True)
    torch.cuda.synchronize()
    after = _launches()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"gemm": 4, "mlp": 2, **({"i8_sep": 2} if qkv_i8
                                    else {"q8_sep": 2})}
    if fused_rmsq:
        want["rmsq"] = 8 if qkv_i8 else 4
    assert got == want, got
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


# Attention dropout (C4): C3 with a keep source, the int8 mask or Philox
# bits drawn in the kernel from a seed; v the strided column block of a
# (B, N, 3C) tensor; C1's and C2's bounds.  Both forms compute the same
# function of the same keep bits, so the seed form equals the mask form fed
# dropout_keep_plain's mask bit for bit.  In bf16 the forward and the
# backward take their wgmma kernels at head dims 64 to 128 (80, 88 and 128
# among the cases), the others the mma.sync ones: the wgmma mask form copies
# its tiles by 16 bytes at N = 1568 (ViT-B's length, N % 16 == 0), by 8 at
# 392 and 200, by 4 at 132 and by single bytes at IV2's 2049 (rows off 4
# bytes).
DROP_CASES = [(2, 392, 12, 64), (2, 200, 2, 64), (3, 97, 4, 80),
              (1, 130, 3, 128), (2, 33, 4, 32), (1, 2049, 2, 64),
              (2, 1568, 12, 64), (2, 132, 3, 64), (2, 129, 3, 88)]
DROP_RATE = 0.1


def _keep_source(form, b, heads, n, seed, device):
    """{'mask': int8 (b, heads, n, n)} or {'seed': 2 int32 words}."""
    words = torch.tensor([seed * 7919 + 1, -seed - 3], dtype=torch.int32,
                         device=device)
    if form == "seed":
        return {"seed": words}
    return {"mask": fa.dropout_keep_plain(words, b, heads, n, DROP_RATE)}


def _drop_counts():
    return (fa.DROP_FWD_LAUNCHES, fa.DROP_BWD_LAUNCHES,
            fa.DROP_RNG_FWD_LAUNCHES, fa.DROP_RNG_BWD_LAUNCHES)


def _moved(before, after):
    return {r: after[r] - before[r] for r in after}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["mask", "seed"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", DROP_CASES)
def test_attention_drop_fwd_kernel_matches_plain(b, n, heads, d, dtype, form,
                                                 cuda):
    q, k, v, _ = _sep_operands(b, n, heads, d, 40, cuda, dtype)
    src = _keep_source(form, b, heads, n, 41, cuda)
    before, routes = _drop_counts(), _fwd_route_counts()
    out, lse = fa.flash_attention_drop_fwd(q, k, v, heads, d ** -0.5,
                                           DROP_RATE, **src)
    torch.cuda.synchronize()
    moved = tuple(a - x for a, x in zip(_drop_counts(), before))
    assert moved == ((1, 0, 0, 0) if form == "mask" else (0, 0, 1, 0))
    route = fa.attention_fwd_route(dtype, d)
    assert route == ("fp32" if dtype == torch.float32
                     else "wgmma" if d >= 64 else "mma_sync")
    assert _moved(routes, _fwd_route_counts()) == {
        r: int(r == route) for r in routes}
    assert out.dtype == dtype and lse.shape == (b, heads, n)
    again = fa.flash_attention_drop_fwd(q, k, v, heads, d ** -0.5, DROP_RATE,
                                        **src)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1]), \
        "two launches differ"
    want_out, want_lse = fa.flash_attention_drop_fwd_plain(
        q, k, v, heads, d ** -0.5, DROP_RATE, **src)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["mask", "seed"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", DROP_CASES)
def test_attention_drop_bwd_kernel_matches_plain(b, n, heads, d, dtype, form,
                                                 cuda):
    scale = d ** -0.5
    q, k, v, _ = _sep_operands(b, n, heads, d, 42, cuda, dtype)
    dout = _randn((b, n, heads * d), 43, cuda).to(dtype)
    src = _keep_source(form, b, heads, n, 44, cuda)
    out, lse = fa.flash_attention_drop_fwd_plain(q, k, v, heads, scale,
                                                 DROP_RATE, **src)
    before, routes = _drop_counts(), _route_counts()
    got = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, heads, scale,
                                      DROP_RATE, **src)
    torch.cuda.synchronize()
    moved = tuple(a - x for a, x in zip(_drop_counts(), before))
    assert moved == ((0, 1, 0, 0) if form == "mask" else (0, 0, 0, 1))
    route = fa.attention_bwd_route(dtype, d)
    assert route == ("fp32" if dtype == torch.float32
                     else "wgmma" if d >= 64 else "mma_sync")
    assert _moved(routes, _route_counts()) == {
        r: int(r == route) for r in routes}
    again = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, heads, scale,
                                        DROP_RATE, **src)
    assert all(torch.equal(g, a) for g, a in zip(got, again)), \
        "two launches differ"
    want = fa.flash_attention_drop_bwd_plain(q, k, v, out, lse, dout, heads,
                                             scale, DROP_RATE, **src)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape and g.is_contiguous()
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,heads,d", DROP_CASES[:3] + DROP_CASES[5:])
def test_attention_drop_seed_form_is_the_mask_form_of_its_bits(b, n, heads,
                                                               d, dtype,
                                                               cuda):
    """The Philox kernels draw exactly dropout_keep_plain's bits: fed that
    mask, the mask kernels give the same out, lse and gradients, bit for
    bit (the forward on its wgmma route at head dims 64 to 128 in bf16;
    the backward on its wgmma route at 64, the mma.sync one at 80)."""
    scale = d ** -0.5
    q, k, v, _ = _sep_operands(b, n, heads, d, 45, cuda, dtype)
    dout = _randn((b, n, heads * d), 46, cuda).to(dtype)
    seed = _keep_source("seed", b, heads, n, 47, cuda)["seed"]
    mask = fa.dropout_keep_plain(seed, b, heads, n, DROP_RATE)
    fwd_s = fa.flash_attention_drop_fwd(q, k, v, heads, scale, DROP_RATE,
                                        seed=seed)
    fwd_m = fa.flash_attention_drop_fwd(q, k, v, heads, scale, DROP_RATE,
                                        mask=mask)
    assert all(torch.equal(a, b_) for a, b_ in zip(fwd_s, fwd_m))
    out, lse = fwd_s
    bwd_s = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, heads,
                                        scale, DROP_RATE, seed=seed)
    bwd_m = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, heads,
                                        scale, DROP_RATE, mask=mask)
    assert all(torch.equal(a, b_) for a, b_ in zip(bwd_s, bwd_m))


def _probe_keep_mask(b, heads, n, d, rate, seed, dtype, device,
                     head_offset=None, total_heads=None):
    """The keep mask of the seed-form forward, read off its output: with
    q = k = 0 every probability is 1 and l = N, and with v one-hot
    (v[key, c] = 1 for key = shift + c) output column c of row q is
    nonzero exactly where (q, shift + c) is kept.  ``head_offset`` and
    ``total_heads``: the launch covers a tensor-parallel rank's heads."""
    C = heads * d
    z = torch.zeros((b, n, C), dtype=dtype, device=device)
    mask = torch.zeros((b, heads, n, n), dtype=torch.int8, device=device)
    for shift in range(0, n, d):
        w = min(d, n - shift)
        v = torch.zeros((b, n, heads, d), dtype=dtype, device=device)
        c = torch.arange(w, device=device)
        v[:, shift + c, :, c] = 1
        out, _ = fa.flash_attention_drop_fwd(z, z, v.view(b, n, C), heads,
                                             d ** -0.5, rate, seed=seed,
                                             head_offset=head_offset,
                                             total_heads=total_heads)
        got = out.view(b, n, heads, d)[..., :w] != 0
        mask[..., shift:shift + w] = got.permute(0, 2, 1, 3).to(torch.int8)
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_drop_rng_kernel_bits_equal_plain(rate, dtype, d, cuda):
    """The keep bits the Philox forward draws (q-tiles and key tiles past
    the first, a ragged tail) equal dropout_keep_plain's, bit for bit: in
    bf16 the wgmma kernel's at head dims 64 and 80, the mma.sync kernel's
    at 32."""
    b, heads, n = 2, 3, 200
    seed = torch.tensor([12345, -678], dtype=torch.int32, device=cuda)
    got = _probe_keep_mask(b, heads, n, d, rate, seed, dtype, cuda)
    want = fa.dropout_keep_plain(seed, b, heads, n, rate)
    assert torch.equal(got, want)
    assert abs(1 - got.float().mean().item() - rate) < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_drop_rng_kernel_bits_at_a_head_offset(d, cuda):
    """A launch over a tensor-parallel rank's heads (2 of 5, from head 3)
    draws the whole model's bits of those heads, bit for bit, on each
    route (mma.sync at 32, wgmma at 64 and 128); the dropout backward at
    that offset equals the mask form fed those bits."""
    b, n, h0, hl, heads = 2, 200, 3, 2, 5
    seed = torch.tensor([4242, -99], dtype=torch.int32, device=cuda)
    got = _probe_keep_mask(b, hl, n, d, 0.3, seed, torch.bfloat16, cuda,
                           head_offset=h0, total_heads=heads)
    whole = fa.dropout_keep_plain(seed, b, heads, n, 0.3)
    assert torch.equal(got, whole[:, h0:h0 + hl])
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (torch.randn((b, n, hl * d), generator=g, device=cuda)
                     .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_attention_drop_fwd(q, k, v, hl, scale, 0.3,
                                           seed=seed, head_offset=h0,
                                           total_heads=heads)
    mask = whole[:, h0:h0 + hl].contiguous()
    ref = fa.flash_attention_drop_fwd(q, k, v, hl, scale, 0.3, mask=mask)
    assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])
    grads = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, hl, scale,
                                        0.3, seed=seed, head_offset=h0,
                                        total_heads=heads)
    want = fa.flash_attention_drop_bwd(q, k, v, out, lse, dout, hl, scale,
                                       0.3, mask=mask)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, want))


@pytest.mark.cuda
def test_attention_drop_wrappers_reject_bad_keep_sources(cuda):
    q = torch.zeros((1, 8, 128), device=cuda, dtype=torch.bfloat16)
    seed = torch.zeros(2, dtype=torch.int32, device=cuda)
    mask = torch.ones((1, 2, 8, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="exactly one"):
        fa.flash_attention_drop_fwd(q, q, q, 2, 0.125, 0.1, mask=mask,
                                    seed=seed)
    with pytest.raises(ValueError, match="exactly one"):
        fa.flash_attention_drop_fwd(q, q, q, 2, 0.125, 0.1)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention_drop_fwd(q, q, q, 2, 0.125, 0.1,
                                    mask=mask.float())
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_drop_fwd(q, q, q, 2, 0.125, 0.1,
                                    seed=seed.long())
    with pytest.raises(ValueError, match="rate"):
        fa.flash_attention_drop_fwd(q, q, q, 2, 0.125, 1.0, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rng", "mask"])
def test_tiny_vit_train_step_with_attn_dropout_goes_through_kernels(form,
                                                                    cuda):
    """One train step of a 2-layer ViT-S with attention dropout runs the
    dropout forward and backward once per block in its form, and C1 and C2
    never; gradients reach the fp32 masters."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    model = create_model("vit_small_patch16_224", device=cuda,
                         generator=torch.Generator().manual_seed(0),
                         img_size=32, depth=2, dtype=torch.bfloat16,
                         param_dtype=torch.float32, attn_drop_rate=0.1,
                         attn_dropout_form=form)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    state = TrainState.create(model, FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=1e-3, layer_decay=0.75,
        depth=2), gen)
    step = make_finetune_train_step(create_criterion("crossentropy"))
    batch = {"video": _randn((2, 16, 32, 32, 3), 48, cuda).bfloat16(),
             "label": torch.tensor([0, 1], device=cuda)}
    counts = (fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES, *_drop_counts())
    routes = (_fwd_route_counts(), _route_counts())
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    after = (fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES, *_drop_counts())
    moved = tuple(a - b for a, b in zip(after, counts))
    assert moved == ((0, 0, 2, 2, 0, 0) if form == "mask"
                     else (0, 0, 0, 0, 2, 2))
    # ViT-S's head dim 64: both directions on the wgmma kernels
    want = {"wgmma": 2, "mma_sync": 0, "fp32": 0}
    assert _moved(routes[0], _fwd_route_counts()) == want
    assert _moved(routes[1], _route_counts()) == want
    assert torch.isfinite(metrics["loss"]) and logits.shape == (2, 2)
    assert all(p.grad is not None for p in model.parameters())


# The static int8 ViT's opt-in variants: E1 (residual add + LayerNorm->int8)
# equals B1 on its stored sum bit for bit (B1's kernel with the add in
# front); E2 (int8-compute attention) is held to its plain version by the
# share of bf16 outputs that differ (1%) and, per output, by what one
# flipped probability code can move it (sv * 254 / (l - 1) of its row, plus
# a bf16 rounding of either side), where exp2f and torch.exp2 round a code
# at a .5 boundary apart.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows", [1568, 15, 1])
@pytest.mark.parametrize("C", [128, 384, 768, 1024, 4096, 100])
def test_add_layernorm_quant_kernel_matches_plain(rows, C, dtype, cuda):
    branch = (_randn((rows, C), 40, cuda) * 2 + 0.5).to(dtype)
    residual = (_randn((rows, C), 41, cuda) * 3).to(dtype)
    w = _randn((C,), 42, cuda) * 0.2 + 1
    b = _randn((C,), 43, cuda) * 0.1
    total, _ = ln.add_layernorm_quant_plain(branch, residual, w, b,
                                            torch.ones((), device=cuda))
    amax = ln.layernorm_plain(total, w, b, out_dtype=torch.float32
                              ).abs().max() * 0.9
    before = ln.ADD_QUANT_LAUNCHES
    got_sum, got = ln.add_layernorm_quant(branch, residual, w, b, amax)
    torch.cuda.synchronize()
    assert ln.ADD_QUANT_LAUNCHES == before + 1
    assert got_sum.dtype == dtype and got.dtype == torch.int8
    assert torch.equal(got_sum, total)
    assert torch.equal(got, ln.layernorm_quant(got_sum, w, b, amax))
    worst, share = _code_diff(got, ln.layernorm_quant_plain(total, w, b,
                                                            amax))
    assert worst <= 1 and share <= I8_SHARE, (worst, share)


def _int8_codes(b, n, heads, d, seed, device):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.integers(-127, 128, (b, n, 3 * heads * d)
                                        ).astype(np.int8)).to(device)
    amax = torch.from_numpy(rng.uniform(0.5, 4.0, (3, heads)).astype(
        np.float32)).to(device)
    return qkv, amax


def _assert_within_one_code(got, want, qkv_i8, amax, heads, scale):
    p, _, sv = fa.int8_attention_codes(qkv_i8, amax, heads, scale)
    l = p.sum(dim=-1, keepdim=True)
    d = qkv_i8.shape[-1] // 3 // heads
    effect = fa._merge_heads((sv * 254.0 / (l - 1)).expand(
        *l.shape[:-1], d))
    diff = (got.float() - want.float()).abs()
    share = float((diff > 0).float().mean())
    assert share <= 0.01, share
    assert bool((diff <= effect + want.float().abs() * 2 ** -7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 131, 1568, 4096])
@pytest.mark.parametrize("heads,d", [(6, 64), (12, 64), (16, 64), (4, 16),
                                     (4, 32)])
def test_attention_int8_kernel_matches_plain(heads, d, n, cuda):
    """ViT-S, ViT-B and ViT-L geometry (Dh 64), and Dh 16 and 32."""
    qkv_i8, amax = _int8_codes(2, n, heads, d, 44, cuda)
    scale = d ** -0.5
    before = fa.INT8_LAUNCHES
    got = fa.flash_attention_qkv_int8(qkv_i8, amax, heads, scale)
    torch.cuda.synchronize()
    assert fa.INT8_LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, heads * d)
    want = fa.flash_attention_qkv_int8_plain(qkv_i8, amax, heads, scale)
    _assert_within_one_code(got, want, qkv_i8, amax, heads, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 200])
def test_attention_int8_kernel_pv_key_order(n, cuda):
    """The PV product's key permutation: v one-hot (key j holds 127 at dim
    j % 64 and 0 elsewhere), so output (row, c) is 127 times the sum of the
    codes of keys c, c + 64, ... over l: each dim picks out its own keys'
    codes, and a key read at another key's place moves it."""
    heads, d = 2, 64
    qkv_i8, amax = _int8_codes(1, n, heads, d, 45, cuda)
    C = heads * d
    v = qkv_i8[..., 2 * C:].view(1, n, heads, d)
    v.zero_()
    keys = torch.arange(n, device=cuda)
    v[0, keys, :, keys % d] = 127
    amax[2] = 127.0
    scale = d ** -0.5
    got = fa.flash_attention_qkv_int8(qkv_i8, amax, heads, scale)
    torch.cuda.synchronize()
    p, _, sv = fa.int8_attention_codes(qkv_i8, amax, heads, scale)
    picked = torch.stack([p[..., keys[keys % d == c]].sum(dim=-1)
                          for c in range(d)], -1)
    want = fa._merge_heads(((picked * 127) / p.sum(dim=-1, keepdim=True)
                            * sv).to(torch.bfloat16))
    _assert_within_one_code(got, want, qkv_i8, amax, heads, scale)
    assert torch.equal(want, fa.flash_attention_qkv_int8_plain(
        qkv_i8, amax, heads, scale))


@pytest.mark.cuda
def test_attention_int8_kernel_rejects_unsupported_head_dim(cuda):
    qkv = torch.zeros((1, 8, 3 * 1 * 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_qkv_int8(qkv, torch.ones(3, 1, device=cuda), 1,
                                    0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [dict(add_lnq=True),
                                     dict(int8_attn=True),
                                     dict(add_lnq=True, int8_attn=True,
                                          fused_w8a8=True, fused_mlp=True)],
                         ids=["add_lnq", "int8_attn", "both_fused"])
def test_tiny_int8_vit_variants_go_through_kernels(options, cuda):
    """Static int8 ViT-S (2 layers) with each variant: per block two E1
    launches and no LayerNorm->int8 (add_lnq), one E2 launch and no B2
    (int8_attn); with add_lnq the logits equal the same model's without it
    bit for bit, and every variant's are within the int8 bound of the
    model run through the plain versions."""
    from unittest import mock
    from simple_tad_tpu_torch.models import create_model, layers
    from simple_tad_tpu_torch.ops import attention
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    masters = create_model("vit_small_patch16_224", device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           img_size=32, depth=2, init_scale=1.0,
                           init_values=0.1)
    x = _randn((2, 32, 384), 46, cuda).bfloat16()
    base = dataclasses.replace(masters.cfg, dtype=torch.bfloat16)
    model = quantize_and_calibrate(dataclasses.replace(base, **options),
                                   masters.state_dict(), [x], device=cuda,
                                   tokens_input=True)
    before = _launches()
    with torch.inference_mode():
        logits = model(x, tokens_input=True)
    torch.cuda.synchronize()
    after = _launches()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"add_lnq": 4} if options.get("add_lnq") else {"lnq": 4}
    want.update({"int8": 2} if options.get("int8_attn") else {"i8": 2})
    if options.get("fused_w8a8"):
        want.update(gemm=4, mlp=2)
    else:
        want["int_mm"] = 8
    assert got == want, got
    assert torch.isfinite(logits).all()
    if options == dict(add_lnq=True):
        unfused = quantize_and_calibrate(base, masters.state_dict(), [x],
                                         device=cuda, tokens_input=True)
        with torch.inference_mode():
            assert torch.equal(logits, unfused(x, tokens_input=True))
    with mock.patch.object(layers, "add_layernorm_quant",
                           ln.add_layernorm_quant_plain), \
            mock.patch.object(layers, "layernorm_quant",
                              ln.layernorm_quant_plain), \
            mock.patch.object(attention, "flash_attention_qkv_int8",
                              fa.flash_attention_qkv_int8_plain), \
            mock.patch.object(attention, "flash_attention_qkv_i8d",
                              fa.flash_attention_qkv_i8d_plain), \
            torch.inference_mode():
        plain = model(x, tokens_input=True)
    torch.testing.assert_close(logits, plain, rtol=0,
                               atol=2.5e-2 * float(plain.abs().max()))



# The int8 attentions' routes: B2 and D2 (csrc/attention_i8.cu) and E2
# (csrc/attention_int8.cu) take their wgmma kernels where the padded head
# dim is 64, their mma.sync kernels at the others, counted per route.  Two
# launches of one call agree bit for bit.  B2 and D2 are held to their
# plain versions as chip_smoke.py holds them (I8_MISMATCH: codes at most 1
# apart, at most this share of them, and one code where the share of so
# few codes would be less); E2, whose integers are exact and whose float
# steps are the plain version's, bit for bit.
I8_ROUTE_COUNTERS = {"wgmma": "I8_WGMMA_LAUNCHES",
                     "mma_sync": "I8_MMA_LAUNCHES"}
INT8_ROUTE_COUNTERS = {"wgmma": "INT8_WGMMA_LAUNCHES",
                       "mma_sync": "INT8_MMA_LAUNCHES"}
I8_MISMATCH = 4e-4


def _route_moved(counters, before):
    return {r: getattr(fa, name) - before[r] for r, name in counters.items()}


def _route_before(counters):
    return {r: getattr(fa, name) for r, name in counters.items()}


def _assert_i8_codes(got, want):
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= max(1, I8_MISMATCH * diff.numel()), \
        float((diff > 0).float().mean())


def _i8_entry(entry, b, n, heads, d, seed, device):
    """-> (kernel call, plain call) of B2 on the packed int8 qkv, or D2 on
    its separate operands with v the strided column block and keys masked
    at or beyond max(1, n - 5)."""
    qkv_i8, amax = _qkv_i8(b, n, heads, d, seed, device)
    C = heads * d
    scale = d ** -0.5
    if entry == "B2":
        out_amax = fa.attention_i8_plain_f32(qkv_i8, amax, heads,
                                             scale).abs().max()
        args = (qkv_i8, amax, heads, scale, out_amax)
        return (lambda: fa.flash_attention_qkv_i8d(*args),
                lambda: fa.flash_attention_qkv_i8d_plain(*args))
    q, k, v = (qkv_i8[..., :C].contiguous(), qkv_i8[..., C:2 * C].contiguous(),
               qkv_i8[..., 2 * C:])
    n_valid = max(1, n - 5)
    out_amax = fa.attention_i8d_plain_f32(q, k, v, amax, heads, scale,
                                          n_valid).abs().max()
    args = (q, k, v, amax, heads, scale, out_amax, n_valid)
    return (lambda: fa.flash_attention_i8d(*args),
            lambda: fa.flash_attention_i8d_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["B2", "D2"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1568, 2049])
def test_attention_i8_wgmma_kernel_matches_plain(n, entry, cuda):
    kernel, plain = _i8_entry(entry, 2, n, 3, 64, 47, cuda)
    before = _route_before(I8_ROUTE_COUNTERS)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert _route_moved(I8_ROUTE_COUNTERS, before) == {"wgmma": 2,
                                                       "mma_sync": 0}
    assert torch.equal(got, again), "two launches differ"
    _assert_i8_codes(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 40, 48, 56, 64, 80, 88, 96, 128])
def test_attention_i8_routes_by_head_dim(d, cuda):
    """Each head dim takes the route attention_i8_route names (D2 pads 40
    and 56 to 48 and 64 and reads 88 in place; B2 takes multiples of 16),
    counted on that route only, and matches the plain version there."""
    route = fa.attention_i8_route(d)
    for entry in ("B2", "D2") if d % 16 == 0 else ("D2",):
        kernel, plain = _i8_entry(entry, 2, 129, 2, d, 49, cuda)
        before = _route_before(I8_ROUTE_COUNTERS)
        got = kernel()
        torch.cuda.synchronize()
        assert _route_moved(I8_ROUTE_COUNTERS, before) == {
            r: int(r == route) for r in I8_ROUTE_COUNTERS}, entry
        _assert_i8_codes(got, plain())


def _i8_unnormalized(entry, kernel_args):
    """The plain B2 / D2 call without the softmax denominator: a control
    the code bounds must reject."""
    if entry == "B2":
        qkv_i8, amax, heads, scale, out_amax = kernel_args
        C = qkv_i8.shape[-1] // 3
        q, k, v = qkv_i8[..., :C], qkv_i8[..., C:2 * C], qkv_i8[..., 2 * C:]
        n_valid = None
    else:
        q, k, v, amax, heads, scale, out_amax, n_valid = kernel_args
    qh, kh, vh = (fa._heads(t, heads) for t in (q, k, v))
    if n_valid is not None:
        kh, vh = kh[:, :, :n_valid], vh[:, :, :n_valid]
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    s = s * (sq * sk * scale * fa.LOG2E)
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    p = p.to(torch.bfloat16).float()
    o = torch.matmul(p, (vh.float() * sv).to(torch.bfloat16).float())
    return ln.quantize_static(fa._merge_heads(o), out_amax)


def _i8_args(entry, b, n, heads, d, seed, device):
    """The arguments of ``_i8_entry``'s kernel call (B2: qkv_i8, amax,
    heads, scale, out_amax; D2: q, k, v strided, amax, heads, scale,
    out_amax, n_valid = max(1, n - 5))."""
    qkv_i8, amax = _qkv_i8(b, n, heads, d, seed, device)
    C = heads * d
    scale = d ** -0.5
    if entry == "B2":
        out_amax = fa.attention_i8_plain_f32(qkv_i8, amax, heads,
                                             scale).abs().max()
        return (qkv_i8, amax, heads, scale, out_amax)
    q, k, v = (qkv_i8[..., :C].contiguous(), qkv_i8[..., C:2 * C].contiguous(),
               qkv_i8[..., 2 * C:])
    n_valid = max(1, n - 5)
    out_amax = fa.attention_i8d_plain_f32(q, k, v, amax, heads, scale,
                                          n_valid).abs().max()
    return (q, k, v, amax, heads, scale, out_amax, n_valid)


# B2 at the multiples of 16 it takes (no model calls it at 8 (mod 16)),
# D2 at every multiple of 8 from 72 to 128, 4 heads; and D2 with 3 heads
# at the head dims whose C = 3 d is then no multiple of 16
I8_WIDE_CASES = [(entry, d, 4) for d in range(72, fa.MAX_HEAD_DIM + 1, 8)
                 for entry in ("B2", "D2") if entry == "D2" or d % 16 == 0
                 ] + [("D2", d, 3) for d in (72, 88, 104, 120)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,d,heads", I8_WIDE_CASES)
@pytest.mark.parametrize("n", [1, 65, 2049])
def test_attention_i8_wide_wgmma_kernel_matches_plain(d, n, entry, heads,
                                                      cuda):
    """Head dims 72 to 128 on the wgmma route (B2 at the multiples of 16
    it takes, D2 at every multiple of 8, keys masked at n_valid = N - 5 and
    v the strided column block of the qkv tensor), 4 heads so that the
    last, odd head at d = 8 (mod 16) ends at the tensor's last columns:
    one launch counted on the wgmma route each, no head padded
    (_pad_heads not called, the output the kernel's own), two launches
    bit-equal, the codes within the plain version's bounds and the
    unnormalized control outside them.  With 3 heads at d = 8 (mod 16),
    C is no multiple of 16, so the kernel's maps cannot take the rows in
    place: D2 pads each head to d + 8 (_pad_heads on q, k and v) and
    slices the output, on the same route and to the same checks."""
    from unittest import mock
    args = _i8_args(entry, 2, n, heads, d, 53 + d, cuda)
    kernel = (fa.flash_attention_qkv_i8d if entry == "B2"
              else fa.flash_attention_i8d)
    plain = (fa.flash_attention_qkv_i8d_plain if entry == "B2"
             else fa.flash_attention_i8d_plain)
    padded = heads * d % 16 != 0
    before = _route_before(I8_ROUTE_COUNTERS)
    with mock.patch.object(fa, "_pad_heads", wraps=fa._pad_heads) as pad:
        got, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert pad.call_count == (6 if padded else 0)
    assert all(c.args[2] == d + 8 for c in pad.call_args_list)
    assert _route_moved(I8_ROUTE_COUNTERS, before) == {"wgmma": 2,
                                                       "mma_sync": 0}
    assert got.is_contiguous() and got.shape == (2, n, heads * d)
    assert torch.equal(got, again), "two launches differ"
    want = plain(*args)
    _assert_i8_codes(got, want)
    if n > 1:
        with pytest.raises(AssertionError):
            _assert_i8_codes(_i8_unnormalized(entry, args), want)


@pytest.mark.cuda
def test_attention_i8_route_is_the_kernel_dispatch(cuda):
    """attention_i8_route names the kernel csrc/attention_i8.cu's dispatch
    launches (stt_attention_i8_route) on the head dim the wrappers give it
    (attention_i8_head_dim: below 64 padded to 16, from 64 on as it is), at
    every head dim they take; the ones they refuse are refused by both, and
    the kernel refuses the head dims the wrappers pad."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    lib = kbuild.load()
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        dim = fa.attention_i8_head_dim(d)
        assert fa.FWD_ROUTES[lib.stt_attention_i8_route(dim)] == \
            fa.attention_i8_route(d), d
    for d in (0, 12, 136) + (8, 24, 40, 56):  # the last four: padded first
        assert lib.stt_attention_i8_route(d) == -1
        if d % 8 == 0 and 0 < d < 64:
            continue
        with pytest.raises(ValueError):
            fa.attention_i8_route(d)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 131, 1568])
def test_attention_int8_wgmma_kernel_matches_plain(n, cuda):
    qkv_i8, amax = _int8_codes(2, n, 3, 64, 50, cuda)
    scale = 0.125
    before = _route_before(INT8_ROUTE_COUNTERS)
    got = fa.flash_attention_qkv_int8(qkv_i8, amax, 3, scale)
    again = fa.flash_attention_qkv_int8(qkv_i8, amax, 3, scale)
    torch.cuda.synchronize()
    assert _route_moved(INT8_ROUTE_COUNTERS, before) == {"wgmma": 2,
                                                         "mma_sync": 0}
    assert torch.equal(got, again), "two launches differ"
    assert torch.equal(got, fa.flash_attention_qkv_int8_plain(
        qkv_i8, amax, 3, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48, 56, 64])
def test_attention_int8_routes_by_head_dim(d, cuda):
    """Each head dim takes the route attention_int8_route names (8, 24, 40
    and 56 padded to 16, 32, 48 and 64), counted on that route only, and
    matches the plain version there."""
    route = fa.attention_int8_route(d)
    qkv_i8, amax = _int8_codes(2, 129, 2, d, 51, cuda)
    scale = d ** -0.5
    before = _route_before(INT8_ROUTE_COUNTERS)
    got = fa.flash_attention_qkv_int8(qkv_i8, amax, 2, scale)
    torch.cuda.synchronize()
    assert _route_moved(INT8_ROUTE_COUNTERS, before) == {
        r: int(r == route) for r in INT8_ROUTE_COUNTERS}
    want = fa.flash_attention_qkv_int8_plain(qkv_i8, amax, 2, scale)
    _assert_within_one_code(got, want, qkv_i8, amax, 2, scale)


@pytest.mark.cuda
def test_attention_int8_route_is_the_kernel_dispatch(cuda):
    """attention_int8_route names the kernel csrc/attention_int8.cu's
    dispatch launches (stt_attention_int8_route) on the padded head dim, at
    every head dim the wrapper takes; the ones it refuses are refused by
    both."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    lib = kbuild.load()
    for d in range(8, fa.INT8_MAX_HEAD_DIM + 1, 8):
        padded = -(-d // 16) * 16
        assert fa.FWD_ROUTES[lib.stt_attention_int8_route(padded)] == \
            fa.attention_int8_route(d), d
    for d in (0, 12, 72, 128):
        assert lib.stt_attention_int8_route(d) == -1
        with pytest.raises(ValueError):
            fa.attention_int8_route(d)


@pytest.mark.cuda
def test_int8_attention_wrappers_reject_what_the_kernels_refuse(cuda):
    """B2 takes int8 at multiples of 16 up to 128, D2 int8 at multiples of
    8 up to 128 (it pads), E2 int8 at multiples of 8 up to 64: the head
    dims attention_i8_route and attention_int8_route refuse, and any other
    dtype, raise before a launch."""
    amax, one = torch.ones(6, device=cuda), torch.ones((), device=cuda)
    for c3 in (3 * 2 * 24, 3 * 2 * 136):
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_qkv_i8d(torch.zeros((1, 8, c3),
                                                   dtype=torch.int8,
                                                   device=cuda), amax, 2,
                                       0.2, one)
    with pytest.raises(ValueError, match="not int8"):
        fa.flash_attention_qkv_i8d(torch.zeros((1, 8, 384), device=cuda),
                                   amax, 2, 0.2, one)
    sep = [torch.zeros((1, 8, 24), dtype=torch.int8, device=cuda)] * 3
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_i8d(*sep, amax, 2, 0.2, one)
    with pytest.raises(ValueError):
        fa.flash_attention_i8d(*[t.float() for t in sep], amax, 2, 0.2, one)
    for c3, dtype in ((3 * 2 * 72, torch.int8), (384, torch.bfloat16)):
        with pytest.raises(ValueError):
            fa.flash_attention_qkv_int8(torch.zeros((1, 8, c3), dtype=dtype,
                                                    device=cuda), amax, 2,
                                        0.2)


# The pre-training (DAPT) and MVD / UMT shapes, bf16 at head dim 64 (the
# wgmma routes): the MAE-B encoder's visible tokens at mask 0.75 and 0.9
# (N = 392 and 160, and a 157-row tail), its decoder (all N = 1568 tokens at
# C = 384 packed, H = 6) and MVD-B's sequence with its CLS token (N = 1569:
# one row past a 64-row tile).
DAPT_CASES = [(2, 392, 12, 64), (2, 160, 12, 64), (2, 157, 12, 64),
              (2, 1568, 6, 64), (2, 1569, 12, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d", DAPT_CASES)
def test_training_attention_at_dapt_and_mvd_shapes(b, n, heads, d, cuda):
    """C1 and C2 against their plain versions, each call on the wgmma route
    and counted once; C1's output is A1's bit for bit."""
    dtype, scale = torch.bfloat16, d ** -0.5
    qkv = _randn((b, n, 3 * heads * d), 41, cuda).to(dtype)
    dout = _randn((b, n, heads * d), 42, cuda).to(dtype)
    routes = (fa.FWD_WGMMA_LAUNCHES, fa.BWD_WGMMA_LAUNCHES)
    out, lse = fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
    got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads, scale)
    torch.cuda.synchronize()
    assert (fa.FWD_WGMMA_LAUNCHES, fa.BWD_WGMMA_LAUNCHES) == (
        routes[0] + 1, routes[1] + 1)
    want_out, want_lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              scale)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL[dtype])
    assert torch.equal(out, fa.flash_attention_qkv(qkv, heads, scale))
    want = fa.flash_attention_qkv_bwd_plain(qkv, out, lse, dout, heads, scale)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BWD_TOL[dtype])


@pytest.mark.cuda
def test_tiny_mae_train_step_goes_through_kernels(cuda):
    """One MAE step of a 2 + 2 block PretrainVideoMAE (head dim 64 in the
    encoder and the decoder) with fp32 masters computed in bf16 runs C1 and
    C2 once per block, all on the wgmma routes, and the LayerNorm kernel
    2 * 2 + 1 times in each stack; gradients reach the fp32 masters."""
    from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
    from simple_tad_tpu_torch.models.mae import MAEConfig, PretrainVideoMAE
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_mae_train_step)
    cfg = MAEConfig(img_size=64, all_frames=4, encoder_embed_dim=128,
                    encoder_depth=2, encoder_num_heads=2,
                    decoder_embed_dim=64, decoder_depth=2,
                    decoder_num_heads=1, dtype=torch.bfloat16,
                    param_dtype=torch.float32)
    model = PretrainVideoMAE(cfg, device=cuda).init_weights(
        torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    state = TrainState.create(model, FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=1e-3,
        betas=(0.9, 0.95)), gen)
    maskgen = TubeMaskingGenerator((2, 4, 4), 0.75)
    step = make_mae_train_step(num_masked=maskgen.total_masks)
    batch = {"video": _randn((2, 4, 64, 64, 3), 43, cuda).bfloat16(),
             "mask": torch.from_numpy(maskgen.batch(
                 2, np.random.default_rng(0))).to(cuda)}
    names = ("LAUNCHES", "FWD_LSE_LAUNCHES", "BWD_LAUNCHES",
             "FWD_WGMMA_LAUNCHES", "BWD_WGMMA_LAUNCHES", "DELTA_LAUNCHES")
    counts = [ln.LAUNCHES] + [getattr(fa, n) for n in names]
    metrics = step(state, batch)
    torch.cuda.synchronize()
    after = [ln.LAUNCHES] + [getattr(fa, n) for n in names]
    assert [a - b for a, b in zip(after, counts)] == [10, 0, 4, 4, 4, 4, 4]
    assert torch.isfinite(metrics["loss"])
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert not torch.equal(p, before[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", [(8, 411, 384, 6),
                                         (2, 2049, 1408, 16)],
                         ids=["c3_distill_student", "a1_sep_iv2_1b"])
def test_attention_sep_at_distillation_shapes(b, n, c, heads, cuda):
    """The distillation job's shapes, bf16, v strided: the IV2-S student's
    training attention (C3-fwd, C3-bwd) at N = 411, a 27-row tail tile, on
    the wgmma routes; the IV2-1B teacher's A1 on separate operands at head
    dim 88, on the wgmma route too (96-column tiles).  Each against its
    plain version; C3's forward output is A1's bit for bit."""
    dtype, d = torch.bfloat16, c // heads
    scale = d ** -0.5
    qkv = _randn((b, n, 3 * c), 51, cuda).to(dtype)
    q, k, v = (qkv[..., :c].contiguous(), qkv[..., c:2 * c].contiguous(),
               qkv[..., 2 * c:])
    route = fa.attention_fwd_route(dtype, d)
    before = (fa.SEP_LAUNCHES, fa.FWD_WGMMA_LAUNCHES, fa.FWD_MMA_LAUNCHES)
    got = fa.flash_attention(q, k, v, heads, scale)
    torch.cuda.synchronize()
    moved = (fa.SEP_LAUNCHES - before[0], fa.FWD_WGMMA_LAUNCHES - before[1],
             fa.FWD_MMA_LAUNCHES - before[2])
    assert moved == (1, 1, 0)
    assert route == "wgmma"
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, heads, scale).float(),
        **TOL[dtype])
    if d == 88:
        return
    dout = _randn((b, n, c), 52, cuda).to(dtype)
    routes = (fa.FWD_WGMMA_LAUNCHES, fa.BWD_WGMMA_LAUNCHES)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, heads, scale)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, heads, scale)
    torch.cuda.synchronize()
    assert (fa.FWD_WGMMA_LAUNCHES, fa.BWD_WGMMA_LAUNCHES) == (
        routes[0] + 1, routes[1] + 1)
    assert torch.equal(out, got)
    want_out, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v, heads,
                                                          scale)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL[dtype])
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, heads,
                                        scale)
    for g, w in zip(grads, want):
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype])


@pytest.mark.cuda
def test_tiny_distill_step_goes_through_kernels(cuda):
    """One masked-feature distillation step (the attention mask) of a
    2-block DistillInternVideo2 student (head dim 64, fp32 masters in bf16)
    from a 3-block InternVideo2 teacher (head dim 88, bf16): the teacher's
    A1 on separate operands 3 times on the wgmma route, the student's
    C3-fwd and C3-bwd twice each on the wgmma routes with the delta
    pre-pass, nothing else; gradients reach the fp32 masters."""
    from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                          InternVideo2)
    from simple_tad_tpu_torch.models.iv2_distill import (DistillInternVideo2,
                                                         DistillIV2Config)
    from simple_tad_tpu_torch.train import distill as D
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import TrainState
    geo = dict(img_size=56, num_frames=4, attn_pool_num_heads=2,
               clip_embed_dim=64)
    teacher = InternVideo2(IV2Config(**geo, embed_dim=176, depth=3,
                                     num_heads=2, dtype=torch.bfloat16),
                           device=cuda).init_weights(
        torch.Generator(device=cuda).manual_seed(0))
    student = DistillInternVideo2(DistillIV2Config(
        **geo, embed_dim=128, depth=2, num_heads=2,
        clip_teacher_embed_dim=176, clip_teacher_final_dim=64,
        clip_return_layer=2, dtype=torch.bfloat16,
        param_dtype=torch.float32), device=cuda).init_weights(
        torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    state = TrainState.create(student, FinetuneOptimizer(
        dict(student.named_parameters()), lr_schedule=1e-3,
        betas=(0.9, 0.98), eps=1e-6), gen)
    num_masked = int(64 * 0.8)
    step = D.make_masked_distill_step(teacher, num_masked=num_masked,
                                      teacher_taps=(0, 2),
                                      mask_type="attention")
    names = ("SEP_LAUNCHES", "SEP_FWD_LSE_LAUNCHES", "SEP_BWD_LAUNCHES",
             "FWD_WGMMA_LAUNCHES", "FWD_MMA_LAUNCHES", "BWD_WGMMA_LAUNCHES",
             "DELTA_LAUNCHES", "LAUNCHES")
    counts = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    metrics = step(state, {"video": _randn((2, 4, 56, 56, 3), 53,
                                           cuda).bfloat16()})
    torch.cuda.synchronize()
    after = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    assert [a - b for a, b in zip(after, counts)] == [3, 2, 2, 5, 0, 2, 2,
                                                      0, 0]
    assert torch.isfinite(metrics["loss"])
    # the pooling head's key biases have no gradient in exact arithmetic
    # (they shift each softmax row by a constant): rounding noise may
    # leave them where they were
    still = {n for n, p in student.named_parameters()
             if torch.equal(p, before[n])}
    assert still <= {"clip_projector.cross_attn.k_bias",
                     "clip_projector.norm1_k.bias"}, still


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rng", "mask"])
def test_vit_b_remat_step_matches_the_plain_step(form, cuda):
    """One ViT-B 16x224 step (forward and backward, batch 2, bf16 compute,
    fp32 masters, drop path 0.1, attention dropout 0.1 in ``form``) with
    ``remat`` gives the step without it's loss and gradients bit for bit,
    leaves the generator where that step leaves it, and launches each
    attention kernel as often (the recompute takes the forward's (out,
    lse): models/layers.py:checkpoint_block); only the LayerNorm kernel
    runs again, twice a block."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.train.losses import cross_entropy
    names = ("FWD_LSE_LAUNCHES", "BWD_LAUNCHES", "DROP_FWD_LAUNCHES",
             "DROP_BWD_LAUNCHES", "DROP_RNG_FWD_LAUNCHES",
             "DROP_RNG_BWD_LAUNCHES", "DELTA_LAUNCHES", "LAUNCHES",
             "FWD_WGMMA_LAUNCHES", "BWD_WGMMA_LAUNCHES")
    video = _randn((2, 16, 224, 224, 3), 40, cuda).bfloat16()
    labels = torch.tensor([0, 1], device=cuda)
    runs = []
    for remat in (False, True):
        model = create_model("vit_base_patch16_224", device=cuda,
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16, param_dtype=torch.float32,
                             drop_path_rate=0.1, attn_drop_rate=0.1,
                             attn_dropout_form=form, remat=remat).train()
        gen = torch.Generator(device=cuda)
        gen.manual_seed(1)
        counts = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
        loss = cross_entropy(model(video, generator=gen), labels)
        loss.backward()
        torch.cuda.synchronize()
        counts = [getattr(fa, n) - c for n, c in zip(names, counts)] + [
            ln.LAUNCHES - counts[-1]]
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()},
                     gen.get_state(), counts))
        del model
    (loss, grads, state, counts), (rloss, rgrads, rstate, rcounts) = runs
    assert counts[:-1] == rcounts[:-1] and sum(counts[:-1]) > 0, (counts,
                                                                  rcounts)
    assert rcounts[-1] == counts[-1] + 2 * 12, (counts, rcounts)
    assert torch.equal(rloss, loss)
    assert torch.equal(rstate, state)
    for n, g in grads.items():
        assert torch.equal(rgrads[n], g), n
