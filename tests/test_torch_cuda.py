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
    runs C1 and C2 once per block, the LayerNorm kernel 5 times and the
    inference attention never; gradients reach the fp32 masters."""
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
    counts = (ln.LAUNCHES, fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES)
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    after = (ln.LAUNCHES, fa.LAUNCHES, fa.FWD_LSE_LAUNCHES, fa.BWD_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (5, 0, 2, 2)
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
    """v strided from an int8 (B, N, 3C) tensor; d = 40 and 88 run padded
    to 48 and 96."""
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
                                   (2, 1408)])
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


@pytest.mark.cuda
def test_tiny_iv2_train_step_goes_through_kernels(cuda):
    """One train step of a 2-layer IV2-S with fp32 masters computed in bf16
    runs C3-fwd and C3-bwd once per block and no other kernel (RMSNorm,
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
             "SEP_FWD_LSE_LAUNCHES", "SEP_BWD_LAUNCHES")
    counts = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    after = [getattr(fa, n) for n in names] + [ln.LAUNCHES]
    assert [a - b for a, b in zip(after, counts)] == [0, 0, 0, 0, 2, 2, 0]
    assert torch.isfinite(metrics["loss"]) and logits.shape == (2, 2)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        if n.startswith("blocks."):
            assert not torch.equal(p, before[n]), n
