"""Row LayerNorm with fp32 statistics: the CUDA kernels and their plain
versions.

Port of simple_tad_tpu/ops/ln.py:fused_layernorm (TPU kernel _ln_kernel)
and fused_layernorm_quant (TPU kernel _ln_quant_kernel).  The kernels are
csrc/layernorm.cu: one thread block per row reads the row once from
device memory (LayerNorm is bandwidth-bound on the H100; see the note at
the top of the source).  Unlike the TPU gate (C % 128 == 0, and C <= 512
by default), the kernels take any C up to 4096: ``layernorm`` serves every
LayerNorm of the bf16 ViT (norm1, norm2, fc_norm), ``layernorm_quant`` the
int8 model's norm1 and norm2, whose output is the next GEMM's int8 input.

Training: ``LayerNormFn`` is the port of the JAX package's custom VJP
(_fused_ln_core): its forward is ``layernorm`` (the kernel on a CUDA
tensor), its backward the plain math of _fused_ln_bwd (fp32 recompute of
mean and rstd; dx in x's dtype, dweight and dbias in fp32).  The JAX
backward is not a Pallas kernel, so neither is this one.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the LayerNorm
kernel, ``QUANT_LAUNCHES`` those of the LayerNorm->int8 kernel.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild

MAX_COLS = 4096
LAUNCHES = 0
QUANT_LAUNCHES = 0


def _normalize_f32(x, weight, bias, eps):
    """fp32 mean and biased variance of the centred values, rsqrt(var+eps),
    fp32 affine -> fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def quantize_static(y, amax):
    """clip(round_half_even(y * 127 / max(amax, 1e-12)), +-127) as int8:
    the static symmetric codes of fp32 ``y`` against a calibrated absmax."""
    inv = 127.0 / torch.clamp(amax.float(), min=1e-12)
    return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)


def layernorm_plain(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """LayerNorm in fp32, cast to ``out_dtype`` (default: x's dtype)."""
    return _normalize_f32(x, weight, bias, eps).to(out_dtype or x.dtype)


def layernorm_quant_plain(x, weight, bias, amax, eps: float = 1e-6):
    """LayerNorm in fp32, then the static int8 codes against ``amax`` (the
    fp32 values are quantized, not their cast to x's dtype)."""
    return quantize_static(_normalize_f32(x, weight, bias, eps), amax)


def _check(name, x, weight, bias):
    C = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not 0 < C <= MAX_COLS:
        raise ValueError(f"{name}: C={C} outside 1..{MAX_COLS}")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{name}: weight and bias must have shape (C,)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"{name}: weight and bias must be on x's device")
    return x.numel() // C, C


def layernorm(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """LayerNorm over the last axis.  x: (..., C) bf16 or fp32, contiguous;
    weight, bias: (C,) -> (..., C) in ``out_dtype`` (default: x's dtype)."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    rows, C = _check("layernorm", x, weight, bias)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if rows == 0:
        return out
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    lib = kbuild.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.stt_layernorm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), rows, C, float(eps),
                             kbuild.dtype_code(x.dtype),
                             kbuild.dtype_code(out_dtype), stream)
    kbuild.check(code, "layernorm")
    global LAUNCHES
    LAUNCHES += 1
    return out


def layernorm_quant(x, weight, bias, amax, eps: float = 1e-6):
    """LayerNorm over the last axis, then its static int8 codes.

    x: (..., C) bf16 or fp32, contiguous; weight, bias: (C,); amax: one
    fp32 value on x's device (the calibrated absmax of the LayerNorm
    output) -> (..., C) int8.
    """
    if x.device.type == "cpu":
        return layernorm_quant_plain(x, weight, bias, amax, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_quant: unsupported device {x.device}")
    rows, C = _check("layernorm_quant", x, weight, bias)
    if amax.numel() != 1 or amax.device != x.device \
            or amax.dtype != torch.float32:
        raise ValueError("layernorm_quant: amax must be one fp32 value on "
                         "x's device")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if rows == 0:
        return out
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    lib = kbuild.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.stt_layernorm_quant(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                   amax.data_ptr(), out.data_ptr(), rows, C,
                                   float(eps), kbuild.dtype_code(x.dtype),
                                   stream)
    kbuild.check(code, "layernorm_quant")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return out


def layernorm_bwd(x, weight, dy, eps: float = 1e-6):
    """The LayerNorm backward of simple_tad_tpu/ops/ln.py:_fused_ln_bwd:
    -> (dx in x's dtype, dweight, dbias in fp32)."""
    C = x.shape[-1]
    x32 = x.float()
    dy32 = dy.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * r
    dxhat = dy32 * weight.float()
    dx = r * (dxhat - dxhat.mean(dim=-1, keepdim=True)
              - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dweight = (dy32 * xhat).reshape(-1, C).sum(dim=0)
    dbias = dy32.reshape(-1, C).sum(dim=0)
    return dx.to(x.dtype), dweight, dbias


class LayerNormFn(torch.autograd.Function):
    """Differentiable ``layernorm``: the kernel forward, the plain backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, out_dtype):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return layernorm(x, weight, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dweight, dbias = layernorm_bwd(x, weight, dy, ctx.eps)
        wdt, bdt = ctx.param_dtypes
        return dx, dweight.to(wdt), dbias.to(bdt), None, None
