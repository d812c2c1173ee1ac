"""Row LayerNorm with fp32 statistics: the CUDA kernels and their plain
versions.

Port of simple_tad_tpu/ops/ln.py:fused_layernorm (TPU kernel _ln_kernel)
and fused_layernorm_quant (TPU kernel _ln_quant_kernel).  The kernels are
csrc/layernorm.cu: one warp a row, on a persistent grid, reads the row
once from device memory (LayerNorm is bandwidth-bound on the H100; see the
note at the top of the source).  Unlike the TPU gate (C % 128 == 0, and C <= 512
by default), the kernels take any C up to 4096: ``layernorm`` serves every
LayerNorm of the bf16 ViT (norm1, norm2, fc_norm), ``layernorm_quant`` the
int8 model's norm1 and norm2, whose output is the next GEMM's int8 input.

Residual add + LayerNorm->int8 (kernel E1, csrc/layernorm.cu
``stt_add_layernorm_quant``): port of fused_add_layernorm_quant (TPU kernel
_add_ln_quant_kernel), the static int8 ViT's deferred-residual carry
(``add_lnq``).  It returns the sum residual + branch rounded to their dtype
and the codes of ``layernorm_quant`` of that stored sum: B1's kernel with the
add in front, so its codes equal B1's of the sum bit for bit.

RMSNorm->int8 (kernel D3, csrc/layernorm.cu ``stt_rmsnorm_quant``): port
of fused_rmsnorm_quant (TPU kernel _rms_quant_kernel), InternVideo2's
static int8 serving with the fused RMSNorm->int8 option.  fp32 mean(x^2),
rsqrt(var + eps), times the weight, then the codes against a per-channel
127 / amax vector; the fp32 value is quantized, not its cast to x's dtype.

Training: ``LayerNormFn`` is the port of the JAX package's custom VJP
(_fused_ln_core): its forward is ``layernorm`` (the kernel on a CUDA
tensor), its backward the plain math of _fused_ln_bwd (fp32 recompute of
mean and rstd; dx in x's dtype, dweight and dbias in fp32).  The JAX
backward is not a Pallas kernel, so neither is this one.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the LayerNorm
kernel, ``QUANT_LAUNCHES`` those of the LayerNorm->int8 kernel,
``ADD_QUANT_LAUNCHES`` those of the add + LayerNorm->int8 kernel,
``RMSQ_LAUNCHES`` those of the RMSNorm->int8 kernel.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild

MAX_COLS = 4096
LAUNCHES = 0
QUANT_LAUNCHES = 0
ADD_QUANT_LAUNCHES = 0
RMSQ_LAUNCHES = 0


def _normalize_f32(x, weight, bias, eps):
    """fp32 mean and biased variance of the centred values, rsqrt(var+eps),
    fp32 affine -> fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def quant_scale(amax):
    """127 / max(amax, 1e-12) in fp32, by IEEE division, as the JAX package
    and the kernels' quant_inv (csrc/common.cuh) compute it.  (Python's
    ``127.0 / tensor`` is torch's reciprocal times 127, which rounds to
    another fp32 value for about a quarter of absmax values and then moves
    the codes that sit at a rounding boundary.)"""
    amax = torch.clamp(amax.float(), min=1e-12)
    return torch.full_like(amax, 127.0) / amax


def quantize_static(y, amax):
    """clip(round_half_even(y * 127 / max(amax, 1e-12)), +-127) as int8:
    the static symmetric codes of fp32 ``y`` against a calibrated absmax."""
    return torch.clamp(torch.round(y * quant_scale(amax)), -127,
                       127).to(torch.int8)


def layernorm_plain(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """LayerNorm in fp32, cast to ``out_dtype`` (default: x's dtype)."""
    return _normalize_f32(x, weight, bias, eps).to(out_dtype or x.dtype)


def layernorm_quant_plain(x, weight, bias, amax, eps: float = 1e-6):
    """LayerNorm in fp32, then the static int8 codes against ``amax`` (the
    fp32 values are quantized, not their cast to x's dtype)."""
    return quantize_static(_normalize_f32(x, weight, bias, eps), amax)


def _check(name, x, *vectors):
    """x (..., C) contiguous and its (C,) parameter vectors on its device
    -> (rows, C)."""
    C = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not 0 < C <= MAX_COLS:
        raise ValueError(f"{name}: C={C} outside 1..{MAX_COLS}")
    if any(t.shape != (C,) for t in vectors):
        raise ValueError(f"{name}: the parameter vectors must have shape "
                         f"(C,)")
    if any(t.device != x.device for t in vectors):
        raise ValueError(f"{name}: the parameter vectors must be on x's "
                         f"device")
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


def add_layernorm_quant_plain(branch, residual, weight, bias, amax,
                              eps: float = 1e-6):
    """-> (sum, codes): residual + branch in fp32 rounded to branch's
    dtype, and ``layernorm_quant_plain`` of that stored sum."""
    total = (branch.float() + residual.float()).to(branch.dtype)
    return total, layernorm_quant_plain(total, weight, bias, amax, eps)


def add_layernorm_quant(branch, residual, weight, bias, amax,
                        eps: float = 1e-6):
    """The residual add, then LayerNorm->int8 of the sum.

    branch, residual: (..., C) bf16 or fp32 of one shape and dtype,
    contiguous; weight, bias: (C,); amax: one fp32 value on their device ->
    (sum in their dtype, int8 codes), both (..., C).
    """
    if branch.device.type == "cpu":
        return add_layernorm_quant_plain(branch, residual, weight, bias, amax,
                                         eps)
    if branch.device.type != "cuda":
        raise ValueError(f"add_layernorm_quant: unsupported device "
                         f"{branch.device}")
    if residual.shape != branch.shape or residual.dtype != branch.dtype \
            or residual.device != branch.device \
            or not residual.is_contiguous():
        raise ValueError("add_layernorm_quant: residual must be contiguous "
                         "and share the branch's shape, dtype and device")
    rows, C = _check("add_layernorm_quant", branch, weight, bias)
    if amax.numel() != 1 or amax.device != branch.device \
            or amax.dtype != torch.float32:
        raise ValueError("add_layernorm_quant: amax must be one fp32 value "
                         "on the inputs' device")
    total = torch.empty_like(branch)
    out = torch.empty(branch.shape, dtype=torch.int8, device=branch.device)
    if rows == 0:
        return total, out
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    lib = kbuild.load()
    stream = torch.cuda.current_stream(branch.device).cuda_stream
    code = lib.stt_add_layernorm_quant(
        branch.data_ptr(), residual.data_ptr(), w.data_ptr(), b.data_ptr(),
        amax.data_ptr(), total.data_ptr(), out.data_ptr(), rows, C,
        float(eps), kbuild.dtype_code(branch.dtype), stream)
    kbuild.check(code, "add_layernorm_quant")
    global ADD_QUANT_LAUNCHES
    ADD_QUANT_LAUNCHES += 1
    return total, out


def rmsnorm_quant_plain(x, weight, inv_c, eps: float = 1e-6):
    """RMSNorm in fp32 (no mean subtraction, no bias), then the int8 codes
    clip(round_half_even(y * inv_c), +-127) against the per-channel inverse
    scales ``inv_c`` (C,)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * weight.float()
    return torch.clamp(torch.round(y * inv_c.float()), -127,
                       127).to(torch.int8)


def rmsnorm_quant(x, weight, inv_c, eps: float = 1e-6):
    """RMSNorm over the last axis, then its static int8 codes.

    x: (..., C) bf16 or fp32, contiguous; weight: (C,); inv_c: (C,) fp32
    127 / amax per channel, on x's device -> (..., C) int8.
    """
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, weight, inv_c, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_quant: unsupported device {x.device}")
    rows, C = _check("rmsnorm_quant", x, weight, inv_c)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if rows == 0:
        return out
    w = weight.float().contiguous()
    inv = inv_c.float().contiguous()
    lib = kbuild.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.stt_rmsnorm_quant(x.data_ptr(), w.data_ptr(), inv.data_ptr(),
                                 out.data_ptr(), rows, C, float(eps),
                                 kbuild.dtype_code(x.dtype), stream)
    kbuild.check(code, "rmsnorm_quant")
    global RMSQ_LAUNCHES
    RMSQ_LAUNCHES += 1
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
