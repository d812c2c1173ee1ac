"""Row LayerNorm with fp32 statistics: the CUDA kernel and its plain version.

Port of simple_tad_tpu/ops/ln.py:fused_layernorm (TPU kernel _ln_kernel).
The kernel is csrc/layernorm.cu: one thread block per row reads the row
once from device memory (LayerNorm is bandwidth-bound on the H100; see the
note at the top of the source).  Unlike the TPU gate (C % 128 == 0, and
C <= 512 by default), the kernel takes any C up to 4096 and serves every
LayerNorm of the ViT: norm1, norm2 and fc_norm.

Dispatch: a CPU tensor takes ``layernorm_plain``; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild

MAX_COLS = 4096
LAUNCHES = 0


def layernorm_plain(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """fp32 mean and biased variance of the centred values, rsqrt(var+eps),
    fp32 affine, cast to ``out_dtype`` (default: x's dtype)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(out_dtype or x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """LayerNorm over the last axis.  x: (..., C) bf16 or fp32, contiguous;
    weight, bias: (C,) -> (..., C) in ``out_dtype`` (default: x's dtype)."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    C = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("layernorm: x must be contiguous")
    if not 0 < C <= MAX_COLS:
        raise ValueError(f"layernorm: C={C} outside 1..{MAX_COLS}")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError("layernorm: weight and bias must have shape (C,)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("layernorm: weight and bias must be on x's device")
    rows = x.numel() // C
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
