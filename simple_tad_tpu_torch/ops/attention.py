"""Attention dispatch: packed qkv (B, N, 3C), or separate q, k, v
(B, N, C) -> (B, N, C).

Port of simple_tad_tpu/ops/attention.py:dot_product_attention_qkv and
dot_product_attention.  The packed bf16/fp32 path is
ops/flash_attention.py:flash_attention_qkv; the int8 static-quant path is
``dot_product_attention_qkv_i8`` (the JAX Attention module's int8-storage
branch, models/layers.py there): qkv quantized per head against
calibrated scales, then flash_attention_qkv_i8d.  Each is the CUDA kernel
on a CUDA tensor and its plain version on a CPU tensor.  In training (grad
mode, qkv requiring grad) flash_attention_qkv is the training attention
(forward with lse, backward; kernels C1 and C2).  The JAX package's
environment knobs are not ported.

Separate operands (InternVideo2's attention, whose q and k are
RMS-normalised after the projection): ``dot_product_attention`` is
ops/flash_attention.py:flash_attention; its static int8 form
``dot_product_attention_i8_sep`` (the JAX IV2Attention's int8-storage
branch) quantizes each operand per head against the calibrated
``qkv_amax``, unless it already arrives as int8 codes (the fused
RMSNorm->int8 q/k-norms), then runs flash_attention_i8d.

Attention dropout (the JAX package's kernels C4) is not ported: callers
pass a dropout rate only in training, and a positive one raises.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, flash_attention, flash_attention_i8d, flash_attention_qkv,
    flash_attention_qkv_i8d)


def _no_dropout(dropout_rate: float):
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout needs the dropout attention kernels C4, not "
            "ported yet (ROADMAP.md queue 2)")


def dot_product_attention_qkv(qkv, *, num_heads: int, scale: float,
                              dropout_rate: float = 0.0):
    """qkv: (B, N, 3C) in [q | k | v] column order -> (B, N, C).
    ``dropout_rate``: the attention dropout in effect (0 outside training)."""
    _no_dropout(dropout_rate)
    return flash_attention_qkv(qkv, num_heads=num_heads, scale=scale)


def dot_product_attention(q, k, v, *, num_heads: int, scale: float,
                          dropout_rate: float = 0.0):
    """Separate (B, N, C) q, k, v (each may be a strided column view) ->
    (B, N, C).  ``dropout_rate``: the attention dropout in effect."""
    _no_dropout(dropout_rate)
    return flash_attention(q, k, v, num_heads=num_heads, scale=scale)


def quantize_per_head(t, amax, num_heads: int):
    """(B, N, C) float -> int8 codes clip(round_half_even(t * 127 / amax),
    +-127) with ``amax`` (H,) the absmax of each head's columns."""
    D = t.shape[-1] // num_heads
    inv = 127.0 / torch.clamp(amax.float(), min=1e-12)
    return torch.clamp(torch.round(t.float() * inv.repeat_interleave(D)),
                       -127, 127).to(torch.int8)


def dot_product_attention_i8_sep(q, k, v, qkv_amax, out_amax, *,
                                 num_heads: int, scale: float,
                                 n_valid=None):
    """Static int8 attention on separate operands -> int8 (B, N, C) codes
    against ``out_amax``.  q, k, v: (B, N, C) float, or int8 codes already
    made against their row of ``qkv_amax`` (3, H); ``n_valid``: keys at or
    beyond it are masked."""
    D = q.shape[-1] // num_heads
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"int8 attention at head dim {D}: the int8-storage kernel takes "
            f"multiples of 8 up to {MAX_HEAD_DIM}")
    q, k, v = (t if t.dtype == torch.int8
               else quantize_per_head(t, qkv_amax[row], num_heads)
               for row, t in enumerate((q, k, v)))
    return flash_attention_i8d(q, k, v, qkv_amax, num_heads, scale, out_amax,
                               n_valid)


def dot_product_attention_qkv_i8(qkv, qkv_amax, out_amax, *, num_heads: int,
                                 scale: float):
    """Static int8 attention: qkv (B, N, 3C) float, post-bias -> int8
    (B, N, C) codes against ``out_amax``.

    qkv is quantized per head against ``qkv_amax`` (3, H):
    clip(round(qkv * 127 / amax), +-127), then read by the int8-storage
    kernel.  Unlike the TPU gate, any N and channel width are taken, and
    any head dim that is a multiple of 16 up to 128 (80 zero-pads to 96).
    """
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    if D % 16 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"int8 attention at head dim {D}: the int8-storage kernel takes "
            f"multiples of 16 up to 128; other geometries need the int8-"
            f"output bf16 kernel B3 (ROADMAP.md queue 2)")
    qkv_i8 = quantize_per_head(qkv, qkv_amax.reshape(-1), 3 * num_heads)
    return flash_attention_qkv_i8d(qkv_i8, qkv_amax, num_heads, scale,
                                   out_amax)
