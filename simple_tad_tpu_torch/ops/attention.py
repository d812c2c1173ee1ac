"""Attention dispatch: packed qkv (B, N, 3C) -> (B, N, C).

Port of simple_tad_tpu/ops/attention.py:dot_product_attention_qkv.  The
bf16/fp32 path is ops/flash_attention.py:flash_attention_qkv; the int8
static-quant path is ``dot_product_attention_qkv_i8`` (the JAX Attention
module's int8-storage branch, models/layers.py there): qkv quantized per
head against calibrated scales, then flash_attention_qkv_i8d.  Each is the
CUDA kernel on a CUDA tensor and its plain version on a CPU tensor.  The
JAX package's environment knobs are not ported; attention dropout is
training work.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, flash_attention_qkv, flash_attention_qkv_i8d)


def dot_product_attention_qkv(qkv, *, num_heads: int, scale: float,
                              dropout_rate: float = 0.0):
    """qkv: (B, N, 3C) in [q | k | v] column order -> (B, N, C)."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is training work (ROADMAP.md queue 1, frame "
            "fine-tuning)")
    return flash_attention_qkv(qkv, num_heads=num_heads, scale=scale)


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
    inv = 127.0 / torch.clamp(qkv_amax.float(), min=1e-12)
    inv_vec = inv.reshape(-1).repeat_interleave(D)
    qkv_i8 = torch.clamp(torch.round(qkv.float() * inv_vec), -127,
                         127).to(torch.int8)
    return flash_attention_qkv_i8d(qkv_i8, qkv_amax, num_heads, scale,
                                   out_amax)
