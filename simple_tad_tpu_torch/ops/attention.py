"""Attention dispatch: packed qkv (B, N, 3C) -> (B, N, C).

Port of simple_tad_tpu/ops/attention.py:dot_product_attention_qkv.  There
is one path: ops/flash_attention.py (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor).  The JAX package's environment knobs are
not ported; attention dropout is training work.
"""

from __future__ import annotations

from simple_tad_tpu_torch.ops.flash_attention import flash_attention_qkv


def dot_product_attention_qkv(qkv, *, num_heads: int, scale: float,
                              dropout_rate: float = 0.0):
    """qkv: (B, N, 3C) in [q | k | v] column order -> (B, N, C)."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is training work (ROADMAP.md queue 1, frame "
            "fine-tuning)")
    return flash_attention_qkv(qkv, num_heads=num_heads, scale=scale)
