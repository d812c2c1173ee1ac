"""Packed-qkv inference attention: the CUDA kernel and its plain version.

Port of simple_tad_tpu/ops/flash_attention.py:flash_attention_qkv, whose
TPU kernel is _fwd_kernel_nomax_packed with _attend_rows_t.  The kernel is
csrc/attention.cu: it reads q, k and v in place from the (B, N, 3C) qkv
projection output (no slice copies, no head relayout) and runs both
products on the tensor cores (attention at N=1568, Dh=64 is compute-bound
once tiled; see the note at the top of the source).

Numerics (both versions): q is pre-scaled by scale*log2(e) and rounded to
the input dtype; QK accumulates in fp32; probabilities are exp2(s - m)
rounded to the v dtype, and the denominator sums those rounded values; PV
accumulates in fp32.  The TPU kernel is max-free (m = 0).  Here m is the
row maximum rounded up to an integer, so exp2 cannot overflow while every
rounded probability is the max-free one times the exact power of two 2^-m:
the result is the max-free result.

Dispatch: a CPU tensor takes ``flash_attention_qkv_plain``; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
LAUNCHES = 0


def _split_heads(qkv, num_heads: int):
    B, N, C3 = qkv.shape
    C = C3 // 3
    return qkv.view(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)


def flash_attention_qkv_plain(qkv, num_heads: int, scale: float):
    """qkv (B, N, 3C) in [q | k | v] x (H, Dh)-major columns -> (B, N, C)."""
    B, N, C3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)                 # (B, H, N, Dh)
    qs = (q.float() * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(v.dtype)
    denom = p.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(p.float(), v.float()) / denom
    return o.to(dt).permute(0, 2, 1, 3).reshape(B, N, C3 // 3)


def flash_attention_qkv(qkv, num_heads: int, scale: float):
    """Non-causal attention straight off the packed qkv projection.

    qkv: (B, N, 3C) bf16 or fp32, contiguous, [q | k | v] columns each
    (H, Dh)-major; Dh a multiple of 8 and at most 128 -> (B, N, C) in
    qkv's dtype.
    """
    if qkv.device.type == "cpu":
        return flash_attention_qkv_plain(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv: unsupported device "
                         f"{qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv: qkv {tuple(qkv.shape)} is "
                         f"not (B, N, 3 * {num_heads} * Dh)")
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_qkv: head dim {D} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: qkv must be contiguous")
    if not scale > 0:
        raise ValueError(f"flash_attention_qkv: scale {scale} must be > 0")
    if qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be 16-byte aligned")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    lib = kbuild.load()
    esz = qkv.element_size()
    base = qkv.data_ptr()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    code = lib.stt_attention_fwd(
        base, base + C * esz, base + 2 * C * esz, out.data_ptr(),
        B, N, num_heads, D, N * C3, C3, N * C, C,
        float(scale * LOG2E), kbuild.dtype_code(qkv.dtype), stream)
    kbuild.check(code, "attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
