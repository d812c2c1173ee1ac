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

The int8 serving path's attention is ``flash_attention_qkv_i8d``, port of
flash_attention_qkv_i8d with ``out_amax`` (TPU kernel
_fwd_kernel_nomax_packed_q8io): int8 qkv in, int8 out, computed in bf16
whatever the model dtype (csrc/attention_i8.cu).  The TPU kernel's
bf16-output mode is reached only through an environment knob of the JAX
package and is not ported.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the bf16/fp32
kernel, ``I8_LAUNCHES`` those of the int8 one.
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild
from simple_tad_tpu_torch.ops.ln import quantize_static

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
LAUNCHES = 0
I8_LAUNCHES = 0


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


def attention_i8_plain_f32(qkv_i8, amax, num_heads: int, scale: float):
    """The int8 attention before its output epilogue -> (B, N, C) fp32.

    qkv_i8 (B, N, 3C) int8 per-head codes against amax (3, H) fp32.  Per
    head, with sq, sk, sv = amax / 127: s = (q_i8 . k_i8) * (sq*sk*scale*
    log2e); p = exp2(s - m) rounded to bf16 (m the row max rounded up to an
    integer, so p is the max-free value times an exact 2^-m); the
    denominator sums the rounded p; v = bf16(v_i8 * sv); o = (p v) / denom
    in fp32.  The int8 product runs as an fp32 matmul: every partial sum is
    an integer below 127^2 * 128 < 2^24, so it is exact.
    """
    B, N, C3 = qkv_i8.shape
    q, k, v = _split_heads(qkv_i8, num_heads)              # (B, H, N, Dh)
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * LOG2E)
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(torch.bfloat16).float()
    vf = (v.float() * sv).to(torch.bfloat16).float()
    o = torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).reshape(B, N, C3 // 3)


def flash_attention_qkv_i8d_plain(qkv_i8, amax, num_heads: int,
                                  scale: float, out_amax):
    """The int8 attention with its int8 epilogue against ``out_amax``."""
    return quantize_static(
        attention_i8_plain_f32(qkv_i8, amax, num_heads, scale), out_amax)


def flash_attention_qkv_i8d(qkv_i8, amax, num_heads: int, scale: float,
                            out_amax):
    """Non-causal attention on int8-stored packed qkv -> int8 (B, N, C).

    qkv_i8: (B, N, 3C) int8, contiguous, [q | k | v] columns each
    (H, Dh)-major, Dh a multiple of 16 and at most 128; amax: (3, H) fp32,
    the per-head absmax the codes were made against; out_amax: one fp32
    value, the absmax the output codes are made against.  Both scales stay
    on the device (no host synchronisation).
    """
    if qkv_i8.device.type == "cpu":
        return flash_attention_qkv_i8d_plain(qkv_i8, amax, num_heads, scale,
                                             out_amax)
    if qkv_i8.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv_i8d: unsupported device "
                         f"{qkv_i8.device}")
    if qkv_i8.dtype != torch.int8 or qkv_i8.dim() != 3 \
            or qkv_i8.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv_i8d: qkv {qkv_i8.dtype} "
                         f"{tuple(qkv_i8.shape)} is not int8 "
                         f"(B, N, 3 * {num_heads} * Dh)")
    B, N, C3 = qkv_i8.shape
    C = C3 // 3
    D = C // num_heads
    if D % 16 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_qkv_i8d: head dim {D} must be a "
                         f"multiple of 16 and at most {MAX_HEAD_DIM}")
    if not qkv_i8.is_contiguous() or qkv_i8.data_ptr() % 16:
        raise ValueError("flash_attention_qkv_i8d: qkv must be contiguous "
                         "and 16-byte aligned")
    if not scale > 0:
        raise ValueError(f"flash_attention_qkv_i8d: scale {scale} must be "
                         f"> 0")
    for name, t, numel in (("amax", amax, 3 * num_heads),
                           ("out_amax", out_amax, 1)):
        if t.numel() != numel or t.dtype != torch.float32 \
                or t.device != qkv_i8.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_qkv_i8d: {name} must be "
                             f"{numel} contiguous fp32 values on qkv's "
                             f"device")
    out = torch.empty((B, N, C), dtype=torch.int8, device=qkv_i8.device)
    if B == 0 or N == 0:
        return out
    lib = kbuild.load()
    base = qkv_i8.data_ptr()
    stream = torch.cuda.current_stream(qkv_i8.device).cuda_stream
    code = lib.stt_attention_i8(
        base, base + C, base + 2 * C, amax.data_ptr(), out_amax.data_ptr(),
        out.data_ptr(), B, N, num_heads, D, N * C3, C3, N * C, C,
        float(scale), stream)
    kbuild.check(code, "attention_i8")
    global I8_LAUNCHES
    I8_LAUNCHES += 1
    return out
