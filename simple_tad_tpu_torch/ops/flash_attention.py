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

Training (port of the packed custom VJP, _flash_core_packed_qkv with
_packed_train_ok): ``flash_attention_qkv`` on a qkv that requires grad, in
grad mode, goes through ``FlashAttentionQKV``, whose forward is
``flash_attention_qkv_fwd_lse`` (TPU kernel _fwd_kernel_nomax_packed_lse:
A1 that also returns lse = log2 of the denominator, (B, H, N) fp32) and
whose backward is ``flash_attention_qkv_bwd`` (TPU kernel
_bwd_merged_kernel_packed: dq, dk, dv from qkv, out, lse, dout and
delta = rowsum(dout * out), written as one (B, N, 3C) gradient in
[dq | dk | dv] column order; csrc/attention_train.cu).  It saves
(qkv, out, lse), as the JAX forward does.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the bf16/fp32
inference kernel, ``I8_LAUNCHES`` those of the int8 one,
``FWD_LSE_LAUNCHES`` those of the training forward and ``BWD_LAUNCHES``
calls of the training backward (each call launches two kernels: dk/dv,
then dq).
"""

from __future__ import annotations

import torch

from simple_tad_tpu_torch.kernels import build as kbuild
from simple_tad_tpu_torch.ops.ln import quantize_static

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
LAUNCHES = 0
I8_LAUNCHES = 0
FWD_LSE_LAUNCHES = 0
BWD_LAUNCHES = 0


def _split_heads(qkv, num_heads: int):
    B, N, C3 = qkv.shape
    C = C3 // 3
    return qkv.view(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)


def _acc(dtype):
    """Accumulation dtype of the plain versions: fp32, or fp64 for fp64
    inputs (gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _attention_plain(qkv, num_heads: int, scale: float):
    """-> (out (B, N, C) in qkv's dtype, lse (B, H, N) base 2)."""
    B, N, C3 = qkv.shape
    dt, acc = qkv.dtype, _acc(qkv.dtype)
    q, k, v = _split_heads(qkv, num_heads)                 # (B, H, N, Dh)
    qs = (q.to(acc) * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(v.dtype)
    denom = p.to(acc).sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(acc), v.to(acc)) / denom
    lse = (m + torch.log2(denom))[..., 0]
    return o.to(dt).permute(0, 2, 1, 3).reshape(B, N, C3 // 3), lse


def flash_attention_qkv_plain(qkv, num_heads: int, scale: float):
    """qkv (B, N, 3C) in [q | k | v] x (H, Dh)-major columns -> (B, N, C)."""
    return _attention_plain(qkv, num_heads, scale)[0]


def flash_attention_qkv_fwd_lse_plain(qkv, num_heads: int, scale: float):
    """The training forward: (out (B, N, C), lse (B, H, N) fp32 base 2,
    log2 of the sum of the rounded probabilities of the max-free form)."""
    return _attention_plain(qkv, num_heads, scale)


def attention_delta(out, dout, num_heads: int):
    """delta = rowsum(dout * out) per head, (B, N, C) x2 -> (B, H, N) in
    the accumulation dtype, contiguous."""
    B, N, C = out.shape
    acc = _acc(out.dtype)
    d = (dout.to(acc) * out.to(acc)).view(B, N, num_heads, -1).sum(-1)
    return d.permute(0, 2, 1).contiguous()


def flash_attention_qkv_bwd_plain(qkv, out, lse, dout, num_heads: int,
                                  scale: float):
    """-> dqkv (B, N, 3C) in [dq | dk | dv] columns, in qkv's dtype.

    s = bf16(q * scale * log2 e) . k; p = exp2(s - lse) in fp32;
    dv = dout^T bf16(p); dp = dout v^T; ds = p (dp - delta);
    dk = q^T bf16(ds) * scale; dq = bf16(ds) k * scale (q unscaled).
    """
    B, N, C3 = qkv.shape
    dt, acc = qkv.dtype, _acc(qkv.dtype)
    q, k, v = (t.to(acc) for t in _split_heads(qkv, num_heads))
    do = dout.view(B, N, num_heads, -1).permute(0, 2, 1, 3).to(acc)
    delta = attention_delta(out, dout, num_heads)[..., None]
    qs = (q * (scale * LOG2E)).to(dt).to(acc)
    s = torch.matmul(qs, k.transpose(-1, -2))
    p = torch.exp2(s - lse.to(acc)[..., None])
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).to(acc)
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dq = torch.matmul(ds, k) * scale
    grads = torch.stack([dq, dk, dv]).to(dt)               # (3, B, H, N, Dh)
    return grads.permute(1, 3, 0, 2, 4).reshape(B, N, C3)


def _check_packed(name: str, qkv, num_heads: int, scale: float):
    """Validate a CUDA packed qkv -> (B, N, C, Dh)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is "
                         f"not (B, N, 3 * {num_heads} * Dh)")
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if not scale > 0:
        raise ValueError(f"{name}: scale {scale} must be > 0")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    return B, N, C, D


def _qkv_pointers(qkv, C: int):
    base, esz = qkv.data_ptr(), qkv.element_size()
    return base, base + C * esz, base + 2 * C * esz


def flash_attention_qkv(qkv, num_heads: int, scale: float):
    """Non-causal attention straight off the packed qkv projection.

    qkv: (B, N, 3C) bf16 or fp32, contiguous, [q | k | v] columns each
    (H, Dh)-major; Dh a multiple of 8 and at most 128 -> (B, N, C) in
    qkv's dtype.  In grad mode, on a qkv that requires grad, this is the
    training attention (``FlashAttentionQKV``); otherwise the inference
    kernel.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionQKV.apply(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_plain(qkv, num_heads, scale)
    B, N, C, D = _check_packed("flash_attention_qkv", qkv, num_heads, scale)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    lib = kbuild.load()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    code = lib.stt_attention_fwd(
        *_qkv_pointers(qkv, C), out.data_ptr(),
        B, N, num_heads, D, N * 3 * C, 3 * C, N * C, C,
        float(scale * LOG2E), kbuild.dtype_code(qkv.dtype), stream)
    kbuild.check(code, "attention")
    global LAUNCHES
    LAUNCHES += 1
    return out


def flash_attention_qkv_fwd_lse(qkv, num_heads: int, scale: float):
    """The training forward (kernel C1): qkv as ``flash_attention_qkv`` ->
    (out (B, N, C) in qkv's dtype, lse (B, H, N) fp32 base 2)."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_fwd_lse_plain(qkv, num_heads, scale)
    B, N, C, D = _check_packed("flash_attention_qkv_fwd_lse", qkv,
                               num_heads, scale)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32,
                      device=qkv.device)
    if B == 0 or N == 0:
        return out, lse
    lib = kbuild.load()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    code = lib.stt_attention_fwd_lse(
        *_qkv_pointers(qkv, C), out.data_ptr(), lse.data_ptr(),
        B, N, num_heads, D, N * 3 * C, 3 * C, N * C, C,
        float(scale * LOG2E), kbuild.dtype_code(qkv.dtype), stream)
    kbuild.check(code, "attention_fwd_lse")
    global FWD_LSE_LAUNCHES
    FWD_LSE_LAUNCHES += 1
    return out, lse


def flash_attention_qkv_bwd(qkv, out, lse, dout, num_heads: int,
                            scale: float):
    """The training backward (kernel C2): qkv (B, N, 3C), the forward's out
    (B, N, C) and lse (B, H, N) fp32, and dout (B, N, C) -> dqkv (B, N, 3C)
    in [dq | dk | dv] column order, in qkv's dtype."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_plain(qkv, out, lse, dout, num_heads,
                                             scale)
    B, N, C, D = _check_packed("flash_attention_qkv_bwd", qkv, num_heads,
                               scale)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (B, N, C) or t.dtype != qkv.dtype \
                or t.device != qkv.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_qkv_bwd: {name} must be a "
                             f"contiguous, 16-byte aligned {qkv.dtype} "
                             f"({B}, {N}, {C}) on qkv's device")
    if lse.shape != (B, num_heads, N) or lse.dtype != torch.float32 \
            or lse.device != qkv.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_qkv_bwd: lse must be contiguous "
                         f"fp32 ({B}, {num_heads}, {N}) on qkv's device")
    dqkv = torch.empty_like(qkv)
    if B == 0 or N == 0:
        return dqkv
    delta = attention_delta(out, dout, num_heads)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    code = lib.stt_attention_bwd(
        *_qkv_pointers(qkv, C), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *_qkv_pointers(dqkv, C),
        B, N, num_heads, D, N * 3 * C, 3 * C, N * C, C, N * 3 * C, 3 * C,
        float(scale * LOG2E), float(scale), kbuild.dtype_code(qkv.dtype),
        stream)
    kbuild.check(code, "attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dqkv


class FlashAttentionQKV(torch.autograd.Function):
    """Training attention on the packed qkv: forward C1, backward C2.
    Saves (qkv, out, lse), as the JAX package's packed forward does."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        out, lse = flash_attention_qkv_fwd_lse(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return (flash_attention_qkv_bwd(qkv, out, lse, dout.contiguous(),
                                        ctx.num_heads, ctx.scale),
                None, None)


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
