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

Separate operands (InternVideo2, whose q and k are RMS-normalised between
the qkv projection and attention): ``flash_attention`` is the port of
flash_attention -> _flash_primal_packed_impl (TPU kernels
_fwd_kernel_nomax_packed on separate q/k/v, and the key-grid
_fwd_kernel_nomax_packed_kv that _kv_grid_call runs at N = 2049), and
``flash_attention_i8d`` the port of flash_attention_i8d with ``out_amax``
(TPU kernels _fwd_kernel_nomax_packed_kv_q8io and
_fwd_kernel_nomax_packed_q8io on separate operands).  They run the same
CUDA kernels as the packed wrappers, given a (batch, row) stride pair per
operand, so v is read in place as the column block of the qkv output.  The
key grid is a TPU VMEM plan: its max-free partial sums add up to the same
result.  ``n_valid`` masks keys at or beyond it, as the TPU kernels'
``mask_keys`` does.  Where the channel axis is no multiple of 128 the JAX
package takes _flash_primal_impl's _fwd_kernel_nomax on a (B*H, N, Dh)
relayout instead; ``flash_attention`` computes the same function at every
geometry, so it stands for that kernel too.

Training (port of the packed custom VJP, _flash_core_packed_qkv with
_packed_train_ok): ``flash_attention_qkv`` on a qkv that requires grad, in
grad mode, goes through ``FlashAttentionQKV``, whose forward is
``flash_attention_qkv_fwd_lse`` (kernel C1, TPU kernel
_fwd_kernel_nomax_packed_lse: A1 that also returns lse = log2 of the
denominator, (B, H, N) fp32) and whose backward is
``flash_attention_qkv_bwd`` (kernel C2, TPU kernel
_bwd_merged_kernel_packed: dq, dk, dv from qkv, out, lse, dout and
delta = rowsum(dout * out), written as one (B, N, 3C) gradient in
[dq | dk | dv] column order; csrc/attention_train.cu).  It saves
(qkv, out, lse), as the JAX forward does.

Training on separate operands (InternVideo2; port of the custom VJPs
_flash_core_packed and _flash_core under grad): ``flash_attention`` on
operands that require grad, in grad mode, goes through ``FlashAttention``,
whose forward is ``flash_attention_fwd_lse`` (kernel C3-fwd, TPU kernel
_fwd_kernel launched by _flash_fwd_impl: C1's kernel given a stride pair
per operand) and whose backward is ``flash_attention_bwd`` (kernel
C3-bwd, TPU kernels _bwd_merged_kernel_dt and its other orientations,
launched by _flash_bwd_impl: C2's kernels given a stride pair per
operand, dq, dk and dv as three (B, N, C) tensors).  It saves
(q, k, v, out, lse), v as the strided view it was given.  The TPU kernels
run on a (B*H, N, Dh) relayout padded to a row multiple; the port reads
the (B, N, C) operands in place and masks the ragged tail by index.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the bf16/fp32
inference kernel on the packed qkv, ``SEP_LAUNCHES`` on separate operands,
``I8_LAUNCHES`` those of the int8 one on the packed qkv and
``I8_SEP_LAUNCHES`` on separate operands, ``FWD_LSE_LAUNCHES`` and
``SEP_FWD_LSE_LAUNCHES`` those of the training forward (packed, separate)
and ``BWD_LAUNCHES`` and ``SEP_BWD_LAUNCHES`` calls of the training
backward (each call launches two kernels: dk/dv, then dq).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simple_tad_tpu_torch.kernels import build as kbuild
from simple_tad_tpu_torch.ops.ln import quantize_static

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
LAUNCHES = 0
SEP_LAUNCHES = 0
I8_LAUNCHES = 0
I8_SEP_LAUNCHES = 0
FWD_LSE_LAUNCHES = 0
BWD_LAUNCHES = 0
SEP_FWD_LSE_LAUNCHES = 0
SEP_BWD_LAUNCHES = 0


def _split_heads(qkv, num_heads: int):
    B, N, C3 = qkv.shape
    C = C3 // 3
    return qkv.view(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)


def _heads(t, num_heads: int):
    """(B, N, C), possibly a strided column block -> (B, H, N, Dh) view."""
    B, N, C = t.shape
    return t.view(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(o):
    """(B, H, N, Dh) -> (B, N, C)."""
    B, H, N, D = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, N, H * D)


def _acc(dtype):
    """Accumulation dtype of the plain versions: fp32, or fp64 for fp64
    inputs (gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _attend_plain(q, k, v, scale: float):
    """q, k, v (B, H, N, Dh) -> (out (B, H, N, Dh) in q's dtype, lse
    (B, H, N) base 2)."""
    dt, acc = q.dtype, _acc(q.dtype)
    qs = (q.to(acc) * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(v.dtype)
    denom = p.to(acc).sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(acc), v.to(acc)) / denom
    lse = (m + torch.log2(denom))[..., 0]
    return o.to(dt), lse


def _attention_plain(qkv, num_heads: int, scale: float):
    """-> (out (B, N, C) in qkv's dtype, lse (B, H, N) base 2)."""
    o, lse = _attend_plain(*_split_heads(qkv, num_heads), scale)
    return _merge_heads(o), lse


def flash_attention_qkv_plain(qkv, num_heads: int, scale: float):
    """qkv (B, N, 3C) in [q | k | v] x (H, Dh)-major columns -> (B, N, C)."""
    return _attention_plain(qkv, num_heads, scale)[0]


def flash_attention_plain(q, k, v, num_heads: int, scale: float):
    """Separate (B, N, C) q, k, v, (H, Dh)-major columns -> (B, N, C)."""
    heads = (_heads(t, num_heads) for t in (q, k, v))
    return _merge_heads(_attend_plain(*heads, scale)[0])


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


def _attend_bwd_plain(q, k, v, out, lse, dout, num_heads: int,
                      scale: float):
    """q, k, v (B, H, N, Dh) and out, dout (B, N, C) in the input dtype,
    lse (B, H, N) -> dq, dk, dv (B, H, N, Dh) in the accumulation dtype.

    s = bf16(q * scale * log2 e) . k; p = exp2(s - lse) in fp32;
    dv = dout^T bf16(p); dp = dout v^T; ds = p (dp - delta);
    dk = q^T bf16(ds) * scale; dq = bf16(ds) k * scale (q unscaled):
    the arithmetic of the TPU kernel _bwd_merged_kernel_dt (and of its
    packed twin _bwd_merged_kernel_packed).
    """
    dt, acc = q.dtype, _acc(q.dtype)
    q, k, v = q.to(acc), k.to(acc), v.to(acc)
    do = _heads(dout, num_heads).to(acc)
    delta = attention_delta(out, dout, num_heads)[..., None]
    qs = (q * (scale * LOG2E)).to(dt).to(acc)
    s = torch.matmul(qs, k.transpose(-1, -2))
    p = torch.exp2(s - lse.to(acc)[..., None])
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).to(acc)
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dq = torch.matmul(ds, k) * scale
    return dq, dk, dv


def flash_attention_qkv_bwd_plain(qkv, out, lse, dout, num_heads: int,
                                  scale: float):
    """-> dqkv (B, N, 3C) in [dq | dk | dv] columns, in qkv's dtype (see
    ``_attend_bwd_plain``)."""
    B, N, C3 = qkv.shape
    grads = torch.stack(_attend_bwd_plain(*_split_heads(qkv, num_heads), out,
                                          lse, dout, num_heads, scale))
    grads = grads.to(qkv.dtype)                            # (3, B, H, N, Dh)
    return grads.permute(1, 3, 0, 2, 4).reshape(B, N, C3)


def flash_attention_fwd_lse_plain(q, k, v, num_heads: int, scale: float):
    """The training forward on separate (B, N, C) operands -> (out (B, N, C)
    in q's dtype, lse (B, H, N) fp32 base 2).

    The same arithmetic as ``flash_attention_qkv_fwd_lse_plain``, and so
    not quite the TPU kernel's (_fwd_kernel, reached by _flash_fwd_impl):
    that kernel subtracts the true row maximum m, this one the row maximum
    rounded up to an integer.  Both are overflow-safe and the shift cancels
    in exact arithmetic, but each bf16-rounded probability is rounded from
    another value (2^(s - ceil m) and 2^(s - m) differ by a factor that is
    not a power of two), so out and lse agree with the TPU kernel's to
    about one bf16 rounding of p, not bit for bit: in the CPU test
    (tests/test_torch_iv2_train_attention.py, N = 9 and 37) bf16 out
    differs by up to one bf16 ulp (7.8e-3 at |out| < 2) and lse by up to
    2.9e-3, within the analytic log2(1 + 2^-8) = 5.6e-3; in fp32 the two
    are the same function (out 1.3e-6, lse 9.5e-7).  The TPU kernel's
    denominator sums the bf16-rounded p where Dh is not a multiple of 128
    (on the matrix unit, through a ones column beside v: IV2-S/B/L's Dh 64)
    and the unrounded fp32 p where it is (IV2-1B's 88, padded to 128); the
    port always sums the rounded p, the weights its PV product uses, as its
    kernels C1 and C3-fwd do.
    """
    heads = (_heads(t, num_heads) for t in (q, k, v))
    o, lse = _attend_plain(*heads, scale)
    return _merge_heads(o), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, num_heads: int,
                              scale: float):
    """The training backward on separate (B, N, C) operands -> (dq, dk, dv),
    each (B, N, C) in q's dtype (see ``_attend_bwd_plain``)."""
    heads = [_heads(t, num_heads) for t in (q, k, v)]
    return tuple(_merge_heads(g).to(q.dtype) for g in _attend_bwd_plain(
        *heads, out, lse, dout, num_heads, scale))


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
    if N * C3 >= 2 ** 31:
        raise ValueError(f"{name}: N * 3C must be below 2^31 (the kernels' "
                         f"row offsets are 32-bit)")
    return B, N, C, D


def _qkv_pointers(qkv, C: int):
    base, esz = qkv.data_ptr(), qkv.element_size()
    return base, base + C * esz, base + 2 * C * esz


def _check_sep(name: str, operands, num_heads: int, scale: float, dtypes):
    """Validate separate CUDA (B, N, C) operands, each of which may be a
    strided view with unit column stride -> (B, N, C, Dh)."""
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not "
                         f"(B, N, {num_heads} * Dh)")
    if q.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {q.dtype} is not one of {dtypes}")
    if not scale > 0:
        raise ValueError(f"{name}: scale {scale} must be > 0")
    for t in operands:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k and v must share shape, dtype "
                             f"and device")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: every operand needs unit column "
                             f"stride")
    B, N, C = q.shape
    return B, N, C, C // num_heads


def _check_sep_float(name: str, operands, num_heads: int, scale: float):
    """``_check_sep`` for the bf16/fp32 kernels (A1, C3), with their head
    dims and alignment -> (B, N, C, Dh)."""
    B, N, C, D = _check_sep(name, operands, num_heads, scale,
                            (torch.bfloat16, torch.float32))
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 and "
                         f"at most {MAX_HEAD_DIM}")
    _check_aligned(name, operands)
    return B, N, C, D


def _check_bwd_inputs(name: str, ref, out, lse, dout, shape,
                      num_heads: int):
    """out and dout contiguous, 16-byte aligned ``shape`` (B, N, C) in ref's
    dtype, lse contiguous fp32 (B, H, N), all on ref's device."""
    B, N, C = shape
    for what, t in (("out", out), ("dout", dout)):
        if t.shape != (B, N, C) or t.dtype != ref.dtype \
                or t.device != ref.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be a contiguous, 16-byte "
                             f"aligned {ref.dtype} ({B}, {N}, {C}) on the "
                             f"inputs' device")
    if lse.shape != (B, num_heads, N) or lse.dtype != torch.float32 \
            or lse.device != ref.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous fp32 "
                         f"({B}, {num_heads}, {N}) on the inputs' device")


def _check_aligned(name: str, operands):
    """The bf16 and int8 kernels read 16 bytes at a time: every base
    pointer, and every stride in bytes, must be a multiple of 16 (fp32
    operands are read one value at a time)."""
    for t in operands:
        esz = t.element_size()
        vec = 16 if esz < 4 else esz
        if t.data_ptr() % vec or any(s * esz % vec or s >= 2 ** 31
                                     for s in t.stride()[:2]):
            raise ValueError(f"{name}: every operand needs a {vec}-byte "
                             f"aligned base and row and batch strides")
        if t.shape[1] * t.stride(1) >= 2 ** 31:
            raise ValueError(f"{name}: N * row stride must be below 2^31 "
                             f"(the kernels' row offsets are 32-bit)")


def _strides(t):
    """The (batch, row) stride pair of a (B, N, C) operand, in elements."""
    return t.stride(0), t.stride(1)


def _qkv_views(qkv, C: int):
    """The q, k and v column blocks of a (B, N, 3C) tensor, as views."""
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]


def _launch_attention(q, k, v, num_heads: int, scale: float):
    """Kernel A1 on three non-empty (B, N, C) operands, each read through
    its own (batch, row) strides -> (B, N, C) contiguous."""
    B, N, C = q.shape
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, N, num_heads, C // num_heads, *_strides(q), *_strides(k),
        *_strides(v), N * C, C, float(scale * LOG2E),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention")
    return out


def _launch_attention_i8(q, k, v, amax, out_amax, num_heads: int,
                         scale: float, n_kv: int):
    """The int8-storage kernel on three non-empty int8 (B, N, C) operands,
    keys at or beyond ``n_kv`` masked -> int8 (B, N, C) contiguous."""
    B, N, C = q.shape
    out = torch.empty((B, N, C), dtype=torch.int8, device=q.device)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_i8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), amax.data_ptr(),
        out_amax.data_ptr(), out.data_ptr(), B, N, n_kv, num_heads,
        C // num_heads, *_strides(q), *_strides(k), *_strides(v), N * C, C,
        float(scale), stream)
    kbuild.check(code, "attention_i8")
    return out


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
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    out = _launch_attention(*_qkv_views(qkv, C), num_heads, scale)
    global LAUNCHES
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, num_heads: int, scale: float):
    """Non-causal attention on separate operands (kernel A1).

    q, k, v: (B, N, C) bf16 or fp32 with (H, Dh)-major columns, each
    contiguous or a strided view with unit column stride (v may be the
    column block of the qkv projection output); Dh a multiple of 8 and at
    most 128 -> (B, N, C) contiguous, in q's dtype.  In grad mode, on
    operands of which one requires grad, this is the training attention
    (``FlashAttention``: kernels C3); otherwise the inference kernel.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, num_heads, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, scale)
    B, N, C, D = _check_sep_float("flash_attention", (q, k, v), num_heads,
                                  scale)
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    out = _launch_attention(q, k, v, num_heads, scale)
    global SEP_LAUNCHES
    SEP_LAUNCHES += 1
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
    _check_bwd_inputs("flash_attention_qkv_bwd", qkv, out, lse, dout,
                      (B, N, C), num_heads)
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


def flash_attention_fwd_lse(q, k, v, num_heads: int, scale: float):
    """The training forward on separate operands (kernel C3-fwd): q, k, v
    as ``flash_attention`` -> (out (B, N, C) contiguous in q's dtype, lse
    (B, H, N) fp32 base 2)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, num_heads, scale)
    B, N, C, D = _check_sep_float("flash_attention_fwd_lse", (q, k, v),
                                  num_heads, scale)
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32,
                      device=q.device)
    if B == 0 or N == 0:
        return out, lse
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_fwd_lse_sep(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, N, num_heads, D, *_strides(q), *_strides(k),
        *_strides(v), N * C, C, float(scale * LOG2E),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention_fwd_lse_sep")
    global SEP_FWD_LSE_LAUNCHES
    SEP_FWD_LSE_LAUNCHES += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads: int,
                        scale: float):
    """The training backward on separate operands (kernel C3-bwd): q, k, v
    as ``flash_attention``, the forward's out (B, N, C) and lse (B, H, N)
    fp32, and dout (B, N, C) -> (dq, dk, dv), each (B, N, C) contiguous in
    q's dtype.  delta = rowsum(dout * out) is computed here, as
    ``attention_delta`` does for the packed backward."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, num_heads,
                                         scale)
    B, N, C, D = _check_sep_float("flash_attention_bwd", (q, k, v),
                                  num_heads, scale)
    _check_bwd_inputs("flash_attention_bwd", q, out, lse, dout, (B, N, C),
                      num_heads)
    dq, dk, dv = torch.empty((3, B, N, C), dtype=q.dtype,
                             device=q.device).unbind(0)
    if B == 0 or N == 0:
        return dq, dk, dv
    delta = attention_delta(out, dout, num_heads)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_bwd_sep(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, num_heads, D, *_strides(q), *_strides(k),
        *_strides(v), N * C, C, N * C, C, float(scale * LOG2E), float(scale),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention_bwd_sep")
    global SEP_BWD_LAUNCHES
    SEP_BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Training attention on separate operands: forward C3-fwd, backward
    C3-bwd.  Saves (q, k, v, out, lse), as the JAX package's _flash_core
    forward does; v stays the view it was given (InternVideo2: the column
    block of the qkv output), not a copy."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        out, lse = flash_attention_fwd_lse(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     ctx.num_heads, ctx.scale), None, None)


def _attend_i8_plain(q, k, v, amax, scale: float):
    """int8 q, k, v (B, H, N, Dh) -> (B, H, N, Dh) fp32; see
    ``attention_i8_plain_f32``."""
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * LOG2E)
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(torch.bfloat16).float()
    vf = (v.float() * sv).to(torch.bfloat16).float()
    return torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True)


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
    return _merge_heads(_attend_i8_plain(*_split_heads(qkv_i8, num_heads),
                                         amax, scale))


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
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=torch.int8, device=qkv_i8.device)
    out = _launch_attention_i8(*_qkv_views(qkv_i8, C), amax, out_amax,
                               num_heads, scale, N)
    global I8_LAUNCHES
    I8_LAUNCHES += 1
    return out


def attention_i8d_plain_f32(q_i8, k_i8, v_i8, amax, num_heads: int,
                            scale: float, n_valid=None):
    """``attention_i8_plain_f32`` on separate int8 (B, N, C) operands, keys
    at or beyond ``n_valid`` left out -> (B, N, C) fp32."""
    q, k, v = (_heads(t, num_heads) for t in (q_i8, k_i8, v_i8))
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    return _merge_heads(_attend_i8_plain(q, k, v, amax, scale))


def flash_attention_i8d_plain(q_i8, k_i8, v_i8, amax, num_heads: int,
                              scale: float, out_amax, n_valid=None):
    """The separate-operand int8 attention with its int8 epilogue."""
    return quantize_static(attention_i8d_plain_f32(
        q_i8, k_i8, v_i8, amax, num_heads, scale, n_valid), out_amax)


def _pad_heads(t, num_heads: int, dp: int):
    """Zero-pad each head of a (B, N, H * Dh) int8 tensor to dp columns
    (zero codes add nothing to QK or PV, so the result is exact)."""
    B, N, C = t.shape
    x = t.reshape(B, N, num_heads, C // num_heads)
    return F.pad(x, (0, dp - x.shape[-1])).reshape(B, N, num_heads * dp)


def flash_attention_i8d(q_i8, k_i8, v_i8, amax, num_heads: int,
                        scale: float, out_amax, n_valid=None):
    """Non-causal attention on separate int8-stored operands -> int8
    (B, N, C) (kernel D2: B2's kernel with a stride pair per operand).

    q_i8, k_i8, v_i8: (B, N, C) int8 per-head codes against amax (3, H)
    fp32, each contiguous or a strided view with unit column stride; Dh a
    multiple of 8 up to 128 (a multiple of 16 goes straight in, any other is
    zero-padded to the next multiple of 16: IV2-1B's 88 runs as 96);
    out_amax: one fp32 value, the absmax the output codes are made against;
    n_valid: keys at or beyond it are masked (all N query rows are
    computed).  Both scales stay on the device.
    """
    if q_i8.device.type == "cpu":
        return flash_attention_i8d_plain(q_i8, k_i8, v_i8, amax, num_heads,
                                         scale, out_amax, n_valid)
    B, N, C, D = _check_sep("flash_attention_i8d", (q_i8, k_i8, v_i8),
                            num_heads, scale, (torch.int8,))
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_i8d: head dim {D} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    n_kv = N if n_valid is None else int(n_valid)
    if N and not 0 < n_kv <= N:
        raise ValueError(f"flash_attention_i8d: n_valid {n_valid} outside "
                         f"1..{N}")
    for name, t, numel in (("amax", amax, 3 * num_heads),
                           ("out_amax", out_amax, 1)):
        if t.numel() != numel or t.dtype != torch.float32 \
                or t.device != q_i8.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_i8d: {name} must be {numel} "
                             f"contiguous fp32 values on q's device")
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=torch.int8, device=q_i8.device)
    dp = -(-D // 16) * 16
    if dp != D:
        q_i8, k_i8, v_i8 = (_pad_heads(t, num_heads, dp)
                            for t in (q_i8, k_i8, v_i8))
    _check_aligned("flash_attention_i8d", (q_i8, k_i8, v_i8))
    out = _launch_attention_i8(q_i8, k_i8, v_i8, amax, out_amax, num_heads,
                               scale, n_kv)
    global I8_SEP_LAUNCHES
    I8_SEP_LAUNCHES += 1
    if dp != D:
        out = out.view(B, N, num_heads, dp)[..., :D].reshape(B, N, C)
    return out
