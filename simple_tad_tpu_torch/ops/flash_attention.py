"""Packed-qkv inference attention: the CUDA kernel and its plain version.

Port of simple_tad_tpu/ops/flash_attention.py:flash_attention_qkv, whose
TPU kernel is _fwd_kernel_nomax_packed with _attend_rows_t.  The kernel is
csrc/attention.cu: it reads q, k and v in place from the (B, N, 3C) qkv
projection output (no slice copies, no head relayout) and runs both
products on the tensor cores (attention at N=1568, Dh=64 is compute-bound
once tiled; see the note at the top of the source).  ``attention_fwd_route``
names the kernel a forward call takes: bf16 at head dims 64 to 128 (every
trunk the jobs run: 64, IV2-1B's 88, IV2-6B's 128; ViT-H's 80), with or
without dropout, the wgmma kernel (TMA ring, wgmma products, tiles 64, 96
or 128 columns wide), bf16 at head dims 8 to 56 the mma.sync kernel, fp32
the CUDA-core kernel.

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
package and is not ported.  ``attention_i8_route`` names the kernel a
call takes (B2 here, D2 below): at head dims 64 to 128 (every int8 trunk
the jobs run at 64; IV2-1B's 88, IV2-6B's 128, ViT-H's 80) the wgmma
kernel, whose V a pre-pass dequantizes into a bf16 scratch the wrapper
allocates, read in place in tiles 64 or 128 columns wide; at the head dims
below 64, padded to 16, 32 or 48, the mma.sync kernel.

int8-compute attention (kernel E2, csrc/attention_int8.cu; port of
flash_attention_qkv_int8, TPU kernel _fwd_kernel_int8_packed): the static
int8 ViT's ``int8_attn`` option.  Both products run in int8 on the packed
int8 qkv: a max-subtracted softmax whose probabilities become codes
round(exp2(s - m) * 127), an int8 PV, the fp32 row sum of the codes as the
denominator and a bf16 output (``flash_attention_qkv_int8``).
``attention_int8_route`` names its kernel: at head dim 64 the wgmma kernel,
whose V^T a pre-pass writes into an int8 scratch the wrapper allocates; at
16, 32 and 48 the mma.sync kernel.

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
(qkv, out, lse), as the JAX forward does.  ``attention_bwd_route`` names
the kernels a backward call takes: at head dims 64 to 128 (every trunk
the fine-tuning jobs run, ViT-H, IV2-1B and IV2-6B) bf16 takes the wgmma
kernels (TMA ring, wgmma products, no transposed staging; tiles 64, 96 or
128 columns wide), at head dims 8 to 56 the mma.sync kernels; fp32 the
CUDA-core kernels.  delta comes from
``flash_attention_delta``, a pre-pass kernel on the card whose plain
version is ``attention_delta``.

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

Static int8 attention in bf16 with an int8 output (kernel B3; port of
flash_attention_qkv / flash_attention with ``out_quant_amax``, TPU kernels
_fwd_kernel_nomax_packed_q8 and, at N = 2049, the key-grid
_fwd_kernel_nomax_packed_kv_q8): ``flash_attention_qkv_q8`` on the packed
qkv and ``flash_attention_q8`` on separate operands are A1 on bf16/fp32
q, k, v whose normalised fp32 result is written as int8 codes against
``out_amax`` (the proj GEMM's input).  The static int8 models take it
where the int8-storage kernel is opted out of or cannot serve the geometry
(ops/attention.py).

Attention dropout in training (kernels C4; port of the JAX package's
_flash_core_drop and _flash_core_drop_rng, reached from its
flash_attention with ``dropout_mask`` or ``dropout_seed``):
``flash_attention_drop`` goes through ``FlashAttentionDrop``, whose forward
is ``flash_attention_drop_fwd`` (C4-fwd, TPU kernels _fwd_kernel_drop and
_fwd_kernel_drop_rng: C3-fwd that also applies the keep factor) and whose
backward is ``flash_attention_drop_bwd`` (C4-bwd, TPU kernels
_bwd_dq_kernel_drop + _bwd_dkv_kernel_drop and _bwd_merged_kernel_drop_rng
with its split forms: C3-bwd with the keep factor).  The keep source is
exactly one of ``mask`` (int8 (B, H, N, N), 1 = keep, as the JAX
package's make_dropout_mask draws it) and ``seed`` (2 int32 words on the
device, from which the kernels draw Philox4x32-10 bits themselves:
csrc/philox.cuh, copied exactly by ``philox4x32_plain`` and
``dropout_keep_plain``).  Softmax, then dropout, then PV: the denominator
is summed over the unrounded fp32 probabilities before dropout, and the PV
operand is p * keep / (1 - rate) rounded once to the v dtype.  The TPU's
hardware PRNG bits cannot be reproduced, so the seed form is held to the
JAX mask kernels fed ``dropout_keep_plain``'s mask.  q, k and v are
(B, N, C) views with a stride pair each, as C3 takes them (the ViT's packed
qkv is read in place).  It saves (q, k, v, mask or seed, out, lse), as
_flash_core_drop_fwd and _flash_core_drop_rng_fwd do.  Both directions take
the routes of the calls without dropout (``attention_fwd_route``,
``attention_bwd_route``): at head dim 64 in bf16 the wgmma kernels, which
stage the mask form's tiles in shared memory.

Gradient checkpointing (port of the FLASH_RESIDUAL_NAME policy,
models/layers.py:remat_policy there): the kernels are bound through
ctypes, so a checkpoint policy of torch's, which sees dispatcher ops, can
not keep their outputs.  ``AttentionResiduals`` does it instead: inside
``residuals.saving()`` each training Function above keeps its forward's
(out, lse) on the tape; inside ``residuals.reusing()`` (the recompute) it
takes them back in order and launches no forward kernel, and its backward
consumes the saved pair.  models/layers.py:checkpoint_block opens both.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches of the bf16/fp32
inference kernel on the packed qkv, ``SEP_LAUNCHES`` on separate operands,
``Q8_LAUNCHES`` and ``Q8_SEP_LAUNCHES`` those of B3 (packed, separate),
``I8_LAUNCHES`` those of the int8 one on the packed qkv and
``I8_SEP_LAUNCHES`` on separate operands, and ``I8_WGMMA_LAUNCHES`` /
``I8_MMA_LAUNCHES`` the route of every such call (``attention_i8_route``;
one call is the pre-pass and the kernel on the wgmma route),
``INT8_LAUNCHES`` those of the int8-compute one (E2) and
``INT8_WGMMA_LAUNCHES`` / ``INT8_MMA_LAUNCHES`` their routes
(``attention_int8_route``), ``FWD_LSE_LAUNCHES`` and
``SEP_FWD_LSE_LAUNCHES`` those of the training forward (packed, separate)
and ``BWD_LAUNCHES`` and ``SEP_BWD_LAUNCHES`` calls of the training
backward (each call launches two kernels: dk/dv, then dq), which
``attention_bwd_route`` sends to one of three kernel pairs, counted per
route over both layouts and the dropout backward (C4-bwd):
``BWD_WGMMA_LAUNCHES`` (bf16 at head dims 64 to 128:
the wgmma kernels), ``BWD_MMA_LAUNCHES`` (bf16 at head dims 8 to 56: the
mma.sync kernels) and ``BWD_F32_LAUNCHES`` (fp32: the CUDA-core kernels);
``DELTA_LAUNCHES`` those of the delta pre-pass (one per backward call,
dropout or not); ``DROP_FWD_LAUNCHES`` and ``DROP_BWD_LAUNCHES`` those of
the dropout forward and backward with a mask, ``DROP_RNG_FWD_LAUNCHES``
and ``DROP_RNG_BWD_LAUNCHES`` with a seed.  Every launch of the bf16/fp32
forward (A1 packed and separate, C1, C3-fwd, B3 packed and separate,
C4-fwd) is also counted on the route ``attention_fwd_route`` names:
``FWD_WGMMA_LAUNCHES``, ``FWD_MMA_LAUNCHES`` or ``FWD_F32_LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from simple_tad_tpu_torch.kernels import build as kbuild
from simple_tad_tpu_torch.ops.ln import quantize_static


class AttentionResiduals:
    """The (out, lse) pairs of the training attention forwards of one
    checkpointed region.  ``saving()``: each forward launched inside
    appends its pair; ``reusing()``: each forward inside takes the next
    pair instead of launching (the recompute of the same region)."""

    def __init__(self):
        self.pairs = []
        self.next = 0

    @contextlib.contextmanager
    def saving(self):
        with _active(self, "save"):
            yield

    @contextlib.contextmanager
    def reusing(self):
        self.next = 0
        with _active(self, "reuse"):
            yield

    def forward(self, launch):
        """``launch()`` -> (out, lse), kept; or the kept pair."""
        mode = _TAPE.mode
        if mode == "reuse":
            if self.next >= len(self.pairs):
                raise RuntimeError("the recompute ran more attention "
                                   "forwards than its forward pass")
            out, lse = self.pairs[self.next]
            # the recompute consumes each pair once: drop the tape's hold
            self.pairs[self.next] = None
            self.next += 1
            return out.detach(), lse
        out, lse = launch()
        if mode == "save":
            self.pairs.append((out.detach(), lse))
        return out, lse


_TAPE = threading.local()


@contextlib.contextmanager
def _active(tape, mode):
    """Make ``tape`` the current one in ``mode`` on this thread (the
    recompute runs on autograd's device thread)."""
    prev = getattr(_TAPE, "tape", None), getattr(_TAPE, "mode", None)
    _TAPE.tape, _TAPE.mode = tape, mode
    try:
        yield
    finally:
        _TAPE.tape, _TAPE.mode = prev


def _residuals(launch):
    """The forward's (out, lse): launched, or from the current tape."""
    tape = getattr(_TAPE, "tape", None)
    return launch() if tape is None else tape.forward(launch)

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
LAUNCHES = 0
SEP_LAUNCHES = 0
I8_LAUNCHES = 0
I8_SEP_LAUNCHES = 0
INT8_LAUNCHES = 0
Q8_LAUNCHES = 0
Q8_SEP_LAUNCHES = 0
FWD_LSE_LAUNCHES = 0
BWD_LAUNCHES = 0
SEP_FWD_LSE_LAUNCHES = 0
SEP_BWD_LAUNCHES = 0
BWD_WGMMA_LAUNCHES = 0
BWD_MMA_LAUNCHES = 0
BWD_F32_LAUNCHES = 0
FWD_WGMMA_LAUNCHES = 0
FWD_MMA_LAUNCHES = 0
FWD_F32_LAUNCHES = 0
DELTA_LAUNCHES = 0
DROP_FWD_LAUNCHES = 0
DROP_BWD_LAUNCHES = 0
DROP_RNG_FWD_LAUNCHES = 0
DROP_RNG_BWD_LAUNCHES = 0
# the routes the int8 attentions took: B2 and D2 together, and E2
I8_WGMMA_LAUNCHES = 0
I8_MMA_LAUNCHES = 0
INT8_WGMMA_LAUNCHES = 0
INT8_MMA_LAUNCHES = 0
INT8_MAX_HEAD_DIM = 64
# the training backward's routes, by the code csrc/attention_train.cu's
# stt_attention_bwd_route returns, and the least head dim of its wgmma
# kernels; the forward's (csrc/attention.cu's stt_attention_fwd_route) are
# the same codes; both take bf16 at head dims WGMMA_HEAD_DIM to
# MAX_HEAD_DIM to their wgmma kernels
BWD_ROUTES = ("fp32", "mma_sync", "wgmma")
FWD_ROUTES = BWD_ROUTES
WGMMA_HEAD_DIM = 64
# Philox4x32-10's multipliers and Weyl constants (csrc/philox.cuh)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


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


def _attend_plain(q, k, v, scale: float, out_dtype=None):
    """q, k, v (B, H, N, Dh) -> (out (B, H, N, Dh) in ``out_dtype``, by
    default q's, lse (B, H, N) base 2)."""
    dt, acc = q.dtype, _acc(q.dtype)
    qs = (q.to(acc) * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m).to(v.dtype)
    denom = p.to(acc).sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(acc), v.to(acc)) / denom
    lse = (m + torch.log2(denom))[..., 0]
    return o.to(out_dtype or dt), lse


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
    the accumulation dtype, contiguous (the plain version of
    ``flash_attention_delta``, and the plain backward's delta)."""
    B, N, C = out.shape
    acc = _acc(out.dtype)
    d = (dout.to(acc) * out.to(acc)).view(B, N, num_heads, -1).sum(-1)
    return d.permute(0, 2, 1).contiguous()


def flash_attention_delta(out, dout, num_heads: int):
    """The training backward's delta pre-pass (the JAX package's XLA rowsum
    in _flash_bwd_impl and _flash_bwd_packed_qkv_impl): ``attention_delta``
    on the CPU, the kernel of csrc/attention_train.cu on the card.  out and
    dout contiguous, 16-byte aligned (B, N, C) bf16 or fp32 with
    C = num_heads * Dh, Dh a multiple of 8 -> (B, H, N) fp32 contiguous."""
    if out.device.type == "cpu":
        return attention_delta(out, dout, num_heads)
    B, N, C = out.shape
    name = "flash_attention_delta"
    for t in (out, dout):
        if t.device.type != "cuda" or t.shape != out.shape \
                or t.dtype != out.dtype or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: out and dout must be contiguous, "
                             f"16-byte aligned (B, N, C) CUDA tensors of one "
                             f"dtype")
    if C % num_heads or (C // num_heads) % 8:
        raise ValueError(f"{name}: C = {C} is not {num_heads} heads of a "
                         f"multiple of 8")
    delta = torch.empty((B, num_heads, N), dtype=torch.float32,
                        device=out.device)
    if B == 0 or N == 0:
        return delta
    lib = kbuild.load()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = lib.stt_attention_delta(
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, N, num_heads,
        C // num_heads, kbuild.dtype_code(out.dtype), stream)
    kbuild.check(code, "attention_delta")
    global DELTA_LAUNCHES
    DELTA_LAUNCHES += 1
    return delta


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
    keys at or beyond ``n_kv`` masked -> int8 (B, N, C) contiguous.  On the
    wgmma route V is dequantized to bf16 by a pre-pass into a (B, N, C)
    scratch."""
    B, N, C = q.shape
    D = C // num_heads
    route = attention_i8_route(D)
    out = torch.empty((B, N, C), dtype=torch.int8, device=q.device)
    vbf = (torch.empty((B, N, C), dtype=torch.bfloat16, device=q.device)
           if route == "wgmma" else None)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_i8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), amax.data_ptr(),
        out_amax.data_ptr(), out.data_ptr(),
        None if vbf is None else vbf.data_ptr(), B, N, n_kv, num_heads, D,
        *_strides(q), *_strides(k), *_strides(v), N * C, C, float(scale),
        stream)
    kbuild.check(code, "attention_i8")
    globals()[_I8_COUNTERS[route]] += 1
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
    _count_fwd_route(qkv.dtype, D)
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
    _count_fwd_route(q.dtype, D)
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
    _count_fwd_route(qkv.dtype, D)
    return out, lse


def _route(name: str, dtype, head_dim: int, wgmma_dims) -> str:
    """route() of csrc/attention.cu and csrc/attention_train.cu: bf16 at
    the head dims ``wgmma_dims`` takes the wgmma kernels."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {dtype} is not bfloat16 or float32")
    if head_dim <= 0 or head_dim % 8 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {head_dim} must be a positive "
                         f"multiple of 8, at most {MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if head_dim in wgmma_dims else "mma_sync"


def attention_bwd_route(dtype, head_dim: int) -> str:
    """The kernels a CUDA call of the training backward (C2, C3-bwd, and
    C4-bwd in either keep form) of ``dtype`` at ``head_dim`` launches, as
    csrc/attention_train.cu's dispatch picks them: 'wgmma' (bf16 at head
    dims 64 to 128: every trunk the fine-tuning jobs run at 64, and ViT-H's
    80, IV2-1B's 88 and IV2-6B's 128; their tiles are 64, 96 or 128 columns
    wide), 'mma_sync' (bf16 at head dims 8 to 56) or 'fp32' (the CUDA-core
    kernels).  Dropout does not change the route.

    Precondition of the wgmma route at head dims other than 64: k and v
    are finite.  A tile there also reads columns of the neighbouring heads,
    which meet the zeroed columns of the scaled q in S and of dout in dP,
    so a non-finite k or v in one head makes its neighbours' gradients NaN,
    where the plain version keeps them finite."""
    return _route("attention_bwd_route", dtype, head_dim,
                  range(WGMMA_HEAD_DIM, MAX_HEAD_DIM + 1))


def attention_fwd_route(dtype, head_dim: int) -> str:
    """The kernel a CUDA call of the bf16/fp32 attention forward (A1 packed
    or on separate operands, C1, C3-fwd, B3, and C4-fwd in either keep
    form) of ``dtype`` at ``head_dim`` launches, as csrc/attention.cu's
    dispatch picks it: 'wgmma' (bf16 at head dims 64 to 128: every trunk
    the jobs run, 64 and IV2-1B's 88 and IV2-6B's 128, and ViT-H's 80; its
    tiles are 64, 96 or 128 columns wide), 'mma_sync' (bf16 at head dims 8
    to 56) or 'fp32' (the CUDA-core kernel).  Dropout does not
    change the route.

    Precondition of the wgmma route at head dims other than 64: k is
    finite.  A tile there also reads columns of the neighbouring heads,
    which meet q's zeroed columns in S, so a non-finite k in one head
    makes its neighbours' rows NaN, where the plain version keeps them
    finite (the head's own rows are NaN in both)."""
    return _route("attention_fwd_route", dtype, head_dim,
                  range(WGMMA_HEAD_DIM, MAX_HEAD_DIM + 1))


def _check_int8_head_dim(name: str, head_dim: int, max_dim: int) -> None:
    if head_dim <= 0 or head_dim % 8 or head_dim > max_dim:
        raise ValueError(f"{name}: head dim {head_dim} must be a positive "
                         f"multiple of 8, at most {max_dim}")


def attention_i8_head_dim(head_dim: int) -> int:
    """The head dim the int8-storage wrappers hand csrc/attention_i8.cu at
    ``head_dim`` (a multiple of 8 up to 128): below 64 one that is no
    multiple of 16 zero-padded to the next (``_pad_heads``: 8, 24, 40 and
    56 run as 16, 32, 48 and 64), every other as it is (72 to 128 read in
    place)."""
    _check_int8_head_dim("attention_i8_route", head_dim, MAX_HEAD_DIM)
    if head_dim < WGMMA_HEAD_DIM:
        return -(-head_dim // 16) * 16
    return head_dim


def attention_i8_route(head_dim: int) -> str:
    """The kernel a CUDA call of the int8-storage attention (B2 on the
    packed qkv, D2 on separate operands) at ``head_dim`` launches, as
    csrc/attention_i8.cu's dispatch picks it on ``attention_i8_head_dim``:
    'wgmma' at head dims 64 to 128 (every int8 trunk the jobs run at 64;
    the static int8 InternVideo2's D2 at IV2-1B's 88 and IV2-6B's 128, and
    ViT-H's 80; 56 padded to 64), in tiles 64 or 128 columns wide,
    'mma_sync' at the head dims below 56 (padded to 16, 32 or 48).

    The wgmma route has no precondition on its inputs: a tile at a head dim
    other than 64 and 128 also reads columns of the neighbouring heads (or
    zeros beyond the last), which meet q's zeroed columns in S; int8 codes
    are always finite, so they add exactly 0 (unlike the bf16 routes,
    attention_fwd_route)."""
    dim = attention_i8_head_dim(head_dim)
    return "wgmma" if dim >= WGMMA_HEAD_DIM else "mma_sync"


def attention_int8_route(head_dim: int) -> str:
    """The kernel a CUDA call of the int8-compute attention (E2) at
    ``head_dim`` launches, as csrc/attention_int8.cu's dispatch picks it on
    the head dim the wrapper gives it (a multiple of 8 zero-padded to the
    next multiple of 16): 'wgmma' where that is 64, 'mma_sync' at 16, 32
    and 48."""
    _check_int8_head_dim("attention_int8_route", head_dim,
                         INT8_MAX_HEAD_DIM)
    padded = -(-head_dim // 16) * 16
    return "wgmma" if padded == WGMMA_HEAD_DIM else "mma_sync"


_I8_COUNTERS = {"wgmma": "I8_WGMMA_LAUNCHES", "mma_sync": "I8_MMA_LAUNCHES"}
_INT8_COUNTERS = {"wgmma": "INT8_WGMMA_LAUNCHES",
                  "mma_sync": "INT8_MMA_LAUNCHES"}
_BWD_COUNTERS = {"wgmma": "BWD_WGMMA_LAUNCHES",
                 "mma_sync": "BWD_MMA_LAUNCHES", "fp32": "BWD_F32_LAUNCHES"}
_FWD_COUNTERS = {"wgmma": "FWD_WGMMA_LAUNCHES",
                 "mma_sync": "FWD_MMA_LAUNCHES", "fp32": "FWD_F32_LAUNCHES"}


def _count_bwd_route(dtype, head_dim: int) -> None:
    name = _BWD_COUNTERS[attention_bwd_route(dtype, head_dim)]
    globals()[name] += 1


def _count_fwd_route(dtype, head_dim: int) -> None:
    name = _FWD_COUNTERS[attention_fwd_route(dtype, head_dim)]
    globals()[name] += 1


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
    delta = flash_attention_delta(out, dout, num_heads)
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
    _count_bwd_route(qkv.dtype, D)
    return dqkv


class FlashAttentionQKV(torch.autograd.Function):
    """Training attention on the packed qkv: forward C1, backward C2.
    Saves (qkv, out, lse), as the JAX package's packed forward does."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        out, lse = _residuals(lambda: flash_attention_qkv_fwd_lse(
            qkv, num_heads, scale))
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
    _count_fwd_route(q.dtype, D)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads: int,
                        scale: float):
    """The training backward on separate operands (kernel C3-bwd): q, k, v
    as ``flash_attention``, the forward's out (B, N, C) and lse (B, H, N)
    fp32, and dout (B, N, C) -> (dq, dk, dv), each (B, N, C) contiguous in
    q's dtype.  delta = rowsum(dout * out) is computed here by
    ``flash_attention_delta``, as for the packed backward."""
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
    delta = flash_attention_delta(out, dout, num_heads)
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
    _count_bwd_route(q.dtype, D)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Training attention on separate operands: forward C3-fwd, backward
    C3-bwd.  Saves (q, k, v, out, lse), as the JAX package's _flash_core
    forward does; v stays the view it was given (InternVideo2: the column
    block of the qkv output), not a copy."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        out, lse = _residuals(lambda: flash_attention_fwd_lse(
            q, k, v, num_heads, scale))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     ctx.num_heads, ctx.scale), None, None)


def dropout_rng_thresh(rate: float) -> int:
    """Keep a Philox word iff it is at least this (copy of
    simple_tad_tpu/ops/flash_attention.py:_drop_rng_thresh)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of the 64-bit product of uint32 values ``a``
    (int64 tensor) and ``m``: a 32 x 32-bit product overflows int64, so
    ``a`` is split into 16-bit halves."""
    t1 = (a & 0xFFFF) * m                       # < 2^48
    t2 = (a >> 16) * m + (t1 >> 16)             # < 2^48 + 2^32
    return t2 >> 16, ((t2 & 0xFFFF) << 16) | (t1 & 0xFFFF)


def philox4x32_plain(counter, key):
    """Philox4x32-10 (csrc/philox.cuh) in PyTorch integer arithmetic.

    counter (..., 4) and key (..., 2) integer tensors of 32-bit words (an
    int32 word is read as its bits), broadcast together -> (..., 4) int64
    words in [0, 2^32)."""
    c = [t.to(torch.int64) & _U32 for t in counter.unbind(-1)]
    k0, k1 = (t.to(torch.int64) & _U32 for t in key.unbind(-1))
    for _ in range(10):
        hi0, lo0 = _mulhilo(c[0], PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + PHILOX_W[0]) & _U32
        k1 = (k1 + PHILOX_W[1]) & _U32
    return torch.stack(torch.broadcast_tensors(*c), -1)


def dropout_keep_plain(seed, B: int, H: int, N: int, rate: float,
                       head_offset=None, total_heads=None):
    """The keep mask the Philox kernels draw from ``seed`` (2 int32 words)
    -> int8 (B, H, N, N) contiguous on seed's device, 1 = keep.

    The map of csrc/philox.cuh: element (b, h, query q, key k) is word
    2 * ((q >> 3) & 1) + ((k >> 3) & 1) of Philox4x32-10 at counter
    (k & ~8, q & ~8, b * Ht + h0 + h, 0) with key (seed[0], seed[1]), kept
    iff it is at least ``dropout_rng_thresh(rate)``; h0 = ``head_offset``
    (default 0) and Ht = ``total_heads`` (default H) place the H heads
    among a model's heads (a tensor-parallel rank's share,
    parallel/tp.py)."""
    dev = seed.device
    G = -(-N // 16)                              # 16-row groups
    # the row (column) indices with bit 3 clear
    lo = (torch.arange(G, device=dev)[:, None] * 16
          + torch.arange(8, device=dev)).reshape(-1)
    thresh = dropout_rng_thresh(rate)
    out = torch.empty((B * H, 16 * G, 16 * G), dtype=torch.int8, device=dev)
    step = max(1, 2 ** 22 // lo.numel() ** 2)
    heads = H if total_heads is None else int(total_heads)
    for b0 in range(0, B * H, step):
        bh = torch.arange(b0, min(b0 + step, B * H), device=dev)
        bh = bh // H * heads + int(head_offset or 0) + bh % H
        counter = torch.stack(torch.broadcast_tensors(
            lo[None, None, :], lo[None, :, None], bh[:, None, None],
            torch.zeros((), dtype=torch.int64, device=dev)), -1)
        keep = philox4x32_plain(counter, seed.reshape(2)) >= thresh
        # (bh, q group, q low, k group, k low, q bit 3, k bit 3)
        keep = keep.view(-1, G, 8, G, 8, 2, 2).permute(0, 1, 5, 2, 3, 6, 4)
        out[b0:b0 + len(bh)] = keep.reshape(-1, 16 * G, 16 * G)
    return out[:, :N, :N].reshape(B, H, N, N).contiguous()


def _keep_mask(mask, seed, B: int, H: int, N: int, rate: float,
               head_offset=None, total_heads=None):
    """The int8 keep mask of the plain versions: ``mask`` as given, or the
    Philox bits of ``seed`` (at ``head_offset`` among ``total_heads``)."""
    if (mask is None) == (seed is None):
        raise ValueError("dropout attention takes exactly one of mask= and "
                         "seed=")
    return mask if mask is not None else dropout_keep_plain(
        seed, B, H, N, rate, head_offset, total_heads)


def _drop_attend_plain(q, k, v, keep, scale: float, rate: float):
    """q, k, v (B, H, N, Dh), keep int8 (B, H, N, N) -> (out (B, H, N, Dh)
    in q's dtype, lse (B, H, N) base 2).  The JAX drop forward's order:
    l = sum of the unrounded p = exp2(s - m) before dropout; the PV
    operand p * keep / (1 - rate) rounded to the v dtype; out = (pd v) / l;
    lse = m + log2 l.  m is the row maximum rounded up to an integer, as
    the kernel's: power-of-two shifts commute with both roundings."""
    dt, acc = q.dtype, _acc(q.dtype)
    qs = (q.to(acc) * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = s.sub_(m).exp2_()           # in place: N^2 temporaries are large
    denom = p.sum(dim=-1, keepdim=True)
    pd = keep.to(acc).mul_(1.0 / (1.0 - rate)).mul_(p).to(v.dtype)
    del s, p
    o = torch.matmul(pd.to(acc), v.to(acc)) / denom
    return o.to(dt), (m + torch.log2(denom))[..., 0]


def flash_attention_drop_fwd_plain(q, k, v, num_heads: int, scale: float,
                                   rate: float, *, mask=None, seed=None,
                                   head_offset=None, total_heads=None):
    """The dropout training forward on separate (B, N, C) operands -> (out
    (B, N, C) in q's dtype, lse (B, H, N) base 2); the keep source is
    exactly one of ``mask`` (int8 (B, H, N, N)) and ``seed`` (2 int32
    words, the kernels' Philox bits, drawn for heads ``head_offset`` on of
    ``total_heads``: ``dropout_keep_plain``)."""
    B, N, _ = q.shape
    keep = _keep_mask(mask, seed, B, num_heads, N, rate, head_offset,
                      total_heads)
    heads = (_heads(t, num_heads) for t in (q, k, v))
    o, lse = _drop_attend_plain(*heads, keep, scale, rate)
    return _merge_heads(o), lse


def flash_attention_drop_bwd_plain(q, k, v, out, lse, dout, num_heads: int,
                                   scale: float, rate: float, *, mask=None,
                                   seed=None, head_offset=None,
                                   total_heads=None):
    """The dropout training backward -> (dq, dk, dv), each (B, N, C) in q's
    dtype: with f = keep / (1 - rate), s = bf16(q * scale * log2 e) . k,
    p = exp2(s - lse); dv = bf16(p f)^T dout; dp = (dout v^T) f;
    ds = p (dp - delta), delta = rowsum(dout * out); dk = bf16(ds)^T q *
    scale and dq = bf16(ds) k * scale (q unscaled): the arithmetic of the
    TPU kernels _bwd_dq_kernel_drop and _bwd_dkv_kernel_drop."""
    B, N, _ = q.shape
    keep = _keep_mask(mask, seed, B, num_heads, N, rate, head_offset,
                      total_heads)
    dt, acc = q.dtype, _acc(q.dtype)
    q, k, v = (_heads(t, num_heads).to(acc) for t in (q, k, v))
    do = _heads(dout, num_heads).to(acc)
    delta = attention_delta(out, dout, num_heads)[..., None]
    qs = (q * (scale * LOG2E)).to(dt).to(acc)
    p = torch.matmul(qs, k.transpose(-1, -2)).sub_(
        lse.to(acc)[..., None]).exp2_()
    f = keep.to(acc).mul_(1.0 / (1.0 - rate))
    dv = torch.matmul((p * f).to(dt).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2)).mul_(f)
    del f
    ds = dp.sub_(delta).mul_(p).to(dt).to(acc)
    del dp, p
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dq = torch.matmul(ds, k) * scale
    return tuple(_merge_heads(g).to(dt) for g in (dq, dk, dv))


def _check_drop(name: str, q, num_heads: int, rate: float, mask, seed,
                head_offset=None, total_heads=None):
    """The dropout rate and the keep source of a CUDA launch."""
    B, N, _ = q.shape
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} outside (0, 1)")
    if (head_offset or 0) < 0 or (total_heads is not None
                                  and total_heads < 1):
        raise ValueError(f"{name}: head_offset {head_offset} and "
                         f"total_heads {total_heads}")
    if (mask is None) == (seed is None):
        raise ValueError(f"{name}: exactly one of mask= and seed=")
    if mask is not None:
        if mask.dtype != torch.int8 or mask.shape != (B, num_heads, N, N) \
                or mask.device != q.device or mask.stride(3) != 1 \
                or mask.stride(2) != N:
            raise ValueError(f"{name}: mask must be int8 ({B}, {num_heads}, "
                             f"{N}, {N}) on q's device, its (N, N) rows "
                             f"contiguous")
    elif seed.dtype != torch.int32 or seed.numel() != 2 \
            or seed.device != q.device or not seed.is_contiguous():
        raise ValueError(f"{name}: seed must be 2 contiguous int32 words on "
                         f"q's device")


def _keep_args(rate: float, mask, seed, num_heads: int, head_offset: int,
               total_heads):
    """The keep-source arguments of the C entry points: mask, its (batch,
    head) strides, seed, threshold, 1 / keep, the Philox counter's first
    head and head count."""
    inv_keep = 1.0 / (1.0 - rate)
    heads = (int(head_offset or 0), num_heads if total_heads is None
             else int(total_heads))
    if mask is not None:
        return (mask.data_ptr(), mask.stride(0), mask.stride(1), None, 0,
                inv_keep, *heads)
    return (None, 0, 0, seed.data_ptr(), dropout_rng_thresh(rate), inv_keep,
            *heads)


def flash_attention_drop_fwd(q, k, v, num_heads: int, scale: float,
                             rate: float, *, mask=None, seed=None,
                             head_offset=None, total_heads=None):
    """The dropout training forward (kernel C4-fwd): q, k, v as
    ``flash_attention``, dropout ``rate`` in (0, 1), the keep source
    exactly one of ``mask`` (int8 (B, H, N, N) on the device, 1 = keep)
    and ``seed`` (2 int32 words on the device) -> (out (B, N, C) contiguous
    in q's dtype, lse (B, H, N) fp32 base 2).  ``head_offset`` and
    ``total_heads`` (None: 0 and H) place the seed's Philox draws among a
    model's heads: a tensor-parallel rank's heads draw the bits a launch
    over all of them would (``dropout_keep_plain``)."""
    if q.device.type == "cpu":
        return flash_attention_drop_fwd_plain(
            q, k, v, num_heads, scale, rate, mask=mask, seed=seed,
            head_offset=head_offset, total_heads=total_heads)
    name = "flash_attention_drop_fwd"
    B, N, C, D = _check_sep_float(name, (q, k, v), num_heads, scale)
    _check_drop(name, q, num_heads, rate, mask, seed, head_offset,
                total_heads)
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32,
                      device=q.device)
    if B == 0 or N == 0:
        return out, lse
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_fwd_lse_drop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, N, num_heads, D, *_strides(q), *_strides(k),
        *_strides(v), N * C, C, float(scale * LOG2E),
        *_keep_args(rate, mask, seed, num_heads, head_offset, total_heads),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention_fwd_lse_drop")
    global DROP_FWD_LAUNCHES, DROP_RNG_FWD_LAUNCHES
    if mask is not None:
        DROP_FWD_LAUNCHES += 1
    else:
        DROP_RNG_FWD_LAUNCHES += 1
    _count_fwd_route(q.dtype, D)
    return out, lse


def flash_attention_drop_bwd(q, k, v, out, lse, dout, num_heads: int,
                             scale: float, rate: float, *, mask=None,
                             seed=None, head_offset=None,
                             total_heads=None):
    """The dropout training backward (kernel C4-bwd): q, k, v, rate and the
    keep source (with ``head_offset`` and ``total_heads``) as
    ``flash_attention_drop_fwd``, its out (B, N, C) and lse (B, H, N)
    fp32, and dout (B, N, C) -> (dq, dk, dv), each (B, N, C) contiguous in
    q's dtype; delta = rowsum(dout * out) is computed here
    (``flash_attention_delta``)."""
    if q.device.type == "cpu":
        return flash_attention_drop_bwd_plain(
            q, k, v, out, lse, dout, num_heads, scale, rate, mask=mask,
            seed=seed, head_offset=head_offset, total_heads=total_heads)
    name = "flash_attention_drop_bwd"
    B, N, C, D = _check_sep_float(name, (q, k, v), num_heads, scale)
    _check_bwd_inputs(name, q, out, lse, dout, (B, N, C), num_heads)
    _check_drop(name, q, num_heads, rate, mask, seed, head_offset,
                total_heads)
    dq, dk, dv = torch.empty((3, B, N, C), dtype=q.dtype,
                             device=q.device).unbind(0)
    if B == 0 or N == 0:
        return dq, dk, dv
    delta = flash_attention_delta(out, dout, num_heads)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_bwd_drop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, num_heads, D, *_strides(q), *_strides(k),
        *_strides(v), N * C, C, N * C, C, float(scale * LOG2E), float(scale),
        *_keep_args(rate, mask, seed, num_heads, head_offset, total_heads),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention_bwd_drop")
    global DROP_BWD_LAUNCHES, DROP_RNG_BWD_LAUNCHES
    if mask is not None:
        DROP_BWD_LAUNCHES += 1
    else:
        DROP_RNG_BWD_LAUNCHES += 1
    _count_bwd_route(q.dtype, D)
    return dq, dk, dv


class FlashAttentionDrop(torch.autograd.Function):
    """Training attention with dropout: forward C4-fwd, backward C4-bwd.
    ``keep`` is the mask (``form`` 'mask') or the seed ('seed', drawn at
    ``heads`` = (head_offset, total_heads)); saves (q, k, v, keep, out,
    lse), as _flash_core_drop_fwd and _flash_core_drop_rng_fwd do."""

    @staticmethod
    def forward(ctx, q, k, v, keep, num_heads: int, scale: float,
                rate: float, form: str, heads=(None, None)):
        out, lse = _residuals(lambda: flash_attention_drop_fwd(
            q, k, v, num_heads, scale, rate, **{form: keep},
            head_offset=heads[0], total_heads=heads[1]))
        ctx.save_for_backward(q, k, v, keep, out, lse)
        ctx.num_heads, ctx.scale, ctx.rate, ctx.form = (num_heads, scale,
                                                        rate, form)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, keep, out, lse = ctx.saved_tensors
        grads = flash_attention_drop_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.num_heads, ctx.scale,
            ctx.rate, **{ctx.form: keep}, head_offset=ctx.heads[0],
            total_heads=ctx.heads[1])
        return (*grads, None, None, None, None, None, None)


def flash_attention_drop(q, k, v, num_heads: int, scale: float, rate: float,
                         *, mask=None, seed=None, head_offset=None,
                         total_heads=None):
    """Non-causal attention with dropout on the probabilities (kernels C4):
    q, k, v as ``flash_attention``, dropout ``rate`` in (0, 1) and exactly
    one keep source, ``mask`` (int8 (B, H, N, N), 1 = keep) or ``seed``
    (2 int32 words, the kernels' Philox bits, drawn for heads
    ``head_offset`` on of ``total_heads``) -> (B, N, C) in q's dtype."""
    if (mask is None) == (seed is None):
        raise ValueError("flash_attention_drop: exactly one of mask= and "
                         "seed=")
    form, keep = ("mask", mask) if mask is not None else ("seed", seed)
    return FlashAttentionDrop.apply(q, k, v, keep, num_heads, scale, rate,
                                    form, (head_offset, total_heads))


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


@contextlib.contextmanager
def _fp32_matmul_exact():
    """fp32 matrix products in full fp32 on the card (no TF32), so that
    products of int8 values summed below 2^24 stay exact."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def int8_attention_codes(qkv_i8, amax, num_heads: int, scale: float):
    """The probability codes of the int8-compute attention -> (p (B, H, N,
    N) fp32 integers in [0, 127], v (B, H, N, Dh) int8, sv (H, 1, 1)).

    Per head, with sq, sk, sv = amax / 127: s = float(q_i8 . k_i8) *
    (((sq * sk) * scale) * log2e); p = round_half_even(exp2(s - m) * 127)
    with m the row maximum of s.  The scores are an fp32 product of the
    int8 values: exact, each partial sum an integer below 64 * 127^2 <
    2^24, with TF32 off.
    """
    q, k, v = _split_heads(qkv_i8, num_heads)
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    with _fp32_matmul_exact():
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * LOG2E)
    p = torch.round(torch.exp2(s - s.amax(dim=-1, keepdim=True)) * 127.0)
    return p, v, sv


def flash_attention_qkv_int8_plain(qkv_i8, amax, num_heads: int,
                                   scale: float):
    """The int8-compute attention -> bf16 (B, N, C).

    qkv_i8 (B, N, 3C) int8 per-head codes against amax (3, H) fp32; the
    codes p of ``int8_attention_codes``; l = the fp32 row sum of p (exact
    integers); o = p . v_i8, exact in float64 (at N = 1568 the sums reach
    1568 * 127^2 > 2^24); out = bf16((float(o) / l) * sv).
    """
    p, v, sv = int8_attention_codes(qkv_i8, amax, num_heads, scale)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.double(), v.double()).float()
    return _merge_heads((o / l * sv).to(torch.bfloat16))


def flash_attention_qkv_int8(qkv_i8, amax, num_heads: int, scale: float):
    """Non-causal attention computed in int8 on the packed int8 qkv
    (kernel E2) -> bf16 (B, N, C).

    qkv_i8: (B, N, 3C) int8, contiguous, [q | k | v] columns each
    (H, Dh)-major, Dh a multiple of 8 and at most 64 (a multiple of 16 goes
    straight in, 8 is zero-padded to 16); amax: (3, H) fp32, the per-head
    absmax the codes were made against, on the device (no host
    synchronisation).
    """
    if qkv_i8.device.type == "cpu":
        return flash_attention_qkv_int8_plain(qkv_i8, amax, num_heads, scale)
    name = "flash_attention_qkv_int8"
    if qkv_i8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv_i8.device}")
    if qkv_i8.dtype != torch.int8 or qkv_i8.dim() != 3 \
            or qkv_i8.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: qkv {qkv_i8.dtype} "
                         f"{tuple(qkv_i8.shape)} is not int8 "
                         f"(B, N, 3 * {num_heads} * Dh)")
    B, N, C3 = qkv_i8.shape
    C = C3 // 3
    D = C // num_heads
    if D % 8 or D > INT8_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 and "
                         f"at most {INT8_MAX_HEAD_DIM}")
    if not qkv_i8.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if not scale > 0:
        raise ValueError(f"{name}: scale {scale} must be > 0")
    if amax.numel() != 3 * num_heads or amax.dtype != torch.float32 \
            or amax.device != qkv_i8.device or not amax.is_contiguous():
        raise ValueError(f"{name}: amax must be {3 * num_heads} contiguous "
                         f"fp32 values on qkv's device")
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=torch.bfloat16,
                           device=qkv_i8.device)
    dp = -(-D // 16) * 16
    if dp != D:
        qkv_i8 = _pad_heads(qkv_i8, 3 * num_heads, dp)
    if qkv_i8.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    out = torch.empty((B, N, num_heads * dp), dtype=torch.bfloat16,
                      device=qkv_i8.device)
    route = attention_int8_route(dp)
    # the wgmma route's v^T scratch: (B, H, 64, N rounded up to 16) int8
    vt = (torch.empty(B * num_heads * dp * (-(-N // 16) * 16),
                      dtype=torch.int8, device=qkv_i8.device)
          if route == "wgmma" else None)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(qkv_i8.device).cuda_stream
    code = lib.stt_attention_int8(qkv_i8.data_ptr(), amax.data_ptr(),
                                  out.data_ptr(),
                                  None if vt is None else vt.data_ptr(),
                                  B, N, num_heads, dp, float(scale), stream)
    kbuild.check(code, "attention_int8")
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    globals()[_INT8_COUNTERS[route]] += 1
    if dp != D:
        out = out.view(B, N, num_heads, dp)[..., :D].reshape(B, N, C)
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
    multiple of 8 up to 128 (below 64 one that is no multiple of 16 is
    zero-padded to the next, ``attention_i8_head_dim``; 64 to 128, IV2-1B's
    88 among them, are read in place and the kernel's (B, N, C) output
    returned as it is, unless C is no multiple of 16, an odd head count at
    72, 88, 104 or 120, whose heads are padded too);
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
    dp = attention_i8_head_dim(D)
    if C % 16:  # rows of 16 bytes for the kernel's maps: pad (odd H)
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


def flash_attention_qkv_q8_plain(qkv, num_heads: int, scale: float,
                                 out_amax):
    """A1's plain version on the packed qkv with the fp32 result quantized
    against ``out_amax`` -> int8 (B, N, C)."""
    o, _ = _attend_plain(*_split_heads(qkv, num_heads), scale,
                         _acc(qkv.dtype))
    return quantize_static(_merge_heads(o).float(), out_amax)


def flash_attention_q8_plain(q, k, v, num_heads: int, scale: float,
                             out_amax, n_valid=None):
    """The same on separate (B, N, C) operands, keys at or beyond
    ``n_valid`` left out."""
    q, k, v = (_heads(t, num_heads) for t in (q, k, v))
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    o, _ = _attend_plain(q, k, v, scale, _acc(q.dtype))
    return quantize_static(_merge_heads(o).float(), out_amax)


def _check_out_amax(name, out_amax, dev):
    if out_amax.numel() != 1 or out_amax.dtype != torch.float32 \
            or out_amax.device != dev or not out_amax.is_contiguous():
        raise ValueError(f"{name}: out_amax must be one contiguous fp32 "
                         f"value on the inputs' device")


def _launch_attention_q8(q, k, v, out_amax, num_heads: int, scale: float,
                         n_kv: int):
    """Kernel B3 on three non-empty (B, N, C) operands, each read through
    its own (batch, row) strides, keys at or beyond ``n_kv`` masked -> int8
    (B, N, C) contiguous."""
    B, N, C = q.shape
    out = torch.empty((B, N, C), dtype=torch.int8, device=q.device)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.stt_attention_q8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out_amax.data_ptr(),
        out.data_ptr(), B, N, n_kv, num_heads, C // num_heads, *_strides(q),
        *_strides(k), *_strides(v), N * C, C, float(scale * LOG2E),
        kbuild.dtype_code(q.dtype), stream)
    kbuild.check(code, "attention_q8")
    return out


def flash_attention_qkv_q8(qkv, num_heads: int, scale: float, out_amax):
    """Static int8 attention with an int8 output, on the packed qkv
    (kernel B3): qkv as ``flash_attention_qkv``; out_amax one fp32 value on
    the device -> int8 (B, N, C) codes against it.  Inference only."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_q8_plain(qkv, num_heads, scale, out_amax)
    name = "flash_attention_qkv_q8"
    B, N, C, D = _check_packed(name, qkv, num_heads, scale)
    _check_out_amax(name, out_amax, qkv.device)
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=torch.int8, device=qkv.device)
    out = _launch_attention_q8(*_qkv_views(qkv, C), out_amax, num_heads,
                               scale, N)
    global Q8_LAUNCHES
    Q8_LAUNCHES += 1
    _count_fwd_route(qkv.dtype, D)
    return out


def flash_attention_q8(q, k, v, num_heads: int, scale: float, out_amax,
                       n_valid=None):
    """Kernel B3 on separate operands: q, k, v as ``flash_attention``
    (v may be the strided column block of the qkv output); out_amax one
    fp32 value on the device; n_valid: keys at or beyond it are masked (all
    N query rows are computed) -> int8 (B, N, C) codes.  Inference only."""
    if q.device.type == "cpu":
        return flash_attention_q8_plain(q, k, v, num_heads, scale, out_amax,
                                        n_valid)
    name = "flash_attention_q8"
    B, N, C, D = _check_sep_float(name, (q, k, v), num_heads, scale)
    _check_out_amax(name, out_amax, q.device)
    n_kv = N if n_valid is None else int(n_valid)
    if N and not 0 < n_kv <= N:
        raise ValueError(f"{name}: n_valid {n_valid} outside 1..{N}")
    if B == 0 or N == 0:
        return torch.empty((B, N, C), dtype=torch.int8, device=q.device)
    out = _launch_attention_q8(q, k, v, out_amax, num_heads, scale, n_kv)
    global Q8_SEP_LAUNCHES
    Q8_SEP_LAUNCHES += 1
    _count_fwd_route(q.dtype, D)
    return out
