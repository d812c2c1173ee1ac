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
ops/flash_attention.py:flash_attention, in training (grad mode, operands
requiring grad) the separate-operand training attention (kernels C3); its
static int8 form
``dot_product_attention_i8_sep`` (the JAX IV2Attention's int8-storage
branch) quantizes each operand per head against the calibrated
``qkv_amax``, unless it already arrives as int8 codes (the fused
RMSNorm->int8 q/k-norms), then runs flash_attention_i8d.

Static int8 routes (the JAX Attention and IV2Attention modules' branches,
with the TPU program's geometry gates copied as plain functions of the
shape, without its environment knobs): ``static_attention_route`` picks
int8 storage (B2) where ``i8_storage_attn_supported`` holds and the model
keeps its ``qkv_i8`` default, else the bf16 attention with the int8
output epilogue (B3, ops/flash_attention.py:flash_attention_qkv_q8) where
the packed kernel takes the geometry, else plain bf16 attention on
separate operands whose float output the proj GEMM quantizes itself (the
JAX fallback, which drops the int8 epilogue).  With ``int8_attn`` (the JAX
package's SIMPLE_TAD_INT8_ATTN made an argument) the route is 'int8' first,
wherever ``int8_attn_supported`` holds, whatever ``qkv_i8`` says:
``dot_product_attention_qkv_int8`` quantizes qkv per head as the int8-storage
route does and runs the int8-compute attention (E2,
ops/flash_attention.py:flash_attention_qkv_int8), whose bf16 output the proj
GEMM quantizes itself.
``static_attention_sep_route`` is InternVideo2's: int8 storage on
separate operands (D2) where ``i8_storage_attn_sep_supported`` holds,
else B3 on separate operands (flash_attention_q8) where the TPU's
flash_attention takes the padded head dim, else the float fallback.

Attention dropout (port of the JAX dispatch's dropout branch,
ops/attention.py:248-310 there): callers pass a positive ``dropout_rate``
only in training, with the ``generator`` the keep bits are drawn from.
The JAX package takes dropout on its (B*H, N, Dh) path, never the packed
one; the port's kernels C4 (ops/flash_attention.py:flash_attention_drop)
read q, k and v in place, the packed qkv as three column views.
``dropout_form`` is the JAX package's environment knob
SIMPLE_TAD_DROPOUT_MASK made an argument: 'rng' (the TPU program's
default) draws a 2-word seed on the generator's device and the kernels
draw Philox bits from it, 'mask' draws an int8 (B, H, N, N) keep mask
(``make_dropout_mask``) that the kernels read.  Beyond the TPU kernels'
single-pass cap (N > 4096) both take the JAX package's route: plain
attention with the mask form.  With no dropout nothing changes and the
generator is not advanced.

Under tensor parallelism (parallel/tp.py) a rank computes ``num_heads``
heads of a model's ``total_heads``, from ``head_offset`` on (heads padded
past the model's count sit at the end).  Its dropout draws what a call
over every head draws, from a generator every model rank holds in the
same state: the same seed, whose Philox bits the kernels take at the
rank's global heads (ops/flash_attention.py:flash_attention_drop), or the
whole (B, total_heads, N, N) mask, of which the rank reads its heads'
slice (all kept for padded heads, whose output and gradients are 0).
"""

from __future__ import annotations

import torch

# dropout_rng_thresh (the Philox form's keep threshold, a copy of the JAX
# package's _drop_rng_thresh) is re-exported beside the dispatch
from simple_tad_tpu_torch.ops.flash_attention import (  # noqa: F401
    MAX_HEAD_DIM, dropout_rng_thresh, flash_attention, flash_attention_drop,
    flash_attention_i8d, flash_attention_qkv, flash_attention_qkv_i8d,
    flash_attention_qkv_int8)
from simple_tad_tpu_torch.ops.ln import quant_scale

DROPOUT_FORMS = ("rng", "mask")

# the TPU kernels' single-pass sequence cap (simple_tad_tpu/ops/
# flash_attention.py:MAX_SINGLE_PASS_N): beyond it the JAX package's
# static models take plain attention
MAX_SINGLE_PASS_N = 4096
_LANE_GROUP = 128


def _pick_block(n: int) -> int:
    """Largest multiple-of-8 divisor of n within the TPU kernels' 10 MiB
    fp32 score-tile budget (flash_attention.py:_pick_block, target 0)."""
    target = max(128, 10 * 2 ** 20 // (n * 4))
    best = 8
    for d in range(8, min(n, target) + 1, 8):
        if n % d == 0:
            best = d
    return best


def _pad_rows(n: int) -> int:
    """The TPU kernels' padded sequence length (flash_attention.py:
    _pad_rows): a multiple of 8, or of 256 where the multiple of 8 has no
    query block of 256 rows."""
    np8 = -(-n // 8) * 8
    if n > 256 and _pick_block(np8) < 256:
        return -(-n // 256) * 256
    return np8


def i8_storage_attn_supported(N: int, C: int, num_heads: int) -> bool:
    """Does the JAX package's static ViT take int8-storage attention (B2)
    at this geometry (ops/attention.py:i8_storage_attn_supported)?  The
    head dim divides 128 and is no multiple of it, the channel axis is
    128-aligned, and N is within the single-pass cap (within it the
    packed kernel's VMEM plan always exists)."""
    D = C // num_heads
    return (N <= MAX_SINGLE_PASS_N and _LANE_GROUP % D == 0
            and D % _LANE_GROUP != 0 and C % _LANE_GROUP == 0)


def int8_attn_supported(N: int, C: int, num_heads: int) -> bool:
    """Does the JAX package's static ViT with SIMPLE_TAD_INT8_ATTN take the
    int8-compute attention (E2) at this geometry (ops/attention.py:
    int8_attn_supported, without its environment knobs)?  Its gate is the
    int8-storage one: the head dim divides 128 and is no multiple of it,
    the channel axis is 128-aligned, N is within the single-pass cap."""
    return i8_storage_attn_supported(N, C, num_heads)


def packed_q8_attn_supported(N: int, C: int, num_heads: int) -> bool:
    """Does the JAX package's static ViT take the packed bf16 attention
    with the int8 output epilogue (B3) where int8 storage is not taken
    (ops/attention.py:dot_product_attention_qkv's TPU branch)?"""
    D = C // num_heads
    return (D % 64 == 0 and _LANE_GROUP % D == 0 and C % _LANE_GROUP == 0
            and N <= MAX_SINGLE_PASS_N)


def _i8_head_pad(D: int) -> int:
    """The smallest divisor of 128 that holds D (flash_attention.py:
    _i8_head_pad), 0 past 128."""
    return next((dp for dp in (8, 16, 32, 64, 128) if dp >= D), 0)


def i8_storage_attn_sep_supported(N: int, C: int, num_heads: int) -> bool:
    """Does the JAX package's static InternVideo2 take int8-storage
    attention on separate operands (D2) at this geometry
    (ops/attention.py:i8_storage_attn_sep_supported)?  The head dim pads
    to a divisor of 128, the padded channel axis is 128-aligned, and a TPU
    plan exists: the key-grid plan (which covers N up to ~4580), or the
    single-pass one, whose double-buffered 128-lane k/v blocks
    (4 * padded N * 128 * 2 bytes) must stay under an 18 MiB budget."""
    dp = _i8_head_pad(C // num_heads)
    return (dp > 0 and (num_heads * dp) % _LANE_GROUP == 0
            and 4 * _pad_rows(N) * _LANE_GROUP * 2 < 18 * 2 ** 20)


def sep_q8_attn_supported(N: int, C: int, num_heads: int) -> bool:
    """Does the JAX package's static InternVideo2 take the bf16 attention
    with the int8 output epilogue on separate operands (B3) where int8
    storage is not taken (ops/attention.py:dot_product_attention ->
    flash_attention's packed branch, the head dim zero-padded to a multiple
    of 64)?"""
    dp = -(-(C // num_heads) // 64) * 64
    return (_LANE_GROUP % dp == 0 and (num_heads * dp) % _LANE_GROUP == 0
            and N <= MAX_SINGLE_PASS_N)


def static_attention_route(N: int, C: int, num_heads: int,
                           qkv_i8: bool = True,
                           int8_attn: bool = False) -> str:
    """The static int8 ViT's attention at this geometry, as the TPU program
    routes it (models/layers.py Attention): 'int8' (int8 compute, E2; with
    ``int8_attn``), 'i8' (int8 storage, B2), 'q8' (bf16 with the int8
    epilogue, B3) or 'float' (bf16 on separate operands, the proj GEMM
    quantizing its input)."""
    if int8_attn and int8_attn_supported(N, C, num_heads):
        return "int8"
    if qkv_i8 and i8_storage_attn_supported(N, C, num_heads):
        return "i8"
    return "q8" if packed_q8_attn_supported(N, C, num_heads) else "float"


def static_attention_sep_route(N: int, C: int, num_heads: int,
                               qkv_i8: bool = True) -> str:
    """The same for InternVideo2 (models/internvideo2.py IV2Attention):
    'i8' (D2), 'q8' (B3 on separate operands) or 'float'."""
    if qkv_i8 and i8_storage_attn_sep_supported(N, C, num_heads):
        return "i8"
    return "q8" if sep_q8_attn_supported(N, C, num_heads) else "float"


def _draw_device(generator, device):
    if device is not None:
        return device
    return generator.device if generator is not None else "cpu"


def make_dropout_mask(generator, rate: float, B: int, H: int, N: int,
                      device=None):
    """int8 (B, H, N, N) keep mask, 1 with probability 1 - rate, drawn from
    ``generator`` on ``device`` (by default the generator's): the mask
    form's source, as the JAX package's make_dropout_mask draws it outside
    any kernel."""
    return torch.empty((B, H, N, N), dtype=torch.int8,
                       device=_draw_device(generator, device)).bernoulli_(
                           1.0 - rate, generator=generator)


def draw_dropout_seed(generator, device=None):
    """The RNG form's source: 2 int32 words drawn from ``generator`` on
    ``device`` (by default the generator's), left there (no host
    synchronisation)."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=generator,
                         device=_draw_device(generator, device),
                         dtype=torch.int64).to(torch.int32)


def naive_attention_dropout(q, k, v, num_heads: int, scale: float,
                            rate: float, mask):
    """The JAX package's route beyond the single-pass cap
    (ops/attention.py:_naive_attention with a dropout mask): (q * scale)
    k^T in fp32, softmax, times mask / (1 - rate), rounded to q's dtype,
    times v -> (B, N, C) in q's dtype; plain PyTorch under autograd."""
    dt = q.dtype
    qh, kh, vh = (t.view(*t.shape[:2], num_heads, -1).transpose(1, 2)
                  for t in (q, k, v))
    logits = torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1) * (mask.float() / (1.0 - rate))
    o = torch.matmul(probs.to(dt).float(), vh.float()).to(dt)
    return o.transpose(1, 2).reshape(q.shape)


def _rank_mask(generator, rate: float, B: int, N: int, num_heads: int,
               head_offset, total_heads, device):
    """The mask form's keep mask of heads ``head_offset`` to ``head_offset +
    num_heads`` of ``total_heads``: the whole model's mask is drawn, then
    sliced; heads past ``total_heads`` (padding) keep everything."""
    if total_heads is None:
        return make_dropout_mask(generator, rate, B, num_heads, N, device)
    h0 = head_offset or 0
    whole = make_dropout_mask(generator, rate, B, total_heads, N, device)
    mine = whole[:, h0:h0 + num_heads]
    if mine.shape[1] < num_heads:
        mine = torch.cat([mine, torch.ones(
            (B, num_heads - mine.shape[1], N, N), dtype=mine.dtype,
            device=device)], dim=1)
    return mine


def _dropout_attention(q, k, v, num_heads: int, scale: float, rate: float,
                       generator, form: str, head_offset=None,
                       total_heads=None):
    """Attention with dropout on (B, N, C) operands, the keep source drawn
    from ``generator`` on q's device (for heads ``head_offset`` on of
    ``total_heads``: a tensor-parallel rank's)."""
    if form not in DROPOUT_FORMS:
        raise ValueError(f"unknown dropout form {form!r}; expected one of "
                         f"{DROPOUT_FORMS}")
    B, N, _ = q.shape
    if N > MAX_SINGLE_PASS_N or form == "mask":
        mask = _rank_mask(generator, rate, B, N, num_heads, head_offset,
                          total_heads, q.device)
        if N > MAX_SINGLE_PASS_N:
            return naive_attention_dropout(q, k, v, num_heads, scale, rate,
                                           mask)
        return flash_attention_drop(q, k, v, num_heads, scale, rate,
                                    mask=mask)
    return flash_attention_drop(q, k, v, num_heads, scale, rate,
                                seed=draw_dropout_seed(generator, q.device),
                                head_offset=head_offset,
                                total_heads=total_heads)


def dot_product_attention_qkv(qkv, *, num_heads: int, scale: float,
                              dropout_rate: float = 0.0, generator=None,
                              dropout_form: str = "rng", head_offset=None,
                              total_heads=None):
    """qkv: (B, N, 3C) in [q | k | v] column order -> (B, N, C).
    ``dropout_rate``: the attention dropout in effect (0 outside training),
    its keep bits drawn from ``generator`` in ``dropout_form``, for heads
    ``head_offset`` on of ``total_heads`` (a tensor-parallel rank's)."""
    if dropout_rate > 0.0:
        B, N, C3 = qkv.shape
        q, k, v = qkv.view(B, N, 3, C3 // 3).unbind(2)
        return _dropout_attention(q, k, v, num_heads, scale, dropout_rate,
                                  generator, dropout_form, head_offset,
                                  total_heads)
    return flash_attention_qkv(qkv, num_heads=num_heads, scale=scale)


def dot_product_attention(q, k, v, *, num_heads: int, scale: float,
                          dropout_rate: float = 0.0, generator=None,
                          dropout_form: str = "rng"):
    """Separate (B, N, C) q, k, v (each may be a strided column view) ->
    (B, N, C); trains through kernels C3 where the operands require grad,
    and through C4 with a positive ``dropout_rate`` (drawn from
    ``generator`` in ``dropout_form``)."""
    if dropout_rate > 0.0:
        return _dropout_attention(q, k, v, num_heads, scale, dropout_rate,
                                  generator, dropout_form)
    return flash_attention(q, k, v, num_heads=num_heads, scale=scale)


def quantize_per_head(t, amax, num_heads: int):
    """(B, N, C) float -> int8 codes clip(round_half_even(t * 127 / amax),
    +-127) with ``amax`` (H,) the absmax of each head's columns."""
    D = t.shape[-1] // num_heads
    inv = quant_scale(amax)
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
    kernel.  The static model takes this where
    ``i8_storage_attn_supported`` holds (``static_attention_route``).
    """
    qkv_i8 = quantize_per_head(qkv, qkv_amax.reshape(-1), 3 * num_heads)
    return flash_attention_qkv_i8d(qkv_i8, qkv_amax, num_heads, scale,
                                   out_amax)


def dot_product_attention_qkv_int8(qkv, qkv_amax, *, num_heads: int,
                                   scale: float):
    """int8-compute attention: qkv (B, N, 3C) float, post-bias -> bf16
    (B, N, C), quantized per head against ``qkv_amax`` (3, H) as
    ``dot_product_attention_qkv_i8`` quantizes it, then
    flash_attention_qkv_int8.  The static model takes this where
    ``static_attention_route`` returns 'int8'."""
    qkv_i8 = quantize_per_head(qkv, qkv_amax.reshape(-1), 3 * num_heads)
    return flash_attention_qkv_int8(qkv_i8, qkv_amax, num_heads, scale)
