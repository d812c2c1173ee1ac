"""Static int8 GEMMs with the quantize, rescale, bias and GELU fused in:
the CUDA kernels (B4) and their plain versions.

Port of simple_tad_tpu/ops/int8_gemm.py: ``w8a8_gemm`` (TPU kernel
_gemm_kernel) and ``w8a8_mlp`` (TPU kernel _mlp_kernel), the JAX package's
opt-in fused int8 GEMMs of static int8 serving.  The kernels are
csrc/int8_gemm.cu (see the note at the top of the source).  The JAX
package reaches them through environment knobs read at trace time; the
port takes explicit model options instead (``fused_w8a8``, ``fused_mlp``:
models/vit.py, models/internvideo2.py).

Numerics (both versions), with c = w_scale * (amax / 127) in fp32:
  * a float x is quantized as clip(round_half_even(x * 127 / amax), +-127)
    (ops/ln.py:quantize_static); an int8 x is taken as those codes (the
    LayerNorm->int8 and int8 attention kernels emit them);
  * the product is an exact int32, converted to fp32, times c, plus the
    fp32 bias (two roundings), then the activation, then one cast to the
    output dtype: bit for bit the unfused static model's
    ops/quant.py:int8_matmul_static + bias + GELU;
  * the MLP quantizes fc1's fp32 activation against fc2's absmax, as the
    unfused model's fc2 does (``w8a8_gemm_q8_plain``: fc1 with the int8
    output its kernel launch writes).
GELU: the JAX _mlp_kernel always applies the tanh form, the unfused model
``gelu_for(dtype)`` (erf at fp32, tanh at bf16; ROADMAP F4).  The port
takes the form as an argument and its models pass ``gelu_act(dtype)``, so
the fused model computes the unfused model's function.

Weights are the port's layout: ``w_q`` (N, K) int8 (the JAX package's
(K, N) transposed), per-output-channel fp32 scales.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``GEMM_LAUNCHES`` counts ``w8a8_gemm`` calls (one kernel
launch each), ``MLP_LAUNCHES`` ``w8a8_mlp`` calls (two launches of the GEMM
kernel each: fc1 into int8 codes, then fc2 on them).

Width rule (``use_fused_mlp``): the MLP takes any dim and hidden that are
multiples of 32, as its two products do; every registered width does (ViT
384/768/1024/1280 x4; InternVideo2 384/768/1024 x4, 1408 x 6144, 3200 x
12800).  Another width takes the per-GEMM route of the model's MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simple_tad_tpu_torch.kernels import build as kbuild
from simple_tad_tpu_torch.ops.ln import quantize_static
from simple_tad_tpu_torch.ops.quant import _int_mm

GEMM_LAUNCHES = 0
MLP_LAUNCHES = 0
# activation codes of csrc/int8_gemm.cu
ACTS = {None: 0, "gelu_tanh": 1, "gelu_erf": 2}


def gelu_act(dtype) -> str:
    """The GELU form the models apply at ``dtype``: tanh at bf16, erf
    otherwise (models/layers.py:gelu_for)."""
    return "gelu_tanh" if dtype == torch.bfloat16 else "gelu_erf"


def activation(y, act):
    """``act`` (None, 'gelu_tanh' or 'gelu_erf') of fp32 ``y``."""
    if act is None:
        return y
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")


def rescale(w_scale, a_amax):
    """Per-output-channel fp32 rescale w_scale * (amax / 127), in the
    unfused model's order of operations."""
    return w_scale * (a_amax / 127.0)


def use_fused_mlp(dim: int, hidden: int) -> bool:
    """Does ``w8a8_mlp`` take this width?  Its two products contract over
    dim and hidden, and the GEMM kernel takes K a multiple of 32 (its
    output width then a multiple of 8): every registered ViT and
    InternVideo2 width.  (The JAX package's mlp_fits_vmem sends IV2-1B to
    its per-GEMM kernel; the port's MLP holds no width-sized state on the
    chip.)"""
    return dim > 0 and hidden > 0 and dim % 32 == 0 and hidden % 32 == 0


def w8a8_gemm_plain(x, w_q, w_scale, a_amax, bias=None, act=None,
                    out_dtype=torch.bfloat16):
    """x (..., K) float, or int8 codes against ``a_amax``; w_q (N, K) int8,
    w_scale (N,) fp32, a_amax one fp32 value, bias (N,) fp32 or None ->
    (..., N) in ``out_dtype``."""
    if x.dtype != torch.int8:
        x = quantize_static(x.float(), a_amax)
    y = _int_mm(x, w_q).float() * rescale(w_scale, a_amax)
    if bias is not None:
        y = y + bias
    return activation(y, act).to(out_dtype)


def w8a8_gemm_q8_plain(x, w_q, w_scale, a_amax, bias, act, out_amax):
    """The GEMM's int8-output form (the MLP kernel's fc1 launch): the fp32
    output of ``w8a8_gemm_plain`` quantized against ``out_amax`` ->
    (..., N) int8 codes."""
    y = w8a8_gemm_plain(x, w_q, w_scale, a_amax, bias, act, torch.float32)
    return quantize_static(y, out_amax)


def w8a8_mlp_plain(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2,
                   act="gelu_tanh", out_dtype=torch.bfloat16):
    """The whole MLP: fc1 (w1_q (hidden, dim)) with its bias and ``act`` in
    fp32, then fc2 (w2_q (dim, hidden)) on that fp32 activation quantized
    against ``amax2`` -> (..., dim) in ``out_dtype``: fc1's codes, then
    fc2 on them, the split of the kernel's two launches."""
    h = w8a8_gemm_q8_plain(x, w1_q, s1, amax1, b1, act, amax2)
    return w8a8_gemm_plain(h, w2_q, s2, amax2, b2, None, out_dtype)


def _check_x(name, x, K):
    if x.dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x is {x.dtype}, not int8, bf16 or fp32")
    if x.shape[-1] != K or K % 32:
        raise ValueError(f"{name}: x {tuple(x.shape)} must end in K = {K}, "
                         f"a multiple of 32")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")


def _check_weight(name, w_q, shape, dev):
    if w_q.dtype != torch.int8 or tuple(w_q.shape) != shape \
            or w_q.device != dev or not w_q.is_contiguous() \
            or w_q.data_ptr() % 16:
        raise ValueError(f"{name}: weight must be a contiguous, 16-byte "
                         f"aligned int8 {shape} on x's device")


def _check_vectors(name, dev, **vectors):
    """fp32 contiguous vectors, each given as (tensor, length, optional)."""
    for what, (t, n, optional) in vectors.items():
        if t is None and optional:
            continue
        if t is None or t.dtype != torch.float32 or t.numel() != n \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be {n} contiguous fp32 "
                             f"values on x's device")


def _check_common(name, act, out_dtype) -> int:
    if act not in ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype {out_dtype} is not bf16 or fp32")
    return int(out_dtype == torch.bfloat16)


def check_gemm_args(x, w_q, w_scale, a_amax, bias=None, act=None,
                    out_dtype=torch.bfloat16) -> int:
    """Raise on what the GEMM kernel does not take (any device) -> its
    output-dtype flag."""
    name = "w8a8_gemm"
    N, K = w_q.shape
    _check_x(name, x, K)
    if N % 8:
        raise ValueError(f"{name}: N = {N} must be a multiple of 8")
    _check_weight(name, w_q, (N, K), x.device)
    _check_vectors(name, x.device, w_scale=(w_scale, N, False),
                   a_amax=(a_amax, 1, False), bias=(bias, N, True))
    return _check_common(name, act, out_dtype)


def check_mlp_args(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2,
                   act="gelu_tanh", out_dtype=torch.bfloat16) -> int:
    """Raise on what the MLP kernel does not take (any device) -> its
    output-dtype flag."""
    name = "w8a8_mlp"
    hidden, dim = w1_q.shape
    if not use_fused_mlp(dim, hidden):
        raise ValueError(f"{name}: no MLP kernel for dim {dim}, hidden "
                         f"{hidden} (use_fused_mlp is False)")
    _check_x(name, x, dim)
    _check_weight(name, w1_q, (hidden, dim), x.device)
    _check_weight(name, w2_q, (dim, hidden), x.device)
    _check_vectors(name, x.device, s1=(s1, hidden, False),
                   s2=(s2, dim, False), amax1=(amax1, 1, False),
                   amax2=(amax2, 1, False), b1=(b1, hidden, True),
                   b2=(b2, dim, True))
    return _check_common(name, act, out_dtype)


def _check_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def w8a8_gemm(x, w_q, w_scale, a_amax, bias=None, act=None,
              out_dtype=torch.bfloat16):
    """Static int8 GEMM y = act(q8(x) W^T * c + bias) (kernel B4).

    x: (..., K) bf16, fp32 or int8 codes, contiguous, K a multiple of 32;
    w_q: (N, K) int8, N a multiple of 8; w_scale: (N,) fp32; a_amax: one
    fp32 value on the device (the calibrated absmax of x); bias: (N,) fp32
    or None; act: None, 'gelu_tanh' or 'gelu_erf' -> (..., N) in
    ``out_dtype`` (bf16 or fp32).
    """
    if x.device.type == "cpu":
        return w8a8_gemm_plain(x, w_q, w_scale, a_amax, bias, act, out_dtype)
    name = "w8a8_gemm"
    _check_cuda(name, x)
    out_bf16 = check_gemm_args(x, w_q, w_scale, a_amax, bias, act, out_dtype)
    N, K = w_q.shape
    lead = x.shape[:-1]
    M = x.numel() // K
    y = torch.empty((*lead, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return y
    comb = rescale(w_scale, a_amax)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.stt_w8a8_gemm(
        x.data_ptr(), kbuild.dtype_code(x.dtype, int8=True), w_q.data_ptr(),
        a_amax.data_ptr(), comb.data_ptr(), _ptr(bias), y.data_ptr(), M, N, K,
        ACTS[act], out_bf16, stream)
    kbuild.check(code, name)
    global GEMM_LAUNCHES
    GEMM_LAUNCHES += 1
    return y


def w8a8_mlp(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2, act="gelu_tanh",
             out_dtype=torch.bfloat16):
    """The whole static int8 MLP in one call (kernel B4-mlp):
    y = q8(act(q8(x) W1^T c1 + b1)) W2^T c2 + b2: two launches of the GEMM
    kernel, fc1 with its int8-output epilogue into an (rows, hidden) int8
    scratch (a quarter of the fp32 activation the per-GEMM route writes),
    then fc2 on those codes.

    x: (..., dim) bf16, fp32 or int8 codes against ``amax1``, contiguous;
    w1_q: (hidden, dim), w2_q: (dim, hidden) int8; s1 (hidden,), s2 (dim,)
    fp32 weight scales; amax1, amax2: the calibrated absmax of x and of
    fc1's activation, one fp32 value each on the device; b1, b2 fp32 or
    None -> (..., dim) in ``out_dtype``.  ``use_fused_mlp(dim, hidden)``
    must hold.
    """
    if x.device.type == "cpu":
        return w8a8_mlp_plain(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2,
                              act, out_dtype)
    name = "w8a8_mlp"
    _check_cuda(name, x)
    out_bf16 = check_mlp_args(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2,
                              act, out_dtype)
    hidden, dim = w1_q.shape
    M = x.numel() // dim
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if M == 0:
        return y
    c1, c2 = rescale(s1, amax1), rescale(s2, amax2)
    h = torch.empty((M, hidden), dtype=torch.int8, device=x.device)
    lib = kbuild.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.stt_w8a8_mlp(
        x.data_ptr(), kbuild.dtype_code(x.dtype, int8=True), w1_q.data_ptr(),
        c1.data_ptr(), _ptr(b1), amax1.data_ptr(), w2_q.data_ptr(),
        c2.data_ptr(), _ptr(b2), amax2.data_ptr(), y.data_ptr(), M, dim,
        hidden, ACTS[act], out_bf16, h.data_ptr(), stream)
    kbuild.check(code, name)
    global MLP_LAUNCHES
    MLP_LAUNCHES += 1
    return y
