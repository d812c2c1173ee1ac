"""Transformer building blocks of the video ViT, in PyTorch.

Port of simple_tad_tpu/models/layers.py.  Parameters carry the reference's
torch names (``norm1.weight``, ``attn.qkv.weight``, ``attn.q_bias``,
``mlp.fc1.weight``, ``patch_embed.proj.weight``, ...) so a released
``.pth`` loads by name.  Parameters are stored in ``param_dtype``: by
default (inference) the dtype the JAX package computes them in, i.e.
Linear weights and biases, ``q_bias``/``v_bias`` and LayerScale gammas in
the compute dtype and LayerNorm parameters and the patch-embed bias in
fp32; for training fp32 masters throughout, each cast to the compute dtype
in ``forward`` as flax's ``nn.Dense(dtype=bf16)`` casts its fp32 kernel, so
gradients reach the fp32 parameters.  Nothing is initialised at
construction (``torch.empty``); ``init_weights`` fills every parameter from
an explicit ``torch.Generator``.

Training (``module.train()``): stochastic depth (``drop_path``, after the
LayerScale multiply), the proj/MLP dropout and the attention dropout
(kernels C4, in ``attn_dropout_form`` 'rng' or 'mask': ops/attention.py)
draw their masks from the ``generator`` passed to ``forward``, each
layer's attention draw before its proj dropout's, as the JAX Attention
calls make_rng.

Gradient checkpointing (``remat``; port of the JAX package's nn.remat of
the block scan under ``remat_policy``): ``block_call`` runs each block
through ``checkpoint_block``, which keeps the block's input and its
attention's (out, lse) (ops/flash_attention.py:AttentionResiduals) and
recomputes the rest in the backward: the qkv GEMM, the norms and the MLP
run twice, the forward attention kernel once.  The recompute draws the
block's masks again from the generator set back to its state at the
block's forward, then leaves the generator where the forward left it, so
the masks, the gradients and the generator's state are those of the step
without checkpointing.

The int8 model (``quant=True``) swaps in ``QuantLinear`` for the block
GEMMs and, at widths that are multiples of 128 (the JAX gate),
``LayerNormQuant`` for norm1/norm2, in one of three modes: 'static'
(calibrated activation scales, the serving path: LayerNorm->int8 and
int8-storage attention kernels), 'dynamic' (per-row scales) and 'calib'
(dynamic, recording each activation site's absmax for
ops/quant.py:calibrate_act_amax).  Its weights come from
ops/quant.py:quantize_vit_params of an fp32 state dict and are never
initialised here.  Casts and bias adds follow the JAX modules: the qkv
GEMM's output is cast to the compute dtype before the q/v bias add; the
proj, fc1 and fc2 GEMMs add their fp32 bias in fp32; GELU runs on fc1's
fp32 output.

Static serving options (the JAX package's environment opt-ins, here
explicit arguments): ``fused_w8a8`` runs every static ``QuantLinear``
through the fused int8 GEMM kernel (ops/int8_gemm.py:w8a8_gemm, B4),
``fused_mlp`` the whole static MLP through w8a8_mlp where
``use_fused_mlp`` holds (else per-GEMM B4 with ``fused_w8a8``, else the
unfused GEMMs), and ``qkv_i8=False`` opts the attention out of int8
storage (ops/attention.py:static_attention_route: the bf16 attention with
the int8 output epilogue, B3, where the geometry allows).  Two more are the
JAX package's SIMPLE_TAD_INT8_ATTN and SIMPLE_TAD_ADD_LNQ: ``int8_attn``
routes the attention to the int8-compute kernel (E2,
ops/flash_attention.py:flash_attention_qkv_int8) where its gate holds, and
``add_lnq`` (models/vit.py) chains the blocks through
``Block.forward_carry``, whose residual adds run inside the next norm's
add + LayerNorm->int8 kernel (E1, ops/ln.py:add_layernorm_quant).  The
attention route follows the TPU program's geometry gates whatever the
options.  The fused kernels compute the unfused model's function (the same
codes, the same fp32 roundings, the same GELU form), and so does the carry,
bit for bit.

Tensor parallelism (``tp``, a parallel/tp.py:ModelParallel): ``Attention``
holds its rank's heads of qkv, q_bias and v_bias and the matching input
columns of proj (column- then row-parallel, by head, padded at the end to
a multiple of the model group), ``Mlp`` its contiguous block of fc1's rows
and fc2's columns; each runs Megatron's f before its first GEMM and g
after its last, whose bias it adds once, after the sum.  One forward
serves the whole model and a share: without ``tp`` f is the identity and
the row-parallel Linear is the Linear itself (parallel/tp.py), so the
whole model runs the ops it ran without tensor parallelism.  The norms,
LayerScale and DropPath stay replicated.  The attention kernels run at the
rank's head count; the attention dropout draws the whole model's keep
source (ops/attention.py).  The int8 model has no tensor-parallel form.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from simple_tad_tpu_torch.ops.attention import (
    dot_product_attention, dot_product_attention_qkv,
    dot_product_attention_qkv_i8, dot_product_attention_qkv_int8,
    static_attention_route)
from simple_tad_tpu_torch.ops.flash_attention import (AttentionResiduals,
                                                      flash_attention_qkv_q8)
from simple_tad_tpu_torch.ops.int8_gemm import (activation, gelu_act,
                                                use_fused_mlp, w8a8_gemm,
                                                w8a8_mlp)
from simple_tad_tpu_torch.ops.ln import (LayerNormFn, add_layernorm_quant,
                                         layernorm, layernorm_quant)
from simple_tad_tpu_torch.ops.quant import int8_matmul, int8_matmul_static
from simple_tad_tpu_torch.parallel import tp as tpar

QUANT_MODES = ("static", "dynamic", "calib")


def check_static_options(cfg) -> None:
    """The static serving options of a ViTConfig or IV2Config are options of
    the int8 model with calibrated scales: raise unless it is one (mode
    'calib' builds the calibration model of such a config).  ``add_lnq``
    and ``int8_attn`` exist on the ViTConfig only."""
    static = cfg.quant and cfg.quant_mode in ("static", "calib")
    for name, on in (("fused_w8a8", cfg.fused_w8a8),
                     ("fused_mlp", cfg.fused_mlp),
                     ("qkv_i8=False", not cfg.qkv_i8),
                     ("add_lnq", getattr(cfg, "add_lnq", False)),
                     ("int8_attn", getattr(cfg, "int8_attn", False))):
        if on and not static:
            raise ValueError(f"{name} is an option of the static int8 "
                             f"model (quant=True, quant_mode='static')")


def gelu_for(dtype):
    """Exact erf GELU at fp32; tanh approximation at bf16 (the JAX
    package's choice, layers.py:gelu_for)."""
    if dtype == torch.bfloat16:
        return lambda x: F.gelu(x, approximate="tanh")
    return F.gelu


def sincos_pos_embed(n_position: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table, float64 math then float32, shape
    (1, n_position, dim): angle(pos, j) = pos / 10000^(2*(j//2)/dim), even
    dims sin, odd dims cos."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(dim, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * np.floor(j / 2.0) / dim)
    table = np.empty((n_position, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def sincos_1d_mae(dim: int, positions: np.ndarray,
                  scale: float = None) -> np.ndarray:
    """MAE-style 1-D sincos, [sin block | cos block] (not interleaved):
    get_1d_sincos_pos_embed_from_grid of the MVD reference, float64."""
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    pos = positions.reshape(-1).astype(np.float64)
    if scale is not None:
        pos = pos * scale
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d_pos_embed(dim: int, grid_size: int, t_size: int,
                        scale_t: float = None) -> np.ndarray:
    """MVD's 3-D sincos table, (1, t * g * g, dim) float32 in (t, h, w)
    token order: a temporal block of dim / 4 columns, then the spatial
    3 * dim / 4, whose first half encodes the w coordinate and second half
    the h coordinate (get_3d_sincos_pos_embed of the MVD reference)."""
    if dim % 4:
        raise ValueError(f"the 3-D sincos table needs dim % 4 == 0, got "
                         f"{dim}")
    dim_sp, dim_t = dim // 4 * 3, dim // 4
    grid = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(grid, grid)          # w varies fastest
    spatial = np.concatenate([sincos_1d_mae(dim_sp // 2, grid_w),
                              sincos_1d_mae(dim_sp // 2, grid_h)], axis=1)
    temporal = sincos_1d_mae(dim_t, np.arange(t_size, dtype=np.float64),
                             scale=scale_t)
    temporal = np.repeat(temporal[:, None, :], grid_size ** 2, axis=1)
    spatial = np.repeat(spatial[None, :, :], t_size, axis=0)
    pos = np.concatenate([temporal, spatial], axis=-1)
    return pos.reshape(1, -1, dim).astype(np.float32)


def umt_pos_embed(num_patches: int, dim: int, cur_frames: int,
                  patch_size: int = 16) -> np.ndarray:
    """UMT's table, (1, num_patches, dim) float32: the 1-D sincos table
    generated at the checkpoint's geometry (8 frames of 14 x 14 patches,
    1568 rows; 2048 at patch 14), resized bicubically in space to the
    runtime grid, then linearly in time to ``cur_frames`` (the UMT
    reference's modeling_finetune.py:195-239)."""
    import torch.nn.functional as F
    pre_n = 2048 if patch_size == 14 else 1568
    table = sincos_pos_embed(pre_n, dim)
    if num_patches // cur_frames * 8 != pre_n and cur_frames != -1:
        T, P = 8, 14
        new_p = int((num_patches // cur_frames) ** 0.5)
        t = torch.from_numpy(table).reshape(-1, T, P, P, dim)
        t = t.reshape(-1, P, P, dim).permute(0, 3, 1, 2)
        t = F.interpolate(t, size=(new_p, new_p), mode="bicubic",
                          align_corners=False)
        t = t.permute(0, 2, 3, 1).reshape(-1, T, new_p, new_p, dim)
        table = t.flatten(1, 3).numpy()
    if cur_frames not in (-1, 8):
        T = 8
        P = int((num_patches // cur_frames) ** 0.5)
        t = torch.from_numpy(np.asarray(table)).reshape(-1, T, P, P, dim)
        t = t.permute(0, 2, 3, 4, 1).reshape(-1, dim, T)
        t = F.interpolate(t, size=cur_frames, mode="linear")
        t = t.reshape(1, P, P, dim, cur_frames).permute(0, 4, 1, 2, 3)
        table = t.flatten(1, 3).numpy()
    return np.asarray(table, np.float32)


def trunc_normal(shape, std: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """fp32 sample of std * N(0, 1) truncated to [-2, 2] (inverse CDF), on
    the generator's device (the CPU without one)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=None if generator is None else generator.device)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) * std).float()


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def drop_path(x, rate: float, training: bool, generator=None, mask=None):
    """Stochastic depth on a residual branch (port of the JAX package's
    layers.drop_path, timm semantics): per sample, keep with probability
    1 - rate and scale kept samples by 1 / (1 - rate).  ``mask`` (B,) bool
    replaces the draw (tests)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape[0], generator=generator,
                          device=x.device) < keep
    mask = mask.to(x.dtype).view((x.shape[0],) + (1,) * (x.ndim - 1))
    return x * mask / torch.tensor(keep, dtype=x.dtype, device=x.device)


def dropout(x, rate: float, training: bool, generator=None):
    """Element dropout (flax nn.Dropout semantics: kept values / (1 - rate),
    dropped values 0)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def checkpoint_block(block, x, generator=None, *, replay_draws=True):
    """``block(x, generator)`` under torch's non-reentrant checkpoint: the
    forward keeps ``x`` and the attention's (out, lse); the backward runs
    the block again with the generator set back to its state at the
    forward (``replay_draws``; False redraws every mask, a control that
    must fail) and the attention taken from the kept pair."""
    residuals = AttentionResiduals()
    start = (generator.get_state()
             if generator is not None and replay_draws else None)

    @contextlib.contextmanager
    def recompute():
        after = generator.get_state() if start is not None else None
        if start is not None:
            generator.set_state(start)
        try:
            with residuals.reusing():
                yield
        finally:
            if after is not None:
                generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(
        block, x, generator, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (residuals.saving(), recompute()))


def block_call(block, x, generator=None, remat: bool = False):
    """One block of a model's stack: checkpointed with ``remat`` in grad
    mode (``checkpoint_block``), plain otherwise."""
    if remat and torch.is_grad_enabled():
        return checkpoint_block(block, x, generator)
    return block(x, generator)


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        return drop_path(x, self.rate, self.training, generator)


class Linear(nn.Module):
    """y = x W^T + b with reference-named ``weight`` (out, in) and ``bias``,
    stored in ``param_dtype`` (default ``dtype``) and computed in
    ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.weight = _param((out_dim, in_dim), pdt, device)
        self.bias = _param((out_dim,), pdt, device) if bias else None

    def init_weights(self, generator, std: float = 0.02):
        with torch.no_grad():
            self.weight.copy_(trunc_normal(self.weight.shape, std, generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, bias: bool = True):
        """``bias`` False: the product alone (a row-parallel rank's share,
        whose bias parallel/tp.py:row_parallel_linear adds once after the
        sum)."""
        dt = self.dtype
        b = self.bias if bias else None
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if b is None else b.to(dt))


def observe(module, name: str, value) -> None:
    """Calibration: keep the running absmax of one activation site in
    ``module.observed`` (the JAX package's sow into its 'calib' collection
    with reduce_fn=maximum)."""
    prev = module.observed.get(name)
    module.observed[name] = value if prev is None \
        else torch.maximum(prev, value)


def absmax(x):
    return x.float().abs().amax()


class QuantLinear(nn.Module):
    """Int8-weight Linear, inference only (port of the JAX QuantDense):
    ``weight_q`` (out, in) int8, ``weight_scale`` (out,) fp32, fp32
    ``bias``; mode 'static' adds ``act_amax``, the calibrated absmax of the
    input.  Adds the bias in fp32, then applies ``act`` in fp32 (None,
    'gelu_tanh' or 'gelu_erf'), and returns ``out_dtype`` (fp32 by
    default).  ``fused`` (static only): the fused int8 GEMM kernel computes
    all of it."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 mode: str, fused: bool = False, device=None):
        super().__init__()
        self.mode = mode
        self.fused = fused and mode == "static"
        self.weight_q = _param((out_dim, in_dim), torch.int8, device)
        self.weight_scale = _param((out_dim,), torch.float32, device)
        self.bias = _param((out_dim,), torch.float32, device) if bias \
            else None
        if mode == "static":
            self.act_amax = _param((), torch.float32, device)
        self.observed = {}

    def forward(self, x, act=None, out_dtype=torch.float32):
        if self.fused:
            return w8a8_gemm(x, self.weight_q, self.weight_scale,
                             self.act_amax, self.bias, act, out_dtype)
        if self.mode == "static":
            y = int8_matmul_static(x, self.weight_q, self.weight_scale,
                                   self.act_amax)
        else:
            if self.mode == "calib":
                observe(self, "act_amax", absmax(x))
            y = int8_matmul(x, self.weight_q, self.weight_scale)
        if self.bias is not None:
            y = y + self.bias
        return activation(y, act).to(out_dtype)


class LayerNormFp32(nn.Module):
    """LayerNorm with fp32 statistics and fp32 ``weight``/``bias``; the
    output is cast to ``dtype``.  Routes through ops/ln.py: the kernel, or
    in grad mode ``LayerNormFn`` (the kernel forward, the JAX backward)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def init_weights(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad):
            return LayerNormFn.apply(x, self.weight, self.bias, self.eps,
                                     self.dtype)
        return layernorm(x, self.weight, self.bias, self.eps,
                         out_dtype=self.dtype)


class LayerNormQuant(LayerNormFp32):
    """norm1/norm2 of the int8 model (port of the JAX LayerNormQuant).
    'static': the LayerNorm->int8 kernel emits the next GEMM's int8 input
    against the calibrated ``act_amax``; 'calib': the LayerNorm, recording
    the absmax of its output after the cast to the compute dtype.  Given a
    ``residual`` (the deferred-residual carry), x is the branch and the
    result is (residual + x, the norm of that sum): in 'static' one add +
    LayerNorm->int8 kernel, in 'calib' the add, then the LayerNorm."""

    def __init__(self, dim: int, eps: float = 1e-6, *, mode: str,
                 dtype=torch.float32, device=None):
        super().__init__(dim, eps, dtype=dtype, device=device)
        self.mode = mode
        if mode == "static":
            self.act_amax = _param((), torch.float32, device)
        self.observed = {}

    def forward(self, x, residual=None):
        if self.mode == "static":
            if residual is not None:
                return add_layernorm_quant(x, residual, self.weight,
                                           self.bias, self.act_amax, self.eps)
            return layernorm_quant(x, self.weight, self.bias, self.act_amax,
                                   self.eps)
        if residual is not None:
            x = residual + x
        y = super().forward(x)
        observe(self, "act_amax", absmax(y))
        return y if residual is None else (x, y)


class Mlp(nn.Module):
    """fc1 -> GELU (erf at fp32, tanh at bf16) -> fc2 -> dropout ``drop``
    (training).  The static int8 MLP with ``fused_mlp`` is one w8a8_mlp
    kernel where ``use_fused_mlp`` holds; ``fused_w8a8`` makes each GEMM a
    w8a8_gemm kernel, fc1's carrying the GELU."""

    def __init__(self, dim: int, hidden_dim: int, *, dtype=torch.float32,
                 param_dtype=None, drop: float = 0.0, quant: bool = False,
                 quant_mode: str = "dynamic", fused_w8a8: bool = False,
                 fused_mlp: bool = False, tp=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.drop = drop
        self.quant = quant
        self.tp = tp
        if tp is not None:
            hidden_dim = tpar.local_hidden(hidden_dim, tp.size)
        self.fused_mlp = (quant and quant_mode == "static" and fused_mlp
                          and use_fused_mlp(dim, hidden_dim))
        if quant:
            self.fc1 = QuantLinear(dim, hidden_dim, mode=quant_mode,
                                   fused=fused_w8a8, device=device)
            self.fc2 = QuantLinear(hidden_dim, dim, mode=quant_mode,
                                   fused=fused_w8a8, device=device)
        else:
            self.fc1 = Linear(dim, hidden_dim, dtype=dtype,
                              param_dtype=param_dtype, device=device)
            self.fc2 = Linear(hidden_dim, dim, dtype=dtype,
                              param_dtype=param_dtype, device=device)
        self.act = gelu_for(dtype)

    def init_weights(self, generator):
        self.fc1.init_weights(generator)
        self.fc2.init_weights(generator)

    def forward(self, x, generator=None):
        if self.fused_mlp:
            f1, f2 = self.fc1, self.fc2
            return w8a8_mlp(x, f1.weight_q, f1.weight_scale, f1.act_amax,
                            f1.bias, f2.weight_q, f2.weight_scale,
                            f2.act_amax, f2.bias, gelu_act(self.dtype),
                            self.dtype)
        if self.quant:
            h = self.fc1(x, act=gelu_act(self.dtype))
            return self.fc2(h, out_dtype=self.dtype)
        h = self.act(self.fc1(tpar.copy_to_model(x, self.tp)))
        y = tpar.row_parallel_linear(h, self.fc2, self.tp, self.dtype)
        return dropout(y, self.drop, self.training, generator)


class Attention(nn.Module):
    """Packed-qkv multi-head attention: one bias-free ``qkv`` projection,
    then ``q_bias | 0 | v_bias`` added in the compute dtype, then
    ops/attention.py, then ``proj``.  Int8 mode 'static' routes as the TPU
    program (ops/attention.py:static_attention_route): qkv quantized per
    head against the calibrated ``qkv_amax`` (3, H) into the int8-storage
    kernel, or the bf16 attention with the int8 output epilogue, each
    emitting the proj GEMM's int8 input against ``out_amax``; or, with
    ``int8_attn``, the int8-compute attention on the same per-head codes;
    or the bf16 attention.  Those two emit bf16, which proj quantizes
    itself.  'calib' records both absmax sites around the bf16 attention.  In training the attention
    probabilities take dropout ``attn_drop`` in ``attn_dropout_form``."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 qk_scale=None, dtype=torch.float32, param_dtype=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 attn_dropout_form: str = "rng", quant: bool = False,
                 quant_mode: str = "dynamic", fused_w8a8: bool = False,
                 qkv_i8: bool = True, int8_attn: bool = False, tp=None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.tp = tp
        self.attn_drop = attn_drop
        self.attn_dropout_form = attn_dropout_form
        self.proj_drop = proj_drop
        self.quant = quant
        self.mode = quant_mode
        self.qkv_i8 = qkv_i8
        self.int8_attn = int8_attn
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim ** -0.5
        # under tensor parallelism: this rank's heads, from head_offset on
        # of total_heads (the dropout's keep source); without it all of them
        self.local_heads, self.head_offset, self.total_heads = (num_heads,
                                                                None, None)
        width = dim
        if tp is not None:
            self.local_heads = tpar.padded_heads(num_heads, tp.size) // tp.size
            self.head_offset = tp.rank * self.local_heads
            self.total_heads = num_heads
            width = self.local_heads * head_dim
        if quant:
            self.qkv = QuantLinear(dim, 3 * dim, bias=False, mode=quant_mode,
                                   fused=fused_w8a8, device=device)
            self.proj = QuantLinear(dim, dim, mode=quant_mode,
                                    fused=fused_w8a8, device=device)
            if quant_mode == "static":
                if qkv_i8 or int8_attn:
                    self.qkv_amax = _param((3, num_heads), torch.float32,
                                           device)
                self.out_amax = _param((), torch.float32, device)
            self.observed = {}
        else:
            self.qkv = Linear(dim, 3 * width, bias=False, dtype=dtype,
                              param_dtype=param_dtype, device=device)
            self.proj = Linear(width, dim, dtype=dtype,
                               param_dtype=param_dtype, device=device)
        if qkv_bias:
            self.q_bias = _param((width,), param_dtype or dtype, device)
            self.v_bias = _param((width,), param_dtype or dtype, device)
        else:
            self.q_bias = self.v_bias = None

    def init_weights(self, generator):
        self.qkv.init_weights(generator)
        self.proj.init_weights(generator)
        if self.q_bias is not None:
            with torch.no_grad():
                self.q_bias.zero_()
                self.v_bias.zero_()

    def forward(self, x, generator=None):
        qkv = self.qkv(x, out_dtype=self.dtype) if self.quant \
            else self.qkv(tpar.copy_to_model(x, self.tp)).to(self.dtype)
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(self.dtype)
        heads, scale = self.num_heads, self.scale
        if self.quant and self.mode == "static":
            B, N, C3 = qkv.shape
            route = static_attention_route(N, C3 // 3, heads, self.qkv_i8,
                                           self.int8_attn)
            if route == "int8":
                out = dot_product_attention_qkv_int8(
                    qkv, self.qkv_amax, num_heads=heads,
                    scale=scale).to(self.dtype)
            elif route == "i8":
                out = dot_product_attention_qkv_i8(
                    qkv, self.qkv_amax, self.out_amax, num_heads=heads,
                    scale=scale)
            elif route == "q8":
                out = flash_attention_qkv_q8(qkv, heads, scale, self.out_amax)
            else:
                C = C3 // 3
                out = dot_product_attention(
                    qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                    num_heads=heads, scale=scale)
        else:
            if self.quant and self.mode == "calib":
                B, N, _ = qkv.shape
                observe(self, "qkv_amax", qkv.float().abs().view(
                    B, N, 3, heads, -1).amax(dim=(0, 1, 4)))
            out = dot_product_attention_qkv(
                qkv, num_heads=self.local_heads, scale=scale,
                dropout_rate=self.attn_drop if self.training else 0.0,
                generator=generator, dropout_form=self.attn_dropout_form,
                head_offset=self.head_offset, total_heads=self.total_heads)
            if self.quant and self.mode == "calib":
                observe(self, "out_amax", absmax(out))
        y = self.proj(out, out_dtype=self.dtype) if self.quant \
            else tpar.row_parallel_linear(out, self.proj, self.tp, self.dtype)
        return dropout(y, self.proj_drop, self.training, generator)


class Block(nn.Module):
    """Pre-LN block with optional LayerScale and DropPath (identity at eval):
    x = x + DropPath(gamma_1 * Attn(LN1(x)));
    x = x + DropPath(gamma_2 * MLP(LN2(x))).
    ``forward_carry`` is the same block on the deferred-residual carry of
    the static int8 model with ``add_lnq`` (a separate method; ``forward``
    takes only the plain stream)."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale=None,
                 init_values: float = 0.0, norm_eps: float = 1e-6,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 attn_dropout_form: str = "rng",
                 drop_path: float = 0.0, dtype=torch.float32,
                 param_dtype=None, quant: bool = False,
                 quant_mode: str = "dynamic", fused_w8a8: bool = False,
                 fused_mlp: bool = False, qkv_i8: bool = True,
                 int8_attn: bool = False, tp=None, device=None):
        super().__init__()
        self.init_values = init_values
        self.dtype = dtype
        self.drop_path = DropPath(drop_path)
        if quant and quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant_mode!r}")
        if quant and quant_mode != "dynamic" and dim % 128 == 0:
            def norm():
                return LayerNormQuant(dim, norm_eps, mode=quant_mode,
                                      dtype=dtype, device=device)
        else:
            def norm():
                return LayerNormFp32(dim, norm_eps, dtype=dtype,
                                     device=device)
        self.norm1 = norm()
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, dtype=dtype,
                              param_dtype=param_dtype, attn_drop=attn_drop,
                              proj_drop=drop,
                              attn_dropout_form=attn_dropout_form,
                              quant=quant,
                              quant_mode=quant_mode, fused_w8a8=fused_w8a8,
                              qkv_i8=qkv_i8, int8_attn=int8_attn, tp=tp,
                              device=device)
        self.norm2 = norm()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       param_dtype=param_dtype, drop=drop, quant=quant,
                       quant_mode=quant_mode, fused_w8a8=fused_w8a8,
                       fused_mlp=fused_mlp, tp=tp, device=device)
        if init_values > 0:
            self.gamma_1 = _param((dim,), param_dtype or dtype, device)
            self.gamma_2 = _param((dim,), param_dtype or dtype, device)
        else:
            self.gamma_1 = self.gamma_2 = None

    def init_weights(self, generator):
        self.norm1.init_weights()
        self.norm2.init_weights()
        self.attn.init_weights(generator)
        self.mlp.init_weights(generator)
        if self.gamma_1 is not None:
            with torch.no_grad():
                self.gamma_1.fill_(self.init_values)
                self.gamma_2.fill_(self.init_values)

    def forward(self, x, generator=None):
        a = self.attn(self.norm1(x), generator)
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(self.dtype)
        x = x + self.drop_path(a, generator)
        m = self.mlp(self.norm2(x), generator)
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(self.dtype)
        return x + self.drop_path(m, generator)

    def forward_carry(self, stream, pending):
        """The block at eval on the deferred-residual carry (port of the JAX
        Block's tuple branch, SIMPLE_TAD_ADD_LNQ): ``pending`` is the
        previous block's un-added branch, added to ``stream`` inside norm1's
        add + LayerNorm->int8; -> (the stream after the attention residual,
        this block's un-added MLP branch).  Needs LayerNormQuant norms."""
        x0, q1 = self.norm1(pending, residual=stream)
        a = self.attn(q1)
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(self.dtype)
        x1, q2 = self.norm2(a, residual=x0)
        m = self.mlp(q2)
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(self.dtype)
        return x1, m


class PatchEmbed(nn.Module):
    """Tubelet patch embedding as a reshape plus one matmul.

    ``proj.weight`` keeps the reference Conv3d shape (D, C, t, p, p) and
    ``proj.bias`` (D,).  The conv has stride == kernel, so it is exactly a
    projection of non-overlapping (t, p, p) tubelets flattened in
    (t, h, w, c) order: ``matrix()`` is that (t*p*p*c, D) kernel.  Input is
    channels-last (B, T, H, W, C); tokens come out (t-slot, h, w)-ordered.
    """

    def __init__(self, embed_dim: int, patch_size: int = 16,
                 tubelet_size: int = 2, in_chans: int = 3, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.tubelet_size = tubelet_size
        self.dtype = dtype
        self.proj = nn.Module()
        self.proj.weight = _param(
            (embed_dim, in_chans, tubelet_size, patch_size, patch_size),
            param_dtype or dtype, device)
        self.proj.bias = _param((embed_dim,), torch.float32, device)

    def init_weights(self, generator):
        """lecun_normal over fan_in = t*p*p*c (flax's default init)."""
        w = self.proj.weight
        fan_in = w[0].numel()
        with torch.no_grad():
            w.copy_(trunc_normal(w.shape, 1.0 / math.sqrt(fan_in), generator)
                    / 0.87962566103423978)
            self.proj.bias.zero_()

    def matrix(self) -> torch.Tensor:
        """(t*p*p*c, D) kernel over (t, h, w, c)-ordered patch rows."""
        return patch_matrix(self.proj.weight)

    def forward(self, x):
        return embed_tubelets(x, self.matrix(), self.proj.bias,
                              self.patch_size, self.tubelet_size, self.dtype)


def patch_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d patch weight (D, C, t, p, p) -> (t*p*p*c, D) matmul kernel."""
    return weight.permute(2, 3, 4, 1, 0).reshape(-1, weight.shape[0])


def embed_tubelets(x, kernel, bias, patch: int, tubelet: int, dtype):
    """(B, T, H, W, C) -> (B, T/t * H/p * W/p, D): tubelets flattened in
    (t, h, w, c) order, times ``kernel`` (t*p*p*c, D).  Inputs and kernel
    are rounded to ``dtype`` and the product accumulates in fp32 (the
    products of bf16 values are exact in fp32), plus the fp32 bias, then
    one cast to ``dtype``."""
    B, T, H, W, C = x.shape
    p, tb = patch, tubelet
    nt, nh, nw = T // tb, H // p, W // p
    x = x.reshape(B, nt, tb, nh, p, nw, p, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = x.reshape(B, nt * nh * nw, tb * p * p * C).to(dtype)
    y = torch.matmul(x.float(), kernel.to(dtype).float()) + bias.float()
    return y.to(dtype)
