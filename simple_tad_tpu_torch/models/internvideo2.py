"""InternVideo2 single-modality video transformer (S/B/L/1B/6B), in PyTorch.

Port of simple_tad_tpu/models/internvideo2.py for serving (bf16 or fp32,
and static int8) and frame fine-tuning.  Differences from the VideoMAE
ViT: patch 14, tubelet 1, 8 frames; a CLS token; a learnable position
table (joint, or separate spatial/temporal/cls tables), loaded from
checkpoints; RMSNorm blocks with q/k RMS-normalisation over the whole
width C; LayerScale multiplied in fp32; an attention-pooling head
projecting to ``clip_embed_dim``, then ``fc_norm`` and the classifier.

Parameter names are the reference checkpoint's (the JAX package's
torch_to_iv2_params reads the same keys), so a reference ``.pth`` loads by
name: ``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1/norm2.weight``, ``attn.qkv.weight``,
``attn.q_norm/k_norm.weight``, ``attn.proj``, ``ls1/ls2.gamma``,
``mlp.fc1/fc2``, ``clip_projector.norm1_{q,k,v}``,
``clip_projector.cross_attn.{q,k,v}.weight``, ``q_bias``/``k_bias``/
``v_bias``, ``cross_attn.proj``, ``fc_norm``, ``head``.  Storage follows
models/layers.py: Linear weights and biases (and the pooling head's
projections) in the compute dtype, which the JAX package casts them to at
use; norms, LayerScale gammas, the position tables, the CLS token, the
patch-embed bias and the classifier in fp32.  ``param_dtype=torch.float32``
stores every parameter as an fp32 master, computed in ``dtype`` (the JAX
package's training setup), and the parameters require grad.

Kernels: the bf16/fp32 attention is ops/attention.py:dot_product_attention
on separate operands, v read in place from the qkv output (kernel A1 with a
stride pair per operand).  RMSNorm, the pooling head's LayerNorms and
attention and the GEMMs are plain PyTorch, as the JAX package leaves them
to XLA.  The int8 model (``quant=True``, its state from
ops/quant.py:quantize_iv2_params) runs the block GEMMs as
``QuantLinear`` and, in mode 'static', the int8-storage attention on
separate operands (kernel D2) against the calibrated per-head ``qkv_amax``
of the post-norm q/k and the raw v.  ``fused_rmsq=True`` (the JAX
package's SIMPLE_TAD_FUSED_RMSQ opt-in, here an explicit argument) makes
norm1/norm2 and the q/k-norms emit int8 through the RMSNorm->int8 kernel
(D3); their absmax is calibrated in the norm scopes.  The static model's
other serving options are the ViT's (models/layers.py): ``fused_w8a8`` and
``fused_mlp`` (the fused int8 GEMM kernels, B4), and ``qkv_i8=False``,
which takes the bf16 attention on separate operands with the int8 output
epilogue (B3) instead of int8 storage; the attention route follows the
TPU program's geometry gates (ops/attention.py:
static_attention_sep_route), and with ``qkv_i8=False`` the q/k-norms stay
bf16, as in the JAX package.

Training (the JAX model's ``deterministic=False``): in ``train()`` mode,
with fp32 masters, the attention is the separate-operand training attention
(kernels C3: forward with lse, backward; ops/flash_attention.py), stochastic
depth runs on both residual branches after LayerScale with rates
``linspace(0, drop_path_rate, depth)``, and dropout ``fc_drop_rate`` on the
pooled features before the head, their masks drawn from the ``generator``
given to ``forward``.  RMSNorm, LayerScale and the pooling head train
through plain PyTorch autograd, as the JAX package leaves them to XLA.
Gradient checkpointing (``remat``) runs each block through
models/layers.py:block_call.

The JAX package's model-level sequence pad (``attn_seq_pad``) is not
ported: it exists to save per-layer copies on the TPU, the port's kernels
mask keys by index, and the unpadded program computes the same valid rows.

Tensor parallelism (``tp``, parallel/tp.py): ``IV2Attention`` holds its
rank's heads (padded at the end to a multiple of the model group: IV2-6B's
25 heads as 26 or 28) of qkv, of the q/k-norm weights and of proj's input,
``Mlp`` its block of fc1 / fc2 (models/layers.py); the q/k-norms run
parallel/tp.py:qk_rmsnorm, the RMSNorm over the whole width with its
sums of squares summed over the model group.  The int8 model has no
tensor-parallel form.

Distillation surfaces (cli/distill.py): ``features_only`` returns the
fc_norm'd pooled features, and ``return_taps`` the stage-2 teacher's
l2-normalized block outputs, pooled feature and pooling attention.  The
masked distillation student is models/iv2_distill.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from simple_tad_tpu_torch.models.layers import (QUANT_MODES, Linear, Mlp,
                                                PatchEmbed, QuantLinear,
                                                _param, absmax, block_call,
                                                check_static_options,
                                                drop_path, dropout, observe,
                                                trunc_normal)
from simple_tad_tpu_torch.ops.attention import (dot_product_attention,
                                                dot_product_attention_i8_sep,
                                                static_attention_sep_route)
from simple_tad_tpu_torch.ops.flash_attention import flash_attention_q8
from simple_tad_tpu_torch.ops.ln import (layernorm_plain, quant_scale,
                                         rmsnorm_quant)
from simple_tad_tpu_torch.parallel import tp as tpar


def sincos_1d_mae(dim: int, positions: np.ndarray) -> np.ndarray:
    """MAE-style 1D sincos, [sin block | cos block], float64."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                            / (dim / 2.0))
    out = np.einsum("m,d->md", positions.reshape(-1).astype(np.float64),
                    omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d_pos_embed(dim: int, grid_size: int, t_size: int) -> np.ndarray:
    """3D sincos table, temporal dim/4 + spatial 3*dim/4 (w half first),
    tokens in (t, h, w) order -> (1, t*g*g, dim) float32."""
    dim_sp, dim_t = dim // 4 * 3, dim // 4
    g = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(g, g)
    spatial = np.concatenate([sincos_1d_mae(dim_sp // 2, grid_w),
                              sincos_1d_mae(dim_sp // 2, grid_h)], axis=1)
    temporal = sincos_1d_mae(dim_t, np.arange(t_size, dtype=np.float64))
    pos = np.concatenate(
        [np.repeat(temporal[:, None, :], grid_size ** 2, axis=1),
         np.repeat(spatial[None, :, :], t_size, axis=0)], axis=-1)
    return pos.reshape(1, -1, dim).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class IV2Config:
    """The fields of simple_tad_tpu/models/internvideo2.py:IV2Config (its
    defaults are IV2-1B's, drop path 0.25 included; the fine-tuning CLI
    passes its ``--drop_path``), plus ``fused_rmsq`` and ``param_dtype``."""
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    num_classes: int = 2
    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11
    qkv_bias: bool = False
    init_values: float = 1e-5
    qk_normalization: bool = True
    attn_pool_num_heads: int = 16
    clip_embed_dim: int = 768
    num_frames: int = 8
    tubelet_size: int = 1
    sep_pos_embed: bool = False
    drop_path_rate: float = 0.25
    fc_drop_rate: float = 0.0
    init_scale: float = 0.001
    # int8 GEMM inference (ops/quant.py): 'static', 'dynamic' or 'calib';
    # fused_rmsq: norm1/norm2 and the q/k-norms emit int8 (static/calib)
    quant: bool = False
    quant_mode: str = "dynamic"
    fused_rmsq: bool = False
    # static int8 serving options of models/layers.py
    fused_w8a8: bool = False
    fused_mlp: bool = False
    qkv_i8: bool = True
    dtype: torch.dtype = torch.float32
    # parameter storage: None keeps each parameter in the dtype the JAX
    # package computes it in (inference); torch.float32 gives fp32 training
    # masters
    param_dtype: Optional[torch.dtype] = None
    remat: bool = False

    @property
    def grid_size(self):
        return (self.num_frames // self.tubelet_size,
                self.img_size // self.patch_size,
                self.img_size // self.patch_size)

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid_size
        return t * h * w

    @property
    def all_frames(self) -> int:
        """Frames per window (the ViT config's name, for shared callers)."""
        return self.num_frames


def _vector(dim, device):
    return _param((dim,), torch.float32, device)


def l2_normalize(x):
    """x / max(||x||, 1e-6) over the last axis, in fp32."""
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-6)


def rmsnorm_plain(x, weight, eps: float, dtype):
    """fp32 RMSNorm (no mean, no bias), weight times the normalised value,
    cast to ``dtype``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (weight.float() * (x32 * torch.rsqrt(var + eps))).to(dtype)


class RMSNorm(nn.Module):
    """fp32-statistics RMSNorm with an fp32 ``weight``; the output is cast to
    ``dtype``.  Given ``quant_inv`` (C,) (127 / amax per channel), it emits
    int8 codes through the RMSNorm->int8 kernel instead."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _vector(dim, device)

    def init_weights(self):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x, quant_inv=None):
        if quant_inv is not None:
            return rmsnorm_quant(x.contiguous(), self.weight, quant_inv,
                                 self.eps)
        return rmsnorm_plain(x, self.weight, self.eps, self.dtype)


class RMSNormQuant(RMSNorm):
    """norm1/norm2 of the int8 model with ``fused_rmsq`` (port of the JAX
    RMSNormQuant): 'static' emits the next GEMM's int8 input against the
    calibrated ``act_amax``; 'calib' runs the RMSNorm and records the
    absmax of its output after the cast to the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, mode: str,
                 dtype=torch.float32, device=None):
        super().__init__(dim, eps, dtype=dtype, device=device)
        self.mode = mode
        if mode == "static":
            self.act_amax = _param((), torch.float32, device)
        self.observed = {}

    def forward(self, x, quant_inv=None):
        if self.mode == "static":
            inv = quant_scale(self.act_amax).expand(x.shape[-1])
            return super().forward(x, inv)
        y = super().forward(x)
        observe(self, "act_amax", absmax(y))
        return y


class LayerNormEps(nn.Module):
    """LayerNorm with fp32 statistics, fp32 ``weight``/``bias`` and eps 1e-5
    (the pooling head's norms and ``fc_norm``), in plain PyTorch as the JAX
    package leaves it to XLA."""

    def __init__(self, dim: int, eps: float = 1e-5, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _vector(dim, device)
        self.bias = _vector(dim, device)

    def init_weights(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layernorm_plain(x, self.weight, self.bias, self.eps,
                               self.dtype)


class IV2Attention(nn.Module):
    """Bias-free qkv projection, RMS q/k-norms over the whole width C, then
    attention on separate operands (v a strided view of the projection
    output), then ``proj``."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = False,
                 qk_normalization: bool = True, dtype=torch.float32,
                 param_dtype=None, quant: bool = False,
                 quant_mode: str = "dynamic", fused_rmsq: bool = False,
                 fused_w8a8: bool = False, qkv_i8: bool = True, tp=None,
                 device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.quant = quant
        self.mode = quant_mode
        self.fused_rmsq = fused_rmsq
        self.qkv_i8 = qkv_i8
        self.scale = (dim // num_heads) ** -0.5
        self.tp = tp
        # this rank's heads and columns (all of them without tp)
        self.local_heads, self.width = num_heads, dim
        if tp is not None:
            self.local_heads = tpar.padded_heads(num_heads, tp.size) // tp.size
            self.width = self.local_heads * (dim // num_heads)
        if quant:
            self.qkv = QuantLinear(dim, 3 * dim, bias=qkv_bias,
                                   mode=quant_mode, fused=fused_w8a8,
                                   device=device)
            self.proj = QuantLinear(dim, dim, mode=quant_mode,
                                    fused=fused_w8a8, device=device)
            if quant_mode == "static":
                if qkv_i8:
                    self.qkv_amax = _param((3, num_heads), torch.float32,
                                           device)
                self.out_amax = _param((), torch.float32, device)
            self.observed = {}
        else:
            w = self.width
            self.qkv = Linear(dim, 3 * w, bias=qkv_bias, dtype=dtype,
                              param_dtype=param_dtype, device=device)
            self.proj = Linear(w, dim, dtype=dtype, param_dtype=param_dtype,
                               device=device)
        if qk_normalization:
            self.q_norm = RMSNorm(self.width, dtype=dtype, device=device)
            self.k_norm = RMSNorm(self.width, dtype=dtype, device=device)
        else:
            self.q_norm = self.k_norm = None

    def init_weights(self, generator):
        self.qkv.init_weights(generator)
        self.proj.init_weights(generator)
        if self.q_norm is not None:
            self.q_norm.init_weights()
            self.k_norm.init_weights()

    def forward(self, x):
        C, H = self.width, self.local_heads
        static = self.quant and self.mode == "static"
        route = static_attention_sep_route(x.shape[1], C, H, self.qkv_i8) \
            if static else None
        qkv = self.qkv(x, out_dtype=self.dtype) if self.quant \
            else self.qkv(tpar.copy_to_model(x, self.tp)).to(self.dtype)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        if self.q_norm is not None:
            qi = ki = None
            if route == "i8" and self.fused_rmsq:
                inv = quant_scale(self.qkv_amax).repeat_interleave(C // H,
                                                                  dim=1)
                qi, ki = inv[0], inv[1]
            q = self._qk_norm(self.q_norm, q, qi)
            k = self._qk_norm(self.k_norm, k, ki)
        if route == "i8":
            out = dot_product_attention_i8_sep(
                q, k, v, self.qkv_amax, self.out_amax, num_heads=H,
                scale=self.scale)
        elif route == "q8":
            out = flash_attention_q8(q, k, v, H, self.scale, self.out_amax)
        else:
            if self.quant and self.mode == "calib":
                observe(self, "qkv_amax", torch.stack([
                    t.float().abs().reshape(*t.shape[:2], H, -1).amax(
                        dim=(0, 1, 3)) for t in (q, k, v)]))
            out = dot_product_attention(q, k, v, num_heads=H,
                                        scale=self.scale)
            if self.quant and self.mode == "calib":
                observe(self, "out_amax", absmax(out))
        if self.quant:
            return self.proj(out, out_dtype=self.dtype)
        return tpar.row_parallel_linear(out, self.proj, self.tp, self.dtype)

    def _qk_norm(self, norm, t, quant_inv):
        """The q or k RMSNorm; under tensor parallelism over the whole width
        from this rank's columns (parallel/tp.py:qk_rmsnorm)."""
        if self.tp is None:
            return norm(t, quant_inv)
        return tpar.qk_rmsnorm(t, norm.weight, norm.eps, self.dtype,
                               self.dim, self.tp)


class LayerScale(nn.Module):
    """h * gamma in fp32, cast back to ``dtype``."""

    def __init__(self, dim: int, init_values: float, *, dtype, device=None):
        super().__init__()
        self.init_values = init_values
        self.dtype = dtype
        self.gamma = _vector(dim, device)

    def init_weights(self):
        with torch.no_grad():
            self.gamma.fill_(self.init_values)

    def forward(self, h):
        return (h.float() * self.gamma).to(self.dtype)


class IV2Block(nn.Module):
    """x += dp(ls1(attn(norm1(x)))); x += dp(ls2(mlp(norm2(x)))), dp the
    stochastic depth at ``drop_path_rate`` (identity at eval)."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, init_values: float = 1e-5,
                 qk_normalization: bool = True, drop_path_rate: float = 0.0,
                 dtype=torch.float32, param_dtype=None, quant: bool = False,
                 quant_mode: str = "dynamic", fused_rmsq: bool = False,
                 fused_w8a8: bool = False, fused_mlp: bool = False,
                 qkv_i8: bool = True, tp=None, device=None):
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        if quant and quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant_mode!r}")
        fused = quant and fused_rmsq and quant_mode in ("static", "calib")

        def norm():
            if fused:
                return RMSNormQuant(dim, mode=quant_mode, dtype=dtype,
                                    device=device)
            return RMSNorm(dim, dtype=dtype, device=device)

        self.norm1 = norm()
        self.attn = IV2Attention(dim, num_heads, qkv_bias=qkv_bias,
                                 qk_normalization=qk_normalization,
                                 dtype=dtype, param_dtype=param_dtype,
                                 quant=quant, quant_mode=quant_mode,
                                 fused_rmsq=fused_rmsq, fused_w8a8=fused_w8a8,
                                 qkv_i8=qkv_i8, tp=tp, device=device)
        self.ls1 = LayerScale(dim, init_values, dtype=dtype, device=device)
        self.norm2 = norm()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       param_dtype=param_dtype, quant=quant,
                       quant_mode=quant_mode, fused_w8a8=fused_w8a8,
                       fused_mlp=fused_mlp, tp=tp, device=device)
        self.ls2 = LayerScale(dim, init_values, dtype=dtype, device=device)

    def init_weights(self, generator):
        for m in (self.norm1, self.norm2, self.ls1, self.ls2):
            m.init_weights()
        self.attn.init_weights(generator)
        self.mlp.init_weights(generator)

    def forward(self, x, generator=None):
        rate, training = self.drop_path_rate, self.training
        h = self.ls1(self.attn(self.norm1(x)))
        x = x + drop_path(h, rate, training, generator)
        h = self.ls2(self.mlp(self.norm2(x)))
        return x + drop_path(h, rate, training, generator)


class CrossAttention(nn.Module):
    """The pooling head's projections: bias-free ``q``/``k``/``v`` weights
    with standalone ``q_bias``/``k_bias``/``v_bias``, and ``proj``."""

    def __init__(self, dim: int, out_dim: int, *, dtype, param_dtype=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        for name in ("q", "k", "v"):
            setattr(self, name, Linear(dim, dim, bias=False, dtype=dtype,
                                       param_dtype=param_dtype,
                                       device=device))
            setattr(self, f"{name}_bias",
                    _param((dim,), param_dtype or dtype, device))
        self.proj = Linear(dim, out_dim, dtype=dtype, param_dtype=param_dtype,
                           device=device)

    def init_weights(self, generator):
        for name in ("q", "k", "v"):
            getattr(self, name).init_weights(generator)
            with torch.no_grad():
                getattr(self, f"{name}_bias").zero_()
        self.proj.init_weights(generator)

    def project(self, name, h):
        """h W^T rounded to the compute dtype, then the bias in it (the JAX
        head's jnp.dot(preferred_element_type=dtype) + bias)."""
        return getattr(self, name)(h) + getattr(self, f"{name}_bias").to(
            self.dtype)


class AttentionPooling(nn.Module):
    """Mean-query cross-attention over all tokens -> (B, out_dim), in plain
    PyTorch with the JAX head's dtypes: logits fp32, softmax fp32 cast to the
    compute dtype, the weighted sum accumulated in fp32 and cast."""

    def __init__(self, dim: int, num_heads: int, out_dim: int, *, dtype,
                 param_dtype=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1_q = LayerNormEps(dim, dtype=dtype, device=device)
        self.norm1_k = LayerNormEps(dim, dtype=dtype, device=device)
        self.norm1_v = LayerNormEps(dim, dtype=dtype, device=device)
        self.cross_attn = CrossAttention(dim, out_dim, dtype=dtype,
                                         param_dtype=param_dtype,
                                         device=device)

    def init_weights(self, generator):
        for m in (self.norm1_q, self.norm1_k, self.norm1_v):
            m.init_weights()
        self.cross_attn.init_weights(generator)

    def forward(self, x, return_attn: bool = False):
        """x (B, N, C) -> (B, out_dim); with ``return_attn`` also the
        pooling attention averaged over heads (B, N) fp32 (the importance
        of the distillation teacher's 'attention' mask)."""
        B, N, C = x.shape
        H = self.num_heads
        ca = self.cross_attn
        q = ca.project("q", self.norm1_q(x.mean(dim=1, keepdim=True)))
        k = ca.project("k", self.norm1_k(x))
        v = ca.project("v", self.norm1_v(x))
        q = q.view(B, 1, H, -1) * (C // H) ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.view(B, N, H, -1).float())
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                           v.view(B, N, H, -1).float()).to(self.dtype)
        out = ca.proj(out.reshape(B, C))
        if return_attn:
            return out, probs.float().mean(dim=1)[:, 0]
        return out


class InternVideo2(nn.Module):
    def __init__(self, cfg: IV2Config, *, device, tp=None):
        super().__init__()
        if tp is not None and cfg.quant:
            raise ValueError("the int8 model has no tensor-parallel form")
        self.tp = tp
        if cfg.quant and cfg.quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {cfg.quant_mode!r}")
        if cfg.fused_rmsq and not (cfg.quant
                                   and cfg.quant_mode in ("static", "calib")):
            raise ValueError("fused_rmsq is an option of the static int8 "
                             "model (and its calibration twin)")
        if cfg.quant and cfg.param_dtype is not None:
            raise ValueError("the int8 model is inference only")
        check_static_options(cfg)
        self.cfg = cfg
        dt, pdt, D = cfg.dtype, cfg.param_dtype, cfg.embed_dim
        nt, nh, nw = cfg.grid_size
        self.patch_embed = PatchEmbed(D, cfg.patch_size, cfg.tubelet_size,
                                      cfg.in_chans, dtype=dt, param_dtype=pdt,
                                      device=device)
        self.cls_token = _param((1, 1, D), torch.float32, device)
        if cfg.sep_pos_embed:
            self.pos_embed_spatial = _param((1, nh * nw, D), torch.float32,
                                            device)
            self.pos_embed_temporal = _param((1, nt, D), torch.float32,
                                             device)
            self.pos_embed_cls = _param((1, 1, D), torch.float32, device)
        else:
            self.pos_embed = _param((1, cfg.num_patches + 1, D),
                                    torch.float32, device)
        self.blocks = nn.ModuleList(
            IV2Block(D, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                     qkv_bias=cfg.qkv_bias, init_values=cfg.init_values,
                     qk_normalization=cfg.qk_normalization,
                     drop_path_rate=float(rate), dtype=dt, param_dtype=pdt,
                     quant=cfg.quant, quant_mode=cfg.quant_mode,
                     fused_rmsq=cfg.fused_rmsq, fused_w8a8=cfg.fused_w8a8,
                     fused_mlp=cfg.fused_mlp, qkv_i8=cfg.qkv_i8, tp=tp,
                     device=device)
            for rate in np.linspace(0.0, cfg.drop_path_rate, cfg.depth))
        self.clip_projector = AttentionPooling(
            D, cfg.attn_pool_num_heads, cfg.clip_embed_dim, dtype=dt,
            param_dtype=pdt, device=device)
        self.fc_norm = LayerNormEps(cfg.clip_embed_dim, dtype=dt,
                                    device=device)
        self.head = (Linear(cfg.clip_embed_dim, cfg.num_classes,
                            device=device) if cfg.num_classes > 0 else None)
        self.requires_grad_(pdt is not None)

    def init_weights(self, generator: torch.Generator) -> "InternVideo2":
        """Fill every parameter from ``generator`` with the JAX package's
        initialisers: trunc-normal 0.02 projections and CLS token,
        lecun-normal patch kernel, unit norms, LayerScale ``init_values``,
        the sincos position tables, head std 0.02 * init_scale."""
        cfg = self.cfg
        if cfg.quant:
            raise ValueError(
                "the int8 model is not initialised: its state comes from "
                "ops/quant.py:quantize_iv2_params of an fp32 state dict")
        if self.tp is not None:
            raise ValueError("a tensor-parallel model takes its share of the "
                             "whole model's weights: parallel/tp.py:"
                             "init_sharded")
        nt, nh, _ = cfg.grid_size
        D = cfg.embed_dim
        self.patch_embed.init_weights(generator)
        with torch.no_grad():
            self.cls_token.copy_(trunc_normal((1, 1, D), 0.02, generator))
            if cfg.sep_pos_embed:
                g = np.arange(nh, dtype=np.float64)
                gw, gh = np.meshgrid(g, g)
                sp = np.concatenate([sincos_1d_mae(D // 2, gw),
                                     sincos_1d_mae(D // 2, gh)], axis=1)
                tp = sincos_1d_mae(D, np.arange(nt, dtype=np.float64))
                self.pos_embed_spatial.copy_(torch.from_numpy(sp[None]))
                self.pos_embed_temporal.copy_(torch.from_numpy(tp[None]))
                self.pos_embed_cls.zero_()
            else:
                table = np.concatenate([np.zeros((1, 1, D), np.float32),
                                        sincos_3d_pos_embed(D, nh, nt)], 1)
                self.pos_embed.copy_(torch.from_numpy(table))
        for blk in self.blocks:
            blk.init_weights(generator)
        self.clip_projector.init_weights(generator)
        self.fc_norm.init_weights()
        if self.head is not None:
            std = 0.02 * cfg.init_scale if cfg.init_scale > 0 else 0.02
            self.head.init_weights(generator, std)
        return self

    def position_table(self):
        """(1, num_patches + 1, D) fp32, the CLS row first."""
        if not self.cfg.sep_pos_embed:
            return self.pos_embed
        nt = self.cfg.grid_size[0]
        sp = self.pos_embed_spatial
        pos = (sp.repeat(1, nt, 1)
               + self.pos_embed_temporal.repeat_interleave(sp.shape[1],
                                                           dim=1))
        return torch.cat([self.pos_embed_cls, pos], dim=1)

    def forward(self, x, *, tokens_input: bool = False, generator=None,
                features_only: bool = False, return_taps=()):
        """x: (B, T, H, W, C) normalized video -> (B, num_classes) fp32
        logits; with ``tokens_input``, x is (B, num_patches, D) tokens (the
        CLS token and the position table are added here).  ``generator``:
        the source of the training-mode stochastic-depth and head-dropout
        masks (on x's device).

        ``features_only``: the fc_norm'd pooled features (B,
        clip_embed_dim) instead of the logits (the feature-distillation
        surface).  ``return_taps`` (block indices): the stage-2
        distillation teacher's surface (internvideo2_teacher.py:523-588)
        -> (the block outputs at the indices in ascending order,
        l2-normalized, (K, B, N + 1, D) fp32; the pooled feature
        l2-normalized, without fc_norm, (B, clip_embed_dim) fp32; the
        pooling attention averaged over heads at the non-CLS tokens (B, N)
        fp32)."""
        dt = self.cfg.dtype
        tokens = x.to(dt) if tokens_input else self.patch_embed(x)
        cls = self.cls_token.to(dt).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.position_table().to(dt)
        wanted = sorted(return_taps)
        outs = {}
        for i, blk in enumerate(self.blocks):
            tokens = block_call(blk, tokens, generator, self.cfg.remat)
            if i in wanted:
                outs[i] = tokens
        if wanted:
            final, attn = self.clip_projector(tokens, return_attn=True)
            taps = l2_normalize(torch.stack([outs[i] for i in wanted]))
            return taps, l2_normalize(final), attn[:, 1:]
        feats = self.fc_norm(self.clip_projector(tokens))
        if self.head is None or features_only:
            return feats
        feats = dropout(feats, self.cfg.fc_drop_rate, self.training,
                        generator)
        return self.head(feats.float())
