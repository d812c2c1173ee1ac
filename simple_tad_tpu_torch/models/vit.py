"""VideoMAE-style video Vision Transformer, in PyTorch.

Port of simple_tad_tpu/models/vit.py:VisionTransformer.  Input is
channels-last video (B, T, H, W, C), or pre-embedded tokens
(B, num_patches, D) with ``tokens_input=True``; the position table and
the CLS token are added inside the model in both cases.  The position
table is ``pos_embed_kind`` 'sincos' (VideoMAE, the main path), '3d'
(MVD's temporal + spatial sincos) or 'umt' (UMT's checkpoint-geometry
table, interpolated), a non-persistent buffer that is regenerated, never
loaded; or, with ``use_learnable_pos_emb``, the parameter ``pos_embed``.
``use_cls_token`` prepends the parameter ``cls_token`` after the position
add (it gets no position) and leaves it out of the fc_norm mean pool
(MVD).  The head runs in fp32.  ``quant=True`` builds the int8 model
(models/layers.py, ops/quant.py) in ``quant_mode`` 'static', 'dynamic' or
'calib'; its state comes from ops/quant.py and is never initialised.  The
static model's serving options ``fused_w8a8``, ``fused_mlp``, ``qkv_i8``,
``int8_attn`` and ``add_lnq`` (models/layers.py) default to the JAX
package's program and raise on any other model.  ``add_lnq`` is the JAX
package's deferred-residual carry (SIMPLE_TAD_ADD_LNQ, its scanned
VisionTransformer._blocks): where the blocks' norms are LayerNorm->int8
(embed_dim % 128 == 0) and the model is at eval, each block hands its
un-added MLP branch to the next (``Block.forward_carry``), block 0 starts
from a zero branch, and the last branch is added before the fc_norm
pooling; 24 add + LayerNorm->int8 launches (E1) replace ViT-B's 24
LayerNorm->int8 ones, with the same logits bit for bit.  ``int8_attn`` is
SIMPLE_TAD_INT8_ATTN: the int8-compute attention (E2).

Training: ``param_dtype=torch.float32`` builds fp32 masters computed in
``dtype`` (the JAX package's training setup), and their parameters
require grad.  In ``train()`` mode the model applies the position and
head dropout (``drop_rate``, ``fc_drop_rate``), the blocks' proj/MLP
dropout (``drop_rate``) and stochastic depth spread as
``linspace(0, drop_path_rate, depth)`` over the blocks, drawing from the
``generator`` given to ``forward``, and the attention dropout
(``attn_drop_rate``, kernels C4) in ``attn_dropout_form``: 'rng' (the TPU
program's default: the kernels draw Philox bits from a seed) or 'mask' (an
int8 keep mask drawn beside them; the JAX package's
SIMPLE_TAD_DROPOUT_MASK).  Gradient checkpointing (``remat``) runs each
block through models/layers.py:block_call.

Tensor parallelism: ``tp`` (a parallel/tp.py:ModelParallel) builds this
rank's share of the blocks (models/layers.py); the rest of the model is
replicated.  A seeded tensor-parallel model is filled through
parallel/tp.py:init_sharded (models/__init__.py:create_model does), with
the whole model's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from simple_tad_tpu_torch.models.layers import (Block, LayerNormFp32, Linear,
                                                PatchEmbed, _param,
                                                block_call,
                                                check_static_options, dropout,
                                                sincos_3d_pos_embed,
                                                sincos_pos_embed,
                                                trunc_normal, umt_pos_embed)
from simple_tad_tpu_torch.ops.attention import DROPOUT_FORMS

POS_EMBED_KINDS = ("sincos", "3d", "umt")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The reference constructor arguments the inference trunk uses
    (simple_tad_tpu/models/vit.py:ViTConfig)."""
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 2
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    fc_drop_rate: float = 0.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    # the attention dropout's keep source: 'rng' (Philox bits drawn inside
    # the kernels from a seed) or 'mask' (an int8 keep mask in memory)
    attn_dropout_form: str = "rng"
    drop_path_rate: float = 0.0
    init_values: float = 0.0
    init_scale: float = 0.001
    all_frames: int = 16
    tubelet_size: int = 2
    final_reduction: str = "fc_norm"   # fc_norm | cls | none
    dtype: torch.dtype = torch.float32
    pos_embed_kind: str = "sincos"
    use_cls_token: bool = False
    use_learnable_pos_emb: bool = False
    # int8 GEMM inference (ops/quant.py): 'static' calibrated activation
    # scales, 'dynamic' per-row scales, 'calib' records the absmax sites
    quant: bool = False
    quant_mode: str = "dynamic"
    # static int8 serving: the fused int8 GEMM kernels per GEMM and for the
    # whole MLP; qkv_i8=False opts the attention out of int8 storage
    fused_w8a8: bool = False
    fused_mlp: bool = False
    qkv_i8: bool = True
    # static int8 serving: int8_attn computes the attention in int8 (E2)
    # where its gate holds; add_lnq runs each residual add inside the next
    # norm's LayerNorm->int8 kernel (E1)
    int8_attn: bool = False
    add_lnq: bool = False
    # parameter storage: None keeps each parameter in the dtype the JAX
    # package computes it in (inference); torch.float32 gives fp32 training
    # masters
    param_dtype: Optional[torch.dtype] = None
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return ((self.img_size // self.patch_size) ** 2
                * (self.all_frames // self.tubelet_size))


def fixed_pos_embed(cfg) -> np.ndarray:
    """The fixed (1, num_patches, embed_dim) float32 position table of
    ``cfg.pos_embed_kind``."""
    if cfg.pos_embed_kind == "3d":
        return sincos_3d_pos_embed(cfg.embed_dim,
                                   cfg.img_size // cfg.patch_size,
                                   cfg.all_frames // cfg.tubelet_size)
    if cfg.pos_embed_kind == "umt":
        return umt_pos_embed(cfg.num_patches, cfg.embed_dim,
                             cfg.all_frames // cfg.tubelet_size,
                             cfg.patch_size)
    return sincos_pos_embed(cfg.num_patches, cfg.embed_dim)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device, tp=None):
        super().__init__()
        if tp is not None and cfg.quant:
            raise ValueError("the int8 model has no tensor-parallel form")
        self.tp = tp
        if cfg.pos_embed_kind not in POS_EMBED_KINDS:
            raise ValueError(f"unknown pos_embed_kind {cfg.pos_embed_kind!r}"
                             f"; expected one of {POS_EMBED_KINDS}")
        if cfg.final_reduction not in ("fc_norm", "cls", "none"):
            raise ValueError(f"unknown final_reduction {cfg.final_reduction!r}")
        if cfg.attn_dropout_form not in DROPOUT_FORMS:
            raise ValueError(f"unknown attn_dropout_form "
                             f"{cfg.attn_dropout_form!r}; expected one of "
                             f"{DROPOUT_FORMS}")
        if cfg.quant and cfg.param_dtype is not None:
            raise ValueError("the int8 model is inference only")
        check_static_options(cfg)
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size,
                                      cfg.tubelet_size, cfg.in_chans,
                                      dtype=dt, param_dtype=pdt,
                                      device=device)
        if cfg.use_learnable_pos_emb:
            self.pos_embed = _param((1, cfg.num_patches, cfg.embed_dim),
                                    pdt or dt, device)
        else:
            self.register_buffer(
                "pos_embed", torch.from_numpy(fixed_pos_embed(cfg)).to(
                    device=device, dtype=dt), persistent=False)
        self.cls_token = (_param((1, 1, cfg.embed_dim), pdt or dt, device)
                          if cfg.use_cls_token else None)
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
                  init_values=cfg.init_values, drop=cfg.drop_rate,
                  attn_drop=cfg.attn_drop_rate,
                  attn_dropout_form=cfg.attn_dropout_form,
                  drop_path=float(rate),
                  dtype=dt, param_dtype=pdt, quant=cfg.quant,
                  quant_mode=cfg.quant_mode, fused_w8a8=cfg.fused_w8a8,
                  fused_mlp=cfg.fused_mlp, qkv_i8=cfg.qkv_i8,
                  int8_attn=cfg.int8_attn, tp=tp, device=device)
            for rate in dpr)
        norm_name = "fc_norm" if cfg.final_reduction == "fc_norm" else "norm"
        setattr(self, norm_name, LayerNormFp32(cfg.embed_dim, dtype=dt,
                                               device=device))
        self.head = (Linear(cfg.embed_dim, cfg.num_classes, device=device)
                     if cfg.num_classes > 0 else None)
        self.requires_grad_(pdt is not None)

    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """Fill every parameter from ``generator`` (the JAX package's
        initialisers: trunc-normal 0.02 Linears, lecun-normal patch kernel,
        unit LayerNorms, head std 0.02 * init_scale)."""
        cfg = self.cfg
        if cfg.quant:
            raise ValueError(
                "the int8 model is not initialised: its state comes from "
                "ops/quant.py:quantize_vit_params of an fp32 state dict")
        if self.tp is not None:
            raise ValueError("a tensor-parallel model takes its share of the "
                             "whole model's weights: parallel/tp.py:"
                             "init_sharded")
        self.patch_embed.init_weights(generator)
        with torch.no_grad():
            if cfg.use_learnable_pos_emb:
                self.pos_embed.copy_(trunc_normal(self.pos_embed.shape, 0.02,
                                                  generator))
            if self.cls_token is not None:
                self.cls_token.zero_()
        for blk in self.blocks:
            blk.init_weights(generator)
        self.final_norm().init_weights()
        if self.head is not None:
            std = 0.02 * cfg.init_scale if cfg.init_scale > 0 else 0.02
            self.head.init_weights(generator, std)
        return self

    def final_norm(self) -> LayerNormFp32:
        return self.fc_norm if self.cfg.final_reduction == "fc_norm" \
            else self.norm

    def forward_features(self, x, tokens_input: bool = False,
                         generator=None):
        cfg = self.cfg
        tokens = x.to(cfg.dtype) if tokens_input else self.patch_embed(x)
        tokens = tokens + self.pos_embed.to(cfg.dtype)
        if self.cls_token is not None:
            cls = self.cls_token.to(cfg.dtype).expand(tokens.shape[0], -1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = dropout(tokens, cfg.drop_rate, self.training, generator)
        if self._carry():
            pending = torch.zeros_like(tokens)
            for blk in self.blocks:
                tokens, pending = blk.forward_carry(tokens, pending)
            tokens = tokens + pending
        else:
            for blk in self.blocks:
                tokens = block_call(blk, tokens, generator, cfg.remat)
        if cfg.final_reduction == "fc_norm":
            if self.cls_token is not None:
                tokens = tokens[:, 1:]
            return self.fc_norm(tokens.mean(dim=1))
        tokens = self.norm(tokens)
        return tokens[:, 0] if cfg.final_reduction == "cls" else tokens

    def _carry(self) -> bool:
        """Does the forward take the deferred-residual carry (``add_lnq``),
        where the JAX program takes it: static int8 at eval, with
        LayerNorm->int8 norms?"""
        cfg = self.cfg
        return (cfg.add_lnq and cfg.quant and cfg.quant_mode == "static"
                and not self.training and cfg.embed_dim % 128 == 0)

    def forward(self, x, *, tokens_input: bool = False,
                features_only: bool = False, generator=None):
        """x: (B, T, H, W, C) normalized video -> (B, num_classes) fp32
        logits; with ``tokens_input``, x is (B, num_patches, D) tokens.
        ``generator``: the source of the training-mode dropout and
        stochastic-depth masks (on x's device)."""
        feats = self.forward_features(x, tokens_input, generator)
        if features_only or self.head is None:
            return feats
        feats = dropout(feats, self.cfg.fc_drop_rate, self.training,
                        generator)
        return self.head(feats.float())
