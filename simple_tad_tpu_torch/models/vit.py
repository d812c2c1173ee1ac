"""VideoMAE-style video Vision Transformer, in PyTorch.

Port of simple_tad_tpu/models/vit.py:VisionTransformer for the fixed
sincos position table without a CLS token (the VideoMAE fine-tuned models
of the main path).  Input is channels-last video (B, T, H, W, C), or
pre-embedded tokens (B, num_patches, D) with ``tokens_input=True``.  The
sincos table is a non-persistent buffer: it is regenerated, never loaded.
The head runs in fp32.  ``quant=True`` builds the int8 model
(models/layers.py, ops/quant.py) in ``quant_mode`` 'static', 'dynamic' or
'calib'; its state comes from ops/quant.py and is never initialised.

Training: ``param_dtype=torch.float32`` builds fp32 masters computed in
``dtype`` (the JAX package's training setup), and their parameters
require grad.  In ``train()`` mode the model applies the position and
head dropout (``drop_rate``, ``fc_drop_rate``), the blocks' proj/MLP
dropout (``drop_rate``) and stochastic depth spread as
``linspace(0, drop_path_rate, depth)`` over the blocks, drawing from the
``generator`` given to ``forward``.  Attention dropout and gradient
checkpointing (``remat``) are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from simple_tad_tpu_torch.models.layers import (Block, LayerNormFp32, Linear,
                                                PatchEmbed, dropout,
                                                sincos_pos_embed)


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
    # parameter storage: None keeps each parameter in the dtype the JAX
    # package computes it in (inference); torch.float32 gives fp32 training
    # masters
    param_dtype: Optional[torch.dtype] = None
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return ((self.img_size // self.patch_size) ** 2
                * (self.all_frames // self.tubelet_size))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device):
        super().__init__()
        if (cfg.pos_embed_kind != "sincos" or cfg.use_cls_token
                or cfg.use_learnable_pos_emb):
            raise NotImplementedError(
                "MVD / UMT position tables, learnable position tables and "
                "the CLS token are not ported yet (ROADMAP.md queue 1, "
                "trunk variants)")
        if cfg.final_reduction not in ("fc_norm", "cls", "none"):
            raise ValueError(f"unknown final_reduction {cfg.final_reduction!r}")
        if cfg.remat:
            raise NotImplementedError(
                "gradient checkpointing (--use_checkpoint) is not ported yet "
                "(ROADMAP.md queue 1, frame fine-tuning: remat)")
        if cfg.quant and cfg.param_dtype is not None:
            raise ValueError("the int8 model is inference only")
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size,
                                      cfg.tubelet_size, cfg.in_chans,
                                      dtype=dt, param_dtype=pdt,
                                      device=device)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_pos_embed(cfg.num_patches, cfg.embed_dim)
                             ).to(device=device, dtype=dt),
            persistent=False)
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
                  init_values=cfg.init_values, drop=cfg.drop_rate,
                  attn_drop=cfg.attn_drop_rate, drop_path=float(rate),
                  dtype=dt, param_dtype=pdt, quant=cfg.quant,
                  quant_mode=cfg.quant_mode, device=device)
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
        self.patch_embed.init_weights(generator)
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
        tokens = dropout(tokens + self.pos_embed, cfg.drop_rate,
                         self.training, generator)
        for blk in self.blocks:
            tokens = blk(tokens, generator)
        if cfg.final_reduction == "fc_norm":
            return self.fc_norm(tokens.mean(dim=1))
        tokens = self.norm(tokens)
        return tokens[:, 0] if cfg.final_reduction == "cls" else tokens

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
