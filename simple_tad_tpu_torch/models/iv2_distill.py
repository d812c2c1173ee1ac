"""Masked multi-layer feature-distillation student (InternVideo2 stage 2),
in PyTorch.

Port of simple_tad_tpu/models/iv2_distill.py (reference: DistInternVideo2,
models/internvideo2_distill.py:406-700 of the InternVideo2 single-modality
code, as run_distill.py and scripts/distillation/*_dist_1B_stage2.sh drive
it).  The student runs its InternVideo2 trunk (the port's ``IV2Block``:
RMSNorm, q/k-normalisation, LayerScale, bias-free qkv) on the VISIBLE
tokens of a masked clip, the CLS token always visible; it returns K
intermediate-layer features, each decoded by its own Linear or MLP
decoder to the teacher's width and l2-normalized, and the
attention-pooled final feature decoded to the teacher's final width.
cli/distill.py aligns them against a frozen teacher's
(InternVideo2.forward's ``return_taps``) with the 2 - 2 cos loss
(train/distill.py).

Every sample masks the same number of tokens, so the visible set is a
fixed-size gather: models/mae.py:mask_partition, a stable argsort of the
mask, keeps the visible tokens in their original order, the reference's
``x[~mask]``.  Parameters carry the reference's names
(``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``clip_pos_embed``,
``blocks.<i>.*`` as in models/internvideo2.py, ``clip_projector.*``,
``clip_decoder.<k>.head`` or ``.head.0`` / ``.head.2`` (MLP),
``clip_decoder.<k>.norm``, ``final_clip_decoder.*``), so a reference
``.pth`` loads by name (utils/torch_convert.py:load_distill_checkpoint).
In ``train()`` mode with fp32 masters the blocks take the training
attention (kernels C3) and draw their stochastic-depth masks from the
``generator`` given to ``forward``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from simple_tad_tpu_torch.models.internvideo2 import (AttentionPooling,
                                                      IV2Block, LayerNormEps,
                                                      l2_normalize,
                                                      sincos_3d_pos_embed)
from simple_tad_tpu_torch.models.layers import (Linear, PatchEmbed, _param,
                                                gelu_for, trunc_normal)
from simple_tad_tpu_torch.models.mae import _gather_tokens, mask_partition


def _xavier_uniform(linear: Linear, generator: torch.Generator) -> None:
    out_dim, in_dim = linear.weight.shape
    bound = (6.0 / (in_dim + out_dim)) ** 0.5
    with torch.no_grad():
        linear.weight.copy_((torch.rand(linear.weight.shape,
                                        generator=generator,
                                        device=generator.device) * 2 - 1)
                            * bound)
        linear.bias.zero_()


class FeatureDecoder(nn.Module):
    """Linear_Decoder / MLP_Decoder (internvideo2_distill.py:334-397): the
    head (one Linear, or Linear -> GELU -> Linear), then LayerNorm with eps
    1e-5, then (``norm_type`` 'l2') the l2 normalisation in fp32."""

    def __init__(self, in_dim: int, out_dim: int, *, kind: str = "linear",
                 norm_type: str = "l2", dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        if norm_type not in ("l2", "none"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.dtype = dtype
        self.norm_type = norm_type
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        if kind == "mlp":
            gelu = gelu_for(dtype)
            self.head = nn.Sequential(Linear(in_dim, in_dim, **kw),
                                      _Fn(gelu),
                                      Linear(in_dim, out_dim, **kw))
        elif kind == "linear":
            self.head = Linear(in_dim, out_dim, **kw)
        else:
            raise ValueError(f"unknown decoder kind {kind!r}")
        self.norm = LayerNormEps(out_dim, eps=1e-5, dtype=dtype,
                                 device=device)

    def init_weights(self, generator):
        for m in self.head.modules():
            if isinstance(m, Linear):
                _xavier_uniform(m, generator)
        self.norm.init_weights()

    def forward(self, x):
        x = self.norm(self.head(x.to(self.dtype)))
        return l2_normalize(x) if self.norm_type == "l2" else x


class _Fn(nn.Module):
    """A parameter-free function as a module (the MLP decoder's GELU, so
    the Linears keep the reference's Sequential indices 0 and 2)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


@dataclasses.dataclass(frozen=True)
class DistillIV2Config:
    """simple_tad_tpu/models/iv2_distill.py:DistillIV2Config (the IV2-S
    defaults and the stage-2 scripts' distillation surface), with the
    port's ``param_dtype`` (torch.float32: fp32 training masters computed
    in ``dtype``)."""
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    init_values: float = 1e-5
    qk_normalization: bool = True
    attn_pool_num_heads: int = 16
    clip_embed_dim: int = 768
    num_frames: int = 8
    tubelet_size: int = 1
    drop_path_rate: float = 0.05
    # distillation surface (run_distill.py:70-95)
    clip_teacher_embed_dim: int = 1408   # stage 2: the IV2-1B trunk width
    clip_teacher_final_dim: int = 768    # 0 = no final alignment
    clip_return_layer: int = 6
    clip_student_return_interval: float = 1.0
    clip_return_index: Tuple[int, ...] = ()   # explicit override
    clip_norm_type: str = "l2"
    clip_student_decoder: str = "mlp"    # the stage-2 scripts' MLP_Decoder
    dtype: torch.dtype = torch.float32
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
    def return_index(self) -> Tuple[int, ...]:
        """The student's tap indices, ascending (default: the last
        ``clip_return_layer`` layers at ``clip_student_return_interval``,
        internvideo2_distill.py:450-457)."""
        if self.clip_return_index:
            return tuple(sorted(self.clip_return_index))
        idx = [self.depth - int(i * self.clip_student_return_interval) - 1
               for i in range(self.clip_return_layer)]
        return tuple(sorted(idx))


class DistillInternVideo2(nn.Module):
    def __init__(self, cfg: DistillIV2Config, *, device):
        super().__init__()
        if cfg.remat:
            raise NotImplementedError(
                "gradient checkpointing (--use_checkpoint) is not ported yet "
                "(ROADMAP.md queue 1 item 5)")
        self.cfg = cfg
        dt, pdt, D = cfg.dtype, cfg.param_dtype, cfg.embed_dim
        kw = dict(dtype=dt, param_dtype=pdt, device=device)
        self.patch_embed = PatchEmbed(D, cfg.patch_size, cfg.tubelet_size,
                                      cfg.in_chans, **kw)
        self.cls_token = _param((1, 1, D), torch.float32, device)
        self.pos_embed = _param((1, cfg.num_patches + 1, D), torch.float32,
                                device)
        self.clip_pos_embed = _param((1, cfg.num_patches + 1, D),
                                     torch.float32, device)
        self.blocks = nn.ModuleList(
            IV2Block(D, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                     qkv_bias=cfg.qkv_bias, init_values=cfg.init_values,
                     qk_normalization=cfg.qk_normalization,
                     drop_path_rate=float(rate), **kw)
            for rate in np.linspace(0.0, cfg.drop_path_rate, cfg.depth))
        dec = dict(kind=cfg.clip_student_decoder,
                   norm_type=cfg.clip_norm_type, **kw)
        self.clip_decoder = nn.ModuleList(
            FeatureDecoder(D, cfg.clip_teacher_embed_dim, **dec)
            for _ in cfg.return_index)
        if cfg.clip_teacher_final_dim > 0:
            self.clip_projector = AttentionPooling(
                D, cfg.attn_pool_num_heads, cfg.clip_embed_dim, dtype=dt,
                param_dtype=pdt, device=device)
            self.final_clip_decoder = FeatureDecoder(
                cfg.clip_embed_dim, cfg.clip_teacher_final_dim, **dec)
        else:
            self.clip_projector = self.final_clip_decoder = None
        self.requires_grad_(pdt is not None)

    def init_weights(self, generator: torch.Generator
                     ) -> "DistillInternVideo2":
        """Fill every parameter from ``generator`` with the JAX package's
        initialisers: the trunk's as models/internvideo2.py's, both
        position tables the 3-D sincos table with a zero CLS row, the
        decoders' Linears xavier-uniform."""
        cfg = self.cfg
        nt, nh, _ = cfg.grid_size
        D = cfg.embed_dim
        self.patch_embed.init_weights(generator)
        table = torch.from_numpy(np.concatenate(
            [np.zeros((1, 1, D), np.float32),
             sincos_3d_pos_embed(D, nh, nt)], 1))
        with torch.no_grad():
            self.cls_token.copy_(trunc_normal((1, 1, D), 0.02, generator))
            self.pos_embed.copy_(table)
            self.clip_pos_embed.copy_(table)
        for blk in self.blocks:
            blk.init_weights(generator)
        for dec in self.clip_decoder:
            dec.init_weights(generator)
        if self.clip_projector is not None:
            self.clip_projector.init_weights(generator)
            self.final_clip_decoder.init_weights(generator)
        return self

    def forward(self, x, mask, num_masked: int, generator=None):
        """x: (B, T, H, W, C) normalized video; mask: (B, N + 1) bool, the
        CLS slot first (True = masked; the CLS slot visible),
        ``num_masked`` Trues a row.  -> (the K decoded taps (K, B,
        N + 1 - num_masked, clip_teacher_embed_dim), the decoded final
        feature (B, clip_teacher_final_dim) or None), both fp32 and
        l2-normalized with ``clip_norm_type`` 'l2'."""
        cfg = self.cfg
        dt = cfg.dtype
        vis_idx, _ = mask_partition(mask, num_masked)
        tokens = self.patch_embed(x)
        B = tokens.shape[0]
        cls = self.cls_token.to(dt).expand(B, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(dt)
        # the visible tokens, gathered after the position table is added
        x_vis = _gather_tokens(tokens, vis_idx)
        ret = cfg.return_index
        outs = {}
        for i, blk in enumerate(self.blocks):
            x_vis = blk(x_vis, generator)
            if i in ret:
                outs[i] = x_vis
        # the taps in ascending layer order, re-encoded by the second table
        # at the visible positions (internvideo2_distill.py:658-678)
        pos_vis = _gather_tokens(self.clip_pos_embed.to(dt).expand(B, -1, -1),
                                 vis_idx)
        taps = torch.stack([outs[i] for i in ret]) + pos_vis[None]
        aligned = torch.stack([dec(taps[k])
                               for k, dec in enumerate(self.clip_decoder)])
        x_align = None
        if self.clip_projector is not None:
            x_align = self.final_clip_decoder(self.clip_projector(x_vis))
        return aligned, x_align
