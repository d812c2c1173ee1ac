"""Asymmetric encoder-decoder VideoMAE for masked-video pre-training (DAPT),
in PyTorch.

Port of simple_tad_tpu/models/mae.py:PretrainVideoMAE (reference:
modeling_pretrain.py, and the per-patch-normalised MSE targets of
engine_for_pretraining.py:51-71).  Parameters carry the reference's names
(``encoder.patch_embed.proj.weight``, ``encoder.blocks.<i>.*``,
``encoder.norm.*``, ``encoder_to_decoder.weight``, ``mask_token``,
``decoder.blocks.<i>.*``, ``decoder.norm.*``, ``decoder.head.*``), so a
reference pre-training ``.pth`` loads by name, and the encoder of a
checkpoint this model writes loads into the fine-tuning ViT through
utils/torch_convert.py:remap_finetune_keys.  The position tables are
non-persistent buffers, regenerated, never loaded: the encoder's 1-D
sincos table, or MVD's 3-D one (``pos_embed_kind='3d'``); the decoder's is
always 1-D.  With ``use_learnable_pos_emb`` the encoder's table is the
parameter ``encoder_pos_embed`` (1, N, C) instead, trunc-normal 0.02 at
initialisation, kept in the parameter dtype and cast to the compute dtype
in ``forward``.  It carries the JAX leaf's name, so the optimizer's
no-decay prefixes treat it as the JAX package does (decayed; so is the
reference's ``encoder.pos_embed``, whose full name misses its skip list);
a reference ``.pth``'s ``encoder.pos_embed`` loads into it
(utils/torch_convert.py:load_mae_checkpoint).

Every sample masks the same number of tokens (tube masking), so the
visible and masked token sets are fixed-size gathers: ``mask_partition``
is a stable argsort of the mask, visible tokens first in their original
order, which is the reference's ``x[~mask]`` order.  The encoder runs the
port's ``Block`` on the visible tokens only (kernels A2, and C1/C2 in
training); the decoder runs on all N tokens, [visible + their positions |
mask token + the masked positions], and its head, in fp32, predicts the
trailing ``num_masked`` tokens.  ``mae_targets`` builds the targets.
Training draws drop path and dropout from the ``generator`` passed to
``forward``; attention dropout takes ``attn_dropout_form`` as in the ViT.
``remat`` checkpoints each encoder and decoder block
(models/layers.py:block_call), as the JAX package remats both scans.

``PretrainIV2VideoMAE`` (IV2MAEConfig) is the port of the JAX package's
PretrainIV2VideoMAE (reference: internvideo2_pretrain_videomae.py:234-353,
as iv2_run_mae_double_pretraining.py:167-185 wires it): the IV2 DAPT
model.  Its encoder is InternVideo2's trunk without the CLS token: the
patch-14 / tubelet-1 embedding, a learnable sincos-initialised position
table (joint, or spatial + temporal with ``sep_pos_embed``), the port's
``IV2Block`` (RMSNorm, QK-norm, LayerScale 1e-5, bias-free qkv; kernels C3
in training) on the visible tokens and a final LayerNorm; then the
VideoMAE decoder of PretrainVideoMAE (bias-free qkv and LayerScale 1e-5
here too) and its fp32 head of 3 * 14 * 14 = 588 pixels a token.  Its
names are the reference's (``encoder.patch_embed.proj.*``,
``encoder.pos_embed``, ``encoder.blocks.<i>.ls1.gamma``, ...,
``encoder.norm.*``, then those of PretrainVideoMAE).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from simple_tad_tpu_torch.models.layers import (Block, LayerNormFp32, Linear,
                                                PatchEmbed, _param,
                                                block_call,
                                                sincos_1d_mae,
                                                sincos_3d_pos_embed,
                                                sincos_pos_embed,
                                                trunc_normal)
from simple_tad_tpu_torch.ops.attention import DROPOUT_FORMS


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """simple_tad_tpu/models/mae.py:MAEConfig, with the port's explicit
    ``attn_dropout_form`` and ``param_dtype`` (torch.float32: fp32
    training masters computed in ``dtype``)."""
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    decoder_num_classes: int = 1536   # 3 * tubelet * patch^2
    decoder_embed_dim: int = 384
    decoder_depth: int = 4            # the jobs use 4 (jobs/dapt/*.sh)
    decoder_num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    attn_dropout_form: str = "rng"
    drop_path_rate: float = 0.0
    init_values: float = 0.0
    use_learnable_pos_emb: bool = False
    # the encoder's table: '1d' (VideoMAE) or '3d' (MVD); the decoder's is 1d
    pos_embed_kind: str = "1d"
    all_frames: int = 16
    tubelet_size: int = 2
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None
    remat: bool = False

    def __post_init__(self):
        want = self.in_chans * self.tubelet_size * self.patch_size ** 2
        if self.decoder_num_classes != want:
            raise ValueError(f"decoder_num_classes {self.decoder_num_classes}"
                             f" is not 3 * tubelet * patch^2 = {want}")

    @property
    def num_patches(self) -> int:
        return ((self.img_size // self.patch_size) ** 2
                * (self.all_frames // self.tubelet_size))


def mask_partition(mask: torch.Tensor, num_masked: int):
    """(B, N) bool mask (True = masked, ``num_masked`` Trues a row) ->
    (visible indices (B, N - num_masked), masked indices (B, num_masked)),
    each in token order: a stable argsort of the mask cast to int32 (a
    plain argsort is free to reorder equal keys)."""
    order = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
    n_vis = mask.shape[1] - num_masked
    return order[:, :n_vis], order[:, n_vis:]


def _gather_tokens(x, idx):
    """x (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def mae_targets(video, mask, num_masked: int, *, patch_size: int = 16,
                tubelet_size: int = 2, normalize_target: bool = True,
                mean=None, std=None):
    """Per-patch(-normalised) pixel targets of the masked tokens ->
    (B, num_masked, tubelet * p * p * C) fp32, in mask order.

    ``video`` (B, T, H, W, C): ImageNet-normalised with ``mean`` and
    ``std`` ((C,) tensors; the train batch as it is, which is
    de-normalised here) or, without them, already in [0, 1].  The one
    helper for both of the JAX package's orders (mae_targets_fused and
    mae_targets): the patchify and the masked-token gather run on the
    video's dtype, then the fp32 cast, the de-normalisation and the
    per-patch normalisation (mean, unbiased variance, eps 1e-6 on the std)
    over each patch's pixels per channel.  Every step after the gather
    acts on one token alone, so gathering first gives the same values as
    gathering last, on a quarter of the tokens at mask 0.75."""
    B, T, H, W, C = video.shape
    p, tb = patch_size, tubelet_size
    nt, nh, nw = T // tb, H // p, W // p
    v = video.reshape(B, nt, tb, nh, p, nw, p, C)
    v = v.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, nt * nh * nw,
                                                  tb * p * p, C)
    _, mask_idx = mask_partition(mask, num_masked)
    v = torch.gather(v, 1, mask_idx[:, :, None, None].expand(
        -1, -1, tb * p * p, C)).float()
    if mean is not None:
        v = v * std + mean
    if normalize_target:
        mu = v.mean(dim=2, keepdim=True)
        var = (v - mu).square().sum(dim=2, keepdim=True) / (v.shape[2] - 1)
        v = (v - mu) / (torch.sqrt(var) + 1e-6)
    return v.reshape(B, num_masked, tb * p * p * C)


def _xavier_uniform(shape, generator) -> torch.Tensor:
    """flax's xavier_uniform for a (out, in) Linear weight."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator,
                   device=None if generator is None else generator.device)
    return (u * 2.0 - 1.0) * bound


class _Stack(nn.Module):
    """Blocks with drop path spread as linspace(0, rate, depth), then the
    final LayerNorm (the reference encoder's / decoder's ``blocks`` and
    ``norm``)."""

    def __init__(self, cfg: MAEConfig, dim: int, depth: int, heads: int, *,
                 device):
        super().__init__()
        dpr = np.linspace(0.0, cfg.drop_path_rate, depth)
        self.remat = cfg.remat
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  qk_scale=cfg.qk_scale, init_values=cfg.init_values,
                  drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
                  attn_dropout_form=cfg.attn_dropout_form,
                  drop_path=float(rate), dtype=cfg.dtype,
                  param_dtype=cfg.param_dtype, device=device)
            for rate in dpr)
        self.norm = LayerNormFp32(dim, dtype=cfg.dtype, device=device)

    def init_weights(self, generator):
        for blk in self.blocks:
            blk.init_weights(generator)
        self.norm.init_weights()

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = block_call(blk, x, generator, self.remat)
        return self.norm(x)


class PretrainVideoMAE(nn.Module):
    """forward(x (B, T, H, W, C) normalised video, mask (B, N) bool,
    num_masked) -> (B, num_masked, decoder_num_classes) fp32 predictions of
    the masked tokens, in mask order."""

    def __init__(self, cfg: MAEConfig, *, device):
        super().__init__()
        if cfg.pos_embed_kind not in ("1d", "3d"):
            raise ValueError(f"unknown pos_embed_kind {cfg.pos_embed_kind!r}"
                             f"; expected '1d' or '3d'")
        if cfg.attn_dropout_form not in DROPOUT_FORMS:
            raise ValueError(f"unknown attn_dropout_form "
                             f"{cfg.attn_dropout_form!r}")
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        D = cfg.encoder_embed_dim
        self.encoder = _Stack(cfg, D, cfg.encoder_depth,
                              cfg.encoder_num_heads, device=device)
        self.encoder.patch_embed = PatchEmbed(D, cfg.patch_size,
                                              cfg.tubelet_size, cfg.in_chans,
                                              dtype=dt, param_dtype=pdt,
                                              device=device)
        if cfg.use_learnable_pos_emb:
            self.encoder_pos_embed = _param((1, cfg.num_patches, D),
                                            pdt or dt, device)
        else:
            if cfg.pos_embed_kind == "3d":
                enc_pos = sincos_3d_pos_embed(
                    D, cfg.img_size // cfg.patch_size,
                    cfg.all_frames // cfg.tubelet_size)
            else:
                enc_pos = sincos_pos_embed(cfg.num_patches, D)
            self.encoder.register_buffer(
                "pos_embed", torch.from_numpy(enc_pos).to(device=device,
                                                          dtype=dt),
                persistent=False)
        _add_decoder(self, cfg, D, device)
        self.requires_grad_(pdt is not None)

    def init_weights(self, generator: torch.Generator) -> "PretrainVideoMAE":
        """Fill every parameter from ``generator`` (the JAX package's
        initialisers: the ViT's for the patch embedding and the blocks,
        xavier-uniform encoder_to_decoder and decoder head with a zero bias,
        a trunc-normal 0.02 mask token and learnable position table, unit
        LayerNorms)."""
        self.encoder.patch_embed.init_weights(generator)
        if self.cfg.use_learnable_pos_emb:
            with torch.no_grad():
                self.encoder_pos_embed.copy_(trunc_normal(
                    self.encoder_pos_embed.shape, 0.02, generator))
        self.encoder.init_weights(generator)
        _init_decoder(self, generator)
        return self

    def forward(self, x, mask, num_masked: int, generator=None):
        vis_idx, mask_idx = mask_partition(mask, num_masked)
        pos = (self.encoder_pos_embed if self.cfg.use_learnable_pos_emb
               else self.encoder.pos_embed)
        tokens = self.encoder.patch_embed(x) + pos.to(self.cfg.dtype)
        x_vis = self.encoder(_gather_tokens(tokens, vis_idx), generator)
        return _decode(self, x_vis, vis_idx, mask_idx, num_masked, generator)


def _add_decoder(model, cfg, encoder_dim: int, device) -> None:
    """The decoder half of both pre-training models: encoder_to_decoder,
    the mask token, the decoder's fixed 1-D sincos table, its blocks and
    norm, and the fp32 head."""
    dt, pdt, Dd = cfg.dtype, cfg.param_dtype, cfg.decoder_embed_dim
    model.encoder_to_decoder = Linear(encoder_dim, Dd, bias=False, dtype=dt,
                                      param_dtype=pdt, device=device)
    model.mask_token = _param((1, 1, Dd), pdt or dt, device)
    model.register_buffer(
        "pos_embed", torch.from_numpy(sincos_pos_embed(
            cfg.num_patches, Dd)).to(device=device, dtype=dt),
        persistent=False)
    model.decoder = _Stack(cfg, Dd, cfg.decoder_depth, cfg.decoder_num_heads,
                           device=device)
    model.decoder.head = Linear(Dd, cfg.decoder_num_classes, param_dtype=pdt,
                                device=device)


def _init_decoder(model, generator) -> None:
    """xavier-uniform encoder_to_decoder and decoder head with a zero bias,
    a trunc-normal 0.02 mask token, the decoder's blocks."""
    model.decoder.init_weights(generator)
    with torch.no_grad():
        for lin in (model.encoder_to_decoder, model.decoder.head):
            lin.weight.copy_(_xavier_uniform(lin.weight.shape, generator))
        model.decoder.head.bias.zero_()
        model.mask_token.copy_(trunc_normal(model.mask_token.shape, 0.02,
                                            generator))


def _decode(model, x_vis, vis_idx, mask_idx, num_masked: int, generator):
    """The encoded visible tokens -> (B, num_masked, decoder_num_classes)
    fp32 predictions of the masked tokens: [visible + their positions |
    mask token + the masked positions] through the decoder, its head on
    the trailing ``num_masked`` tokens."""
    x_vis = model.encoder_to_decoder(x_vis)
    dec_pos = model.pos_embed.expand(x_vis.shape[0], -1, -1)
    full = torch.cat(
        [x_vis + _gather_tokens(dec_pos, vis_idx),
         model.mask_token.to(model.cfg.dtype) + _gather_tokens(dec_pos,
                                                               mask_idx)],
        dim=1)
    full = model.decoder(full, generator)
    return model.decoder.head(full[:, -num_masked:].float())


@dataclasses.dataclass(frozen=True)
class IV2MAEConfig:
    """simple_tad_tpu/models/mae.py:IV2MAEConfig, with the port's
    ``param_dtype`` and the decoder blocks' ``qk_scale`` and
    ``attn_dropout_form`` (the fields ``_Stack`` reads).  ``tubelet_size``
    must stay 1: the 588-wide head is 3 * 1 * 14 * 14."""
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    encoder_embed_dim: int = 384
    encoder_depth: int = 12
    encoder_num_heads: int = 6
    decoder_num_classes: int = 588    # 3 * tubelet * patch^2
    decoder_embed_dim: int = 192
    decoder_depth: int = 4
    decoder_num_heads: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = False            # IV2's qkv is bias-free
    qk_scale: Optional[float] = None
    qk_normalization: bool = True
    init_values: float = 1e-5         # get_model forces 1e-5 (:182)
    sep_pos_embed: bool = False
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    attn_dropout_form: str = "rng"
    drop_path_rate: float = 0.0
    all_frames: int = 8
    tubelet_size: int = 1
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None
    remat: bool = False

    def __post_init__(self):
        want = self.in_chans * self.tubelet_size * self.patch_size ** 2
        if self.decoder_num_classes != want:
            raise ValueError(f"decoder_num_classes {self.decoder_num_classes}"
                             f" is not 3 * tubelet * patch^2 = {want}")

    @property
    def grid_size(self):
        return (self.all_frames // self.tubelet_size,
                self.img_size // self.patch_size,
                self.img_size // self.patch_size)

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid_size
        return t * h * w


class _IV2Encoder(nn.Module):
    """The IV2 DAPT encoder: patch embedding, the learnable position table
    (no CLS row), IV2 blocks at drop path linspace(0, rate, depth) on the
    visible tokens, the final LayerNorm."""

    def __init__(self, cfg: IV2MAEConfig, *, device):
        super().__init__()
        from simple_tad_tpu_torch.models.internvideo2 import IV2Block
        self.cfg = cfg
        dt, pdt, D = cfg.dtype, cfg.param_dtype, cfg.encoder_embed_dim
        nt, nh, nw = cfg.grid_size
        self.patch_embed = PatchEmbed(D, cfg.patch_size, cfg.tubelet_size,
                                      cfg.in_chans, dtype=dt, param_dtype=pdt,
                                      device=device)
        if cfg.sep_pos_embed:
            self.pos_embed_spatial = _param((1, nh * nw, D), torch.float32,
                                            device)
            self.pos_embed_temporal = _param((1, nt, D), torch.float32,
                                             device)
        else:
            self.pos_embed = _param((1, cfg.num_patches, D), torch.float32,
                                    device)
        self.blocks = nn.ModuleList(
            IV2Block(D, cfg.encoder_num_heads, mlp_ratio=cfg.mlp_ratio,
                     qkv_bias=cfg.qkv_bias, init_values=cfg.init_values,
                     qk_normalization=cfg.qk_normalization,
                     drop_path_rate=float(rate), dtype=dt, param_dtype=pdt,
                     device=device)
            for rate in np.linspace(0.0, cfg.drop_path_rate,
                                    cfg.encoder_depth))
        self.norm = LayerNormFp32(D, dtype=dt, device=device)

    def init_weights(self, generator):
        """The JAX initialisers: lecun-normal patch kernel, the sincos
        tables (init_pos_embed, internvideo2_pretrain_videomae.py:127-151),
        the IV2 blocks', a unit norm."""
        cfg = self.cfg
        nt, nh, _ = cfg.grid_size
        D = cfg.encoder_embed_dim
        self.patch_embed.init_weights(generator)
        with torch.no_grad():
            if cfg.sep_pos_embed:
                g = np.arange(nh, dtype=np.float64)
                gw, gh = np.meshgrid(g, g)
                sp = np.concatenate([sincos_1d_mae(D // 2, gw),
                                     sincos_1d_mae(D // 2, gh)], axis=1)
                tp = sincos_1d_mae(D, np.arange(nt, dtype=np.float64))
                self.pos_embed_spatial.copy_(torch.from_numpy(sp[None]))
                self.pos_embed_temporal.copy_(torch.from_numpy(tp[None]))
            else:
                self.pos_embed.copy_(torch.from_numpy(
                    sincos_3d_pos_embed(D, nh, nt)))
        for blk in self.blocks:
            blk.init_weights(generator)
        self.norm.init_weights()

    def position_table(self):
        """(1, num_patches, D) fp32."""
        if not self.cfg.sep_pos_embed:
            return self.pos_embed
        sp = self.pos_embed_spatial
        return (sp.repeat(1, self.cfg.grid_size[0], 1)
                + self.pos_embed_temporal.repeat_interleave(sp.shape[1],
                                                            dim=1))

    def forward(self, x, vis_idx, generator=None):
        tokens = self.patch_embed(x) + self.position_table().to(self.cfg.dtype)
        x = _gather_tokens(tokens, vis_idx)
        for blk in self.blocks:
            x = block_call(blk, x, generator, self.cfg.remat)
        return self.norm(x)


class PretrainIV2VideoMAE(nn.Module):
    """forward(x (B, T, H, W, C) normalised video, mask (B, N) bool, N =
    num_patches (no CLS slot), num_masked) -> (B, num_masked, 588) fp32
    predictions of the masked tokens, in mask order."""

    def __init__(self, cfg: IV2MAEConfig, *, device):
        super().__init__()
        if cfg.attn_dropout_form not in DROPOUT_FORMS:
            raise ValueError(f"unknown attn_dropout_form "
                             f"{cfg.attn_dropout_form!r}")
        self.cfg = cfg
        self.encoder = _IV2Encoder(cfg, device=device)
        _add_decoder(self, cfg, cfg.encoder_embed_dim, device)
        self.requires_grad_(cfg.param_dtype is not None)

    def init_weights(self, generator: torch.Generator
                     ) -> "PretrainIV2VideoMAE":
        self.encoder.init_weights(generator)
        _init_decoder(self, generator)
        return self

    def forward(self, x, mask, num_masked: int, generator=None):
        vis_idx, mask_idx = mask_partition(mask, num_masked)
        x_vis = self.encoder(x, vis_idx, generator)
        return _decode(self, x_vis, vis_idx, mask_idx, num_masked, generator)
