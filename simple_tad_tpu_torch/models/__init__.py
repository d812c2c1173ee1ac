"""Model registry of the port: the VideoMAE ViT sizes, the MVD and UMT
trunk variants, the InternVideo2 single-modality sizes, the VideoMAE /
MVD pre-training models (PretrainVideoMAE), the InternVideo2 DAPT models
(PretrainIV2VideoMAE) and the InternVideo2 stage-2 distillation students
(DistillInternVideo2) of simple_tad_tpu/models/__init__.py (names mirror
the reference timm registry): every name of the JAX registry."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.models.iv2_distill import (DistillInternVideo2,
                                                     DistillIV2Config)
from simple_tad_tpu_torch.models.mae import (IV2MAEConfig, MAEConfig,
                                             PretrainIV2VideoMAE,
                                             PretrainVideoMAE)
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer

# (embed_dim, depth, num_heads) per trunk size
_VIT_SIZES = {
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
}
# (embed_dim, depth, num_heads, mlp_ratio) per InternVideo2 size
_IV2_SIZES = {
    "small": (384, 12, 6, 4.0),
    "base": (768, 12, 12, 4.0),
    "large": (1024, 24, 16, 4.0),
    "1B": (1408, 40, 16, 48 / 11),
    "6B": (3200, 48, 25, 4.0),
}

# MAE decoder geometry per trunk size (decoder_embed_dim, decoder_num_heads)
_MAE_DECODER = {
    "small": (192, 3),
    "base": (384, 6),
    "large": (512, 8),
    "huge": (640, 8),
}


def _mae(size: str, **extra) -> Tuple[str, dict]:
    dim, depth, heads = _VIT_SIZES[size]
    ddim, dheads = _MAE_DECODER[size]
    return "mae", dict(img_size=224, patch_size=16, encoder_embed_dim=dim,
                       encoder_depth=depth, encoder_num_heads=heads,
                       decoder_embed_dim=ddim, decoder_num_heads=dheads,
                       decoder_num_classes=1536, mlp_ratio=4.0,
                       qkv_bias=True, **extra)


def _iv2_mae(size: str) -> Tuple[str, dict]:
    """IV2 DAPT: the reference registers the S geometry alone
    (internvideo2_pretrain_videomae.py:356-365); the JAX registry extends
    it to each size with the VideoMAE decoder convention."""
    dim, depth, heads = _VIT_SIZES[size]
    ddim, dheads = _MAE_DECODER[size]
    return "iv2_mae", dict(img_size=224, patch_size=14,
                           encoder_embed_dim=dim, encoder_depth=depth,
                           encoder_num_heads=heads, decoder_embed_dim=ddim,
                           decoder_num_heads=dheads, decoder_num_classes=588,
                           mlp_ratio=4.0)


_REGISTRY: Dict[str, Tuple[str, dict]] = {
    **{f"vit_{size}_patch16_{img}": ("vit", dict(
        img_size=img, patch_size=16, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True))
       for size, (dim, depth, heads) in _VIT_SIZES.items()
       for img in (224, 384, 512)},
    # MVD: the 3-D sincos table (its CLS token is ``use_cls_token``)
    **{f"mvd_vit_{size}_patch16_224": ("vit", dict(
        img_size=224, patch_size=16, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True, pos_embed_kind="3d"))
       for size, (dim, depth, heads) in _VIT_SIZES.items()},
    # UMT: tubelet 1, 8 frames, the interpolated checkpoint-geometry table
    **{f"umt_vit_{size}_patch16_224": ("vit", dict(
        img_size=224, patch_size=16, embed_dim=_VIT_SIZES[size][0],
        depth=_VIT_SIZES[size][1], num_heads=_VIT_SIZES[size][2],
        mlp_ratio=4.0, qkv_bias=True, tubelet_size=1, all_frames=8,
        pos_embed_kind="umt"))
       for size in ("base", "large")},
    # VideoMAE pre-training, and MVD's (the 3-D table in the encoder)
    **{f"pretrain_videomae_{size}_patch16_224": _mae(size)
       for size in _VIT_SIZES},
    **{f"pretrain_videomae_mvd_{size}_patch16_224": _mae(
        size, pos_embed_kind="3d") for size in _VIT_SIZES},
    # InternVideo2 DAPT (pixel reconstruction on the IV2 trunk)
    "pretrain_videomae_internvideo2_patch14_224": _iv2_mae("small"),
    **{f"pretrain_videomae_internvideo2_{size}_patch14_224": _iv2_mae(size)
       for size in _VIT_SIZES},
    **{f"internvideo2_{size}_patch14_224": ("iv2", dict(
        img_size=224, patch_size=14, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=ratio, attn_pool_num_heads=16,
        clip_embed_dim=768))
       for size, (dim, depth, heads, ratio) in _IV2_SIZES.items()},
    # stage-2 distillation students: the masked IV2 trunk, K tap decoders
    # and the attention-pooled final decoder (internvideo2_distill.py:
    # 703-740)
    **{f"distill_internvideo2_{size}_patch14_224": ("iv2_distill", dict(
        img_size=224, patch_size=14, embed_dim=_IV2_SIZES[size][0],
        depth=_IV2_SIZES[size][1], num_heads=_IV2_SIZES[size][2],
        mlp_ratio=4.0, attn_pool_num_heads=16, clip_embed_dim=768))
       for size in ("small", "base", "large")},
}
_FAMILIES = {"vit": (ViTConfig, VisionTransformer),
             "iv2": (IV2Config, InternVideo2),
             "mae": (MAEConfig, PretrainVideoMAE),
             "iv2_mae": (IV2MAEConfig, PretrainIV2VideoMAE),
             "iv2_distill": (DistillIV2Config, DistillInternVideo2)}


def list_models():
    return sorted(_REGISTRY)


def model_family(name: str) -> str:
    """'vit', 'iv2', 'mae', 'iv2_mae' or 'iv2_distill' for a registry
    name."""
    if name not in _REGISTRY:
        raise KeyError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1); "
            f"ported: {list_models()}")
    return _REGISTRY[name][0]


def create_model(name: str, *, device, generator: torch.Generator = None,
                 **overrides):
    """Build a model by registry name on ``device``, in eval mode.  Keyword
    overrides set config fields (those of the JAX registry that the CLIs
    pass: ``num_classes``, ``all_frames``, ``img_size``, ``tubelet_size``,
    the dropout and drop-path rates, ``final_reduction``, ``init_scale``,
    ``dtype``, ``remat``; and ``param_dtype`` for fp32 training masters);
    keys that are not fields of the family's config (``attn_impl``: the
    port has one attention path; InternVideo2's ``drop_rate`` and
    ``attn_drop_rate``, which its config lacks) are ignored, as in the JAX
    registry.  For InternVideo2, ``all_frames`` sets ``num_frames``, as
    the JAX registry maps it, and ``param_dtype``, ``drop_path_rate`` and
    ``fc_drop_rate`` reach its config as they reach the ViT's.  The
    pre-training models take MAEConfig's fields (PretrainVideoMAE) or
    IV2MAEConfig's (PretrainIV2VideoMAE: ``all_frames`` is its own field
    there, as in the JAX registry) (``decoder_depth``, ``drop_path_rate``,
    ``param_dtype``, ...), the
    distillation students DistillIV2Config's (``clip_teacher_embed_dim``,
    ``clip_return_layer``, ``clip_student_decoder``, ...).  With
    ``generator`` the weights are initialised from it; otherwise they are
    left uninitialised for a checkpoint to fill."""
    kind = model_family(name)
    kw = dict(_REGISTRY[name][1])
    kw.update(overrides)
    if kind in ("iv2", "iv2_distill") and "all_frames" in kw:
        kw.setdefault("num_frames", kw.pop("all_frames"))
    config_cls, model_cls = _FAMILIES[kind]
    fields = {f.name for f in dataclasses.fields(config_cls)}
    model = model_cls(config_cls(**{k: v for k, v in kw.items()
                                    if k in fields}), device=device)
    if generator is not None:
        model.init_weights(generator)
    return model.eval()
