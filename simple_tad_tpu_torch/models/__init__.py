"""Model registry of the port: the VideoMAE ViT sizes and the InternVideo2
single-modality sizes of simple_tad_tpu/models/__init__.py (names mirror
the reference timm registry).  Other families of the JAX registry are not
ported yet."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
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

_REGISTRY: Dict[str, Tuple[str, dict]] = {
    **{f"vit_{size}_patch16_{img}": ("vit", dict(
        img_size=img, patch_size=16, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True))
       for size, (dim, depth, heads) in _VIT_SIZES.items()
       for img in (224, 384, 512)},
    **{f"internvideo2_{size}_patch14_224": ("iv2", dict(
        img_size=224, patch_size=14, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=ratio, attn_pool_num_heads=16,
        clip_embed_dim=768))
       for size, (dim, depth, heads, ratio) in _IV2_SIZES.items()},
}
_FAMILIES = {"vit": (ViTConfig, VisionTransformer),
             "iv2": (IV2Config, InternVideo2)}


def list_models():
    return sorted(_REGISTRY)


def model_family(name: str) -> str:
    """'vit' or 'iv2' for a registry name."""
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
    ``dtype``, ``remat``; and ``param_dtype`` for fp32 training masters of
    the ViT); keys that are not fields of the family's config
    (``attn_impl``: the port has one attention path) are ignored, as in the
    JAX registry.  For InternVideo2, ``all_frames`` sets ``num_frames``, as
    the JAX registry maps it.  With ``generator`` the weights are
    initialised from it; otherwise they are left uninitialised for a
    checkpoint to fill."""
    kind = model_family(name)
    kw = dict(_REGISTRY[name][1])
    kw.update(overrides)
    if kind == "iv2" and "all_frames" in kw:
        kw.setdefault("num_frames", kw.pop("all_frames"))
    config_cls, model_cls = _FAMILIES[kind]
    fields = {f.name for f in dataclasses.fields(config_cls)}
    model = model_cls(config_cls(**{k: v for k, v in kw.items()
                                    if k in fields}), device=device)
    if generator is not None:
        model.init_weights(generator)
    return model.eval()
