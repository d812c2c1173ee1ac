"""Model registry of the port: the VideoMAE ViT sizes of
simple_tad_tpu/models/__init__.py (names mirror the reference timm
registry).  Other families of the JAX registry are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer

# (embed_dim, depth, num_heads) per trunk size
_VIT_SIZES = {
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
}

_REGISTRY: Dict[str, dict] = {
    f"vit_{size}_patch16_{img}": dict(
        img_size=img, patch_size=16, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True)
    for size, (dim, depth, heads) in _VIT_SIZES.items()
    for img in (224, 384, 512)
}


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, device, generator: torch.Generator = None,
                 **overrides) -> VisionTransformer:
    """Build a ViT by registry name on ``device``, in eval mode.  Keyword
    overrides set ViTConfig fields (those of the JAX registry that
    cli/finetune.py passes: ``num_classes``, ``all_frames``, ``img_size``,
    ``tubelet_size``, the dropout and drop-path rates, ``final_reduction``,
    ``init_scale``, ``dtype``, ``remat``; and ``param_dtype`` for fp32
    training masters); keys that are not fields (``attn_impl``: the port
    has one attention path) are ignored, as in the JAX registry.  With
    ``generator`` the weights are initialised from it; otherwise they are
    left uninitialised for a checkpoint to fill."""
    if name not in _REGISTRY:
        raise KeyError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1); "
            f"ported: {list_models()}")
    kw = dict(_REGISTRY[name])
    kw.update(overrides)
    fields = {f.name for f in dataclasses.fields(ViTConfig)}
    model = VisionTransformer(
        ViTConfig(**{k: v for k, v in kw.items() if k in fields}),
        device=device)
    if generator is not None:
        model.init_weights(generator)
    return model.eval()
