"""Checkpoints into the port's models: reference ``.pth`` files and JAX
params.

Port of simple_tad_tpu/utils/torch_convert.py for the VideoMAE ViT (and
its MVD and UMT variants), InternVideo2 and the pre-training
PretrainVideoMAE.  The
port's parameters already carry the reference's torch names, so a ``.pth``
needs only the reference's key surgery (run_frame_finetuning.py:404-458):
'model' | 'module' unwrapping, 'backbone.' / 'encoder.' prefixes,
'encoder.norm' -> 'fc_norm' (so the encoder of a DAPT checkpoint loads
into the fine-tuning ViT), a K710 head remapped to 400/600/700 classes
(``_remap_710_head``), dropping a classifier head whose class count does
not match, and a learnable ``pos_embed`` of another spatial grid
resampled bicubically (``interpolate_pos_embed``).  A fixed ``pos_embed``
(sincos, 3-D, UMT) is never loaded (the port regenerates it); a
``cls_token`` loads where the model has one.  ``load_mae_checkpoint`` is
the pre-training CLI's ``--from_ckpt`` warm start: every key of the JAX
package's torch_to_mae_params must be in the file, and each is laid over
the initialised model (the JAX merge_params).  ``from_jax_params`` is the
inverse of the JAX package's torch_to_vit_params: JAX VisionTransformer
params (nested dicts of numpy arrays, blocks stacked on a leading depth
axis) -> a state dict; it reads the JAX PretrainVideoMAE tree too
(``encoder_patch_embed``, the scanned ``encoder`` / ``decoder`` stacks,
``encoder_to_decoder``, ``mask_token``, ``decoder_head`` and, with a
learnable encoder table, ``encoder_pos_embed``).
It also reads the JAX package's quantized, calibrated tree
(ops/quant.py there: ``qkv_q``/``kernel_q`` int8, ``*_scale``, the
``act_amax``/``qkv_amax``/``out_amax`` absmax) into the port's int8 model
state, so the port serves exactly the JAX package's int8 codes and scales.
``from_jax_params`` reads the JAX InternVideo2 tree too (its flat
``patch_kernel``/``patch_bias``, the scanned ``blocks`` unstacked, the
pooling head), fp or quantized and calibrated.  ``load_checkpoint_auto``
loads a reference ``.pth`` into either family: an InternVideo2 checkpoint
by name as it is (its learnable position table included), as the JAX
package's torch_to_iv2_params reads it.
It reads the JAX DistillInternVideo2 tree as well (the stage-2 student:
its ``patch_embed``, ``clip_pos_embed``, ``clip_decoder_<k>`` and
``final_clip_decoder``), and ``load_distill_checkpoint`` a reference
student ``.pth`` (the JAX torch_to_distill_iv2_params' keys; a teacher
``.pth`` is an InternVideo2 one, ``load_iv2_checkpoint``).
``load_iv2_mae_checkpoint`` is the IV2 DAPT warm start (the JAX
torch_to_iv2_mae_params + merge_params): a whole DAPT checkpoint by name,
or the encoder from an InternVideo2 trunk or stage-2 student ``.pth``, its
CLS position row dropped.  ``from_jax_params`` reads the JAX
PretrainIV2VideoMAE tree (``encoder_blocks`` stacked IV2 blocks,
``encoder_norm``) too.
``convert_vivit_state_dict`` turns a HuggingFace ViViT state dict into
the ViT's names (packed qkv, the learnable table cut to 8 temporal slots).
``to_jax_params`` is its inverse for the fp ViT, InternVideo2, the IV2
DAPT model and the distillation student (tests
compare gradients, updated parameters and optimizer moments leaf by leaf
with it).  ``load_checkpoint_auto`` (and ``load_vit_checkpoint``) also
initialise the fp32 training model of either family (cli/finetune.py
``--finetune``): values are copied into the model's own parameter dtype.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth file into {name: float32 CPU tensor}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = None
    for key in ("model", "module"):
        if isinstance(ckpt, dict) and key in ckpt:
            state = ckpt[key]
            break
    if state is None:
        state = ckpt
    return {k: (v.detach().to(torch.float32) if torch.is_tensor(v)
                else torch.as_tensor(np.asarray(v, np.float32)))
            for k, v in state.items()}


def remap_finetune_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """backbone./encoder. prefix stripping + encoder.norm -> fc_norm."""
    new = {}
    for key, val in sd.items():
        if key.startswith("backbone."):
            new[key[len("backbone."):]] = val
        elif key.startswith("encoder.norm"):
            new[key.replace("encoder.norm", "fc_norm")] = val
        elif key.startswith("encoder."):
            new[key[len("encoder."):]] = val
        else:
            new[key] = val
    return new


def _remap_710_head(head_w, head_b, num_classes: Optional[int],
                    head_label_map: Optional[Sequence[int]]):
    """A K710-pretrained 710-row classifier head -> the Kinetics finetune
    head (the IV2 reference's run_finetuning.py:388-400): 400 classes take
    the first 400 rows; 600 and 700 gather the rows ``head_label_map``
    names (the reference's k710/label_mixto{N}.json, a list of 710-space
    indices).  Any other mismatch comes back unchanged, for the caller's
    drop-the-head rule."""
    if (num_classes is None or head_w.shape[0] != 710
            or num_classes == 710):
        return head_w, head_b
    if num_classes == 400:
        return head_w[:400], head_b[:400]
    if num_classes in (600, 700):
        if head_label_map is not None:
            idx = torch.as_tensor(np.asarray(head_label_map, np.int64))
            if idx.shape != (num_classes,):
                raise ValueError(f"label map has {idx.shape[0]} entries, "
                                 f"expected {num_classes}")
            return head_w[idx], head_b[idx]
        # the IV2 reference always remaps 710 -> 600/700 by its label map;
        # without one the head is dropped and freshly initialised: say so
        warnings.warn(
            f"710-row pretrained head with nb_classes={num_classes} and no "
            "head_label_map: the head will be dropped and freshly "
            "initialized. The reference remaps it via "
            "k710/label_mixto{N}.json; pass that list as head_label_map "
            "to reproduce its runs.", stacklevel=3)
    return head_w, head_b


def _fit_head(sd, num_classes: int, head_label_map=None) -> None:
    """The checkpoint's classifier head for a ``num_classes`` model: a
    K710 head remapped, and a head of another class count not loaded (the
    model keeps its fresh head, run_frame_finetuning.py:414-417)."""
    if "head.weight" not in sd:
        return
    w, b = _remap_710_head(sd["head.weight"], sd["head.bias"], num_classes,
                           head_label_map)
    if w.shape[0] != num_classes:
        sd.pop("head.weight")
        sd.pop("head.bias", None)
    else:
        sd["head.weight"], sd["head.bias"] = w, b


def interpolate_pos_embed(pos: torch.Tensor, *, num_temporal: int,
                          new_size: int) -> torch.Tensor:
    """Bicubic spatial resampling of a (1, T * H * W, D) position table to
    a new_size x new_size grid (run_frame_finetuning.py:433-458)."""
    d = pos.shape[-1]
    orig_size = int((pos.shape[1] // num_temporal) ** 0.5)
    if orig_size == new_size:
        return pos
    t = pos.reshape(-1, num_temporal, orig_size, orig_size, d)
    t = t.reshape(-1, orig_size, orig_size, d).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(new_size, new_size), mode="bicubic",
                      align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(1, -1, d)


def load_vit_checkpoint(path: str, model, num_classes: Optional[int] = None,
                        head_label_map: Optional[Sequence[int]] = None):
    """Read a reference .pth into ``model`` by parameter name.

    Parameters the checkpoint lacks keep their values (a fresh head, for
    instance); checkpoint keys the model lacks are ignored; any other shape
    mismatch raises.  A learnable position table of another spatial grid is
    resampled to the model's.  Returns the names that were loaded."""
    sd = remap_finetune_keys(load_torch_state_dict(path))
    cfg = model.cfg
    if cfg.final_reduction == "fc_norm" and "fc_norm.weight" not in sd \
            and "norm.weight" in sd:
        # some MAE-encoder exports keep the final norm as 'norm'
        sd["fc_norm.weight"] = sd.pop("norm.weight")
        sd["fc_norm.bias"] = sd.pop("norm.bias")
    _fit_head(sd, cfg.num_classes if num_classes is None else num_classes,
              head_label_map)
    if not cfg.use_learnable_pos_emb:
        sd.pop("pos_embed", None)
    elif "pos_embed" in sd and \
            tuple(sd["pos_embed"].shape) != tuple(model.pos_embed.shape):
        sd["pos_embed"] = interpolate_pos_embed(
            sd["pos_embed"], num_temporal=cfg.all_frames // cfg.tubelet_size,
            new_size=cfg.img_size // cfg.patch_size)
    return _load_by_name(model, sd)


def load_iv2_checkpoint(path: str, model,
                        head_label_map: Optional[Sequence[int]] = None):
    """Read a reference InternVideo2 .pth into ``model`` by parameter name,
    with the rules of ``load_vit_checkpoint``; the position table is a
    learned parameter and is loaded.  Returns the names that were
    loaded."""
    sd = load_torch_state_dict(path)
    _fit_head(sd, model.cfg.num_classes, head_label_map)
    return _load_by_name(model, sd)


# the keys the JAX package's torch_to_mae_params reads besides the blocks
MAE_KEYS = ("encoder.patch_embed.proj.weight", "encoder.patch_embed.proj.bias",
            "encoder.norm.weight", "encoder.norm.bias",
            "encoder_to_decoder.weight", "mask_token",
            "decoder.norm.weight", "decoder.norm.bias",
            "decoder.head.weight", "decoder.head.bias")


def load_mae_checkpoint(path: str, model):
    """The pre-training warm start (``--from_ckpt``; the JAX CLI's
    torch_to_mae_params + merge_params): a reference VideoMAE pre-training
    .pth laid over the initialised PretrainVideoMAE by name.  Every key the
    JAX converter reads must be there (the patch embedding, both block
    stacks to the model's depths, the norms, encoder_to_decoder, the mask
    token and the decoder head).  The file's ``encoder.pos_embed`` (the
    reference's name; the port's own ``encoder_pos_embed`` too) loads into
    a learnable encoder table (``use_learnable_pos_emb``; the JAX
    converter reads none and keeps its initialisation) and is ignored by a
    fixed one.  Returns the names that were loaded."""
    sd = load_torch_state_dict(path)
    cfg = model.cfg
    need = list(MAE_KEYS) + [
        f"{part}.blocks.{i}.{leaf}"
        for part, depth in (("encoder", cfg.encoder_depth),
                            ("decoder", cfg.decoder_depth))
        for i in range(depth)
        for leaf in ("norm1.weight", "norm2.weight", "attn.qkv.weight",
                     "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.weight")]
    missing = [k for k in need if k not in sd]
    if missing:
        raise KeyError(f"{path} is not a VideoMAE pre-training checkpoint of "
                       f"this geometry: it lacks {missing[:4]}")
    if "encoder.pos_embed" in sd:
        sd["encoder_pos_embed"] = sd.pop("encoder.pos_embed")
    return _load_by_name(model, sd)


def load_iv2_mae_checkpoint(path: str, model):
    """The IV2 DAPT warm start (``--from_ckpt``; the JAX package's
    torch_to_iv2_mae_params + merge_params, after the reference's surgery,
    iv2_run_mae_double_pretraining.py:295-360) into PretrainIV2VideoMAE:

      * a DAPT checkpoint (``encoder.patch_embed.*`` ...): every key the
        JAX converter reads must be there, and all load by name;
      * an InternVideo2 trunk, fine-tuned or a stage-2 distillation
        student (``patch_embed.*``, ``blocks.*``, ``pos_embed`` with its
        CLS row): the encoder alone, the CLS position row dropped, and
        ``fc_norm`` (else ``norm``) as the encoder's final norm where its
        width is the encoder's.

    A tensor of another shape raises, as merge_params does.  Returns the
    names that were loaded."""
    sd = load_torch_state_dict(path)
    cfg = model.cfg
    blocks = [f"blocks.{i}.{leaf}" for i in range(cfg.encoder_depth)
              for leaf in ("norm1.weight", "norm2.weight", "ls1.gamma",
                           "ls2.gamma", "attn.qkv.weight", "attn.proj.weight",
                           "attn.proj.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                           "mlp.fc2.weight", "mlp.fc2.bias")]
    if "encoder.patch_embed.proj.weight" in sd:
        need = list(MAE_KEYS) + ["encoder." + k for k in blocks] + [
            f"decoder.blocks.{i}.{leaf}" for i in range(cfg.decoder_depth)
            for leaf in ("norm1.weight", "norm2.weight", "attn.qkv.weight",
                         "attn.proj.weight", "mlp.fc1.weight",
                         "mlp.fc2.weight")]
        renamed = dict(sd)
    else:
        need = ["patch_embed.proj.weight", "patch_embed.proj.bias"] + blocks
        renamed = {"encoder." + k: v for k, v in sd.items()
                   if k.startswith(("patch_embed.", "blocks.",
                                    "pos_embed_spatial",
                                    "pos_embed_temporal"))}
        if "pos_embed" in sd:
            renamed["encoder.pos_embed"] = sd["pos_embed"][:, 1:]
        D = cfg.encoder_embed_dim
        for norm in ("fc_norm", "norm"):
            if norm + ".weight" in sd and sd[norm + ".weight"].shape[0] == D:
                renamed["encoder.norm.weight"] = sd[norm + ".weight"]
                renamed["encoder.norm.bias"] = sd[norm + ".bias"]
                break
    missing = [k for k in need if k not in sd]
    if missing:
        raise KeyError(f"{path} is not an InternVideo2 checkpoint of this "
                       f"geometry: it lacks {missing[:4]}")
    return _load_by_name(model, renamed)


def load_distill_checkpoint(path: str, model):
    """Read a reference DistInternVideo2 (stage-2 student) .pth into the
    port's DistillInternVideo2 by name: the keys the JAX package's
    torch_to_distill_iv2_params reads (the patch embedding, CLS token, both
    position tables, the blocks, the pooling head, the K tap decoders) must
    all be there; the final decoder loads where the file has one.  Returns
    the names that were loaded."""
    sd = load_torch_state_dict(path)
    missing = [k for k in model.state_dict() if k not in sd
               and not k.startswith(("final_clip_decoder.",
                                     "clip_projector."))]
    if "final_clip_decoder.norm.weight" in sd:
        missing += [k for k in model.state_dict() if k not in sd
                    and k.startswith(("final_clip_decoder.",
                                      "clip_projector."))]
    if missing:
        raise KeyError(f"{path} is not a distillation student checkpoint of "
                       f"this geometry: it lacks {missing[:4]}")
    return _load_by_name(model, sd)


def load_checkpoint_auto(path: str, model,
                         head_label_map: Optional[Sequence[int]] = None):
    """Model-aware .pth loader: InternVideo2, its distillation student,
    PretrainIV2VideoMAE, PretrainVideoMAE or the ViT
    (``head_label_map``: the K710 head remap indices of a 600/700-class
    fine-tune)."""
    from simple_tad_tpu_torch.models.internvideo2 import InternVideo2
    from simple_tad_tpu_torch.models.iv2_distill import DistillInternVideo2
    from simple_tad_tpu_torch.models.mae import (PretrainIV2VideoMAE,
                                                 PretrainVideoMAE)
    if isinstance(model, DistillInternVideo2):
        return load_distill_checkpoint(path, model)
    if isinstance(model, InternVideo2):
        return load_iv2_checkpoint(path, model, head_label_map)
    if isinstance(model, PretrainIV2VideoMAE):
        return load_iv2_mae_checkpoint(path, model)
    if isinstance(model, PretrainVideoMAE):
        return load_mae_checkpoint(path, model)
    return load_vit_checkpoint(path, model, head_label_map=head_label_map)



def convert_vivit_state_dict(hf_sd: Mapping[str, Any], *, depth: int = 12,
                             num_temp_vivit: int = 16,
                             num_temp_target: int = 8
                             ) -> Dict[str, torch.Tensor]:
    """HuggingFace ViViT state dict (tensors or numpy arrays) -> the
    VideoMAE-named fp32 state dict of the port's ViT.

    Port of the JAX package's convert_vivit_state_dict (reference:
    other_models/ViViT/ckpt_vivit.py:56-190): the separate q/k/v
    projections merge into one packed qkv weight (the k bias dropped: the
    ViT's qkv has an implicit zero k bias), the layernorms are renamed
    (``layernorm_before`` -> ``norm1``, ``layernorm_after`` -> ``norm2``,
    the final ``layernorm`` -> ``fc_norm``), the CLS token is dropped, and
    the learnable position table loses its CLS slot and is interpolated
    trilinearly from ``num_temp_vivit`` to ``num_temp_target`` temporal
    slots.  Save it as a ``.pth`` and read it with ``load_vit_checkpoint``
    into a ViT built with ``use_learnable_pos_emb=True``."""
    def t(key):
        return torch.as_tensor(np.asarray(hf_sd[key], np.float32))

    out: Dict[str, torch.Tensor] = {}
    basic = {
        "embeddings.patch_embeddings.projection.weight":
            "patch_embed.proj.weight",
        "embeddings.patch_embeddings.projection.bias":
            "patch_embed.proj.bias",
        "layernorm.weight": "fc_norm.weight",
        "layernorm.bias": "fc_norm.bias",
    }
    per_block = {
        "layernorm_before.weight": "norm1.weight",
        "layernorm_before.bias": "norm1.bias",
        "attention.output.dense.weight": "attn.proj.weight",
        "attention.output.dense.bias": "attn.proj.bias",
        "layernorm_after.weight": "norm2.weight",
        "layernorm_after.bias": "norm2.bias",
        "intermediate.dense.weight": "mlp.fc1.weight",
        "intermediate.dense.bias": "mlp.fc1.bias",
        "output.dense.weight": "mlp.fc2.weight",
        "output.dense.bias": "mlp.fc2.bias",
    }
    for src, dst in basic.items():
        if src in hf_sd:
            out[dst] = t(src)
    for i in range(depth):
        pre = f"encoder.layer.{i}."
        for src, dst in per_block.items():
            out[f"blocks.{i}.{dst}"] = t(pre + src)
        att = pre + "attention.attention."
        out[f"blocks.{i}.attn.qkv.weight"] = torch.cat(
            [t(att + f"{x}.weight") for x in ("query", "key", "value")])
        out[f"blocks.{i}.attn.q_bias"] = t(att + "query.bias")
        out[f"blocks.{i}.attn.v_bias"] = t(att + "value.bias")

    pos_key = "embeddings.position_embeddings"
    if pos_key in hf_sd:
        pos = t(pos_key)[:, 1:]                          # drop the CLS slot
        n, d = pos.shape[1], pos.shape[2]
        hw = int(round((n // num_temp_vivit) ** 0.5))
        pos = pos.reshape(1, num_temp_vivit, hw, hw, d).permute(0, 4, 1, 2, 3)
        pos = F.interpolate(pos, size=(num_temp_target, hw, hw),
                            mode="trilinear", align_corners=False)
        out["pos_embed"] = pos.permute(0, 2, 3, 4, 1).reshape(1, -1, d)
    return {k: v.contiguous() for k, v in out.items()}

def _load_by_name(model, sd):
    own = model.state_dict()
    loaded = {}
    for key, val in sd.items():
        if key not in own:
            continue
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: ckpt "
                             f"{tuple(val.shape)} vs model "
                             f"{tuple(own[key].shape)}")
        loaded[key] = val
    model.load_state_dict(loaded, strict=False)
    return sorted(loaded)


def _f32(a):
    """A writable fp32 numpy copy (JAX arrays are not writable)."""
    return np.array(a, np.float32)


def _conv3d_from_kernel(kernel, tubelet_size: int, in_chans: int):
    """(t*p*p*c, D) patch kernel in (t, h, w, c) row order -> the reference
    Conv3d weight (D, c, t, p, p)."""
    rows, dim = kernel.shape
    p = int(round((rows // (tubelet_size * in_chans)) ** 0.5))
    return np.ascontiguousarray(
        kernel.reshape(tubelet_size, p, p, in_chans, dim)
        .transpose(4, 3, 0, 1, 2))


def from_jax_params(params: Mapping[str, Any], *,
                    tubelet_size: Optional[int] = None,
                    in_chans: int = 3) -> Dict[str, torch.Tensor]:
    """JAX VisionTransformer or InternVideo2 params -> reference-named state
    dict: fp32, with int8 ``weight_q`` where the tree is quantized.
    ``tubelet_size`` defaults to the family's (ViT 2, InternVideo2 1)."""
    if "patch_kernel" in params:
        return _from_jax_iv2(params, tubelet_size or 1, in_chans)
    if "clip_pos_embed" in params:
        return _from_jax_distill(params, tubelet_size or 1, in_chans)
    if "encoder_blocks" in params:
        return _from_jax_iv2_mae(params, tubelet_size or 1, in_chans)
    if "encoder_patch_embed" in params:
        return _from_jax_mae(params, tubelet_size or 2, in_chans)

    out: Dict[str, np.ndarray] = {}
    out["patch_embed.proj.weight"] = _conv3d_from_kernel(
        _f32(params["patch_embed"]["kernel"]), tubelet_size or 2, in_chans)
    out["patch_embed.proj.bias"] = _f32(params["patch_embed"]["bias"])
    for key in ("cls_token", "pos_embed"):
        if key in params:
            out[key] = _f32(params[key])
    _vit_blocks(out, params["blocks"], "blocks.")
    for norm in ("fc_norm", "norm"):
        if norm in params:
            out[norm + ".weight"] = _f32(params[norm]["scale"])
            out[norm + ".bias"] = _f32(params[norm]["bias"])
    if "head" in params:
        _dense_leaves(out, "head", params["head"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _from_jax_mae(params, tubelet_size: int, in_chans: int):
    """The JAX PretrainVideoMAE tree (both stacks scanned) -> the
    reference-named state dict."""
    out = _from_jax_mae_common(params, tubelet_size, in_chans)
    if "encoder_pos_embed" in params:         # the learnable encoder table
        out["encoder_pos_embed"] = _f32(params["encoder_pos_embed"])
    _vit_blocks(out, params["encoder"]["blocks"], "encoder.blocks.")
    out["encoder.norm.weight"] = _f32(params["encoder"]["norm"]["scale"])
    out["encoder.norm.bias"] = _f32(params["encoder"]["norm"]["bias"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _from_jax_iv2_mae(params, tubelet_size: int, in_chans: int):
    """The JAX PretrainIV2VideoMAE tree (``encoder_blocks`` scanned IV2
    blocks, ``encoder_norm``, the learnable position tables) -> the
    reference-named state dict."""
    out = _from_jax_mae_common(params, tubelet_size, in_chans)
    for key in ("pos_embed", "pos_embed_spatial", "pos_embed_temporal"):
        if key in params:
            out["encoder." + key] = _f32(params[key])
    _from_jax_iv2_blocks(out, params["encoder_blocks"], "encoder.blocks.")
    out["encoder.norm.weight"] = _f32(params["encoder_norm"]["scale"])
    out["encoder.norm.bias"] = _f32(params["encoder_norm"]["bias"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _from_jax_mae_common(params, tubelet_size: int, in_chans: int):
    """The leaves both JAX pre-training trees share: the patch embedding,
    encoder_to_decoder, the mask token and the decoder."""
    out: Dict[str, np.ndarray] = {
        "encoder.patch_embed.proj.weight": _conv3d_from_kernel(
            _f32(params["encoder_patch_embed"]["kernel"]), tubelet_size,
            in_chans),
        "encoder.patch_embed.proj.bias": _f32(
            params["encoder_patch_embed"]["bias"]),
        "encoder_to_decoder.weight": np.ascontiguousarray(
            _f32(params["encoder_to_decoder"]["kernel"]).T),
        "mask_token": _f32(params["mask_token"])}
    _vit_blocks(out, params["decoder"]["blocks"], "decoder.blocks.")
    out["decoder.norm.weight"] = _f32(params["decoder"]["norm"]["scale"])
    out["decoder.norm.bias"] = _f32(params["decoder"]["norm"]["bias"])
    _dense_leaves(out, "decoder.head", params["decoder_head"])
    return out


def _vit_blocks(out, blocks, prefix: str) -> None:
    """The ViT's scanned block stack (leaves stacked on a leading depth
    axis) into ``out`` under ``prefix``<i>."""
    attn, mlp = blocks["attn"], blocks["mlp"]
    for i in range(np.shape(blocks["norm1"]["scale"])[0]):
        pre = f"{prefix}{i}."
        for norm in ("norm1", "norm2"):
            out[pre + norm + ".weight"] = _f32(blocks[norm]["scale"][i])
            out[pre + norm + ".bias"] = _f32(blocks[norm]["bias"][i])
            if "act_amax" in blocks[norm]:
                out[pre + norm + ".act_amax"] = _f32(
                    blocks[norm]["act_amax"][i])
        # the packed qkv Dense keeps its leaves in the attention scope
        qkv = {k: attn[j] for j, k in (
            ("qkv_kernel", "kernel"), ("qkv_q", "kernel_q"),
            ("qkv_scale", "kernel_scale"), ("act_amax", "act_amax"))
            if j in attn}
        _dense_leaves(out, pre + "attn.qkv", qkv, i)
        for name in ("q_bias", "v_bias", "qkv_amax", "out_amax"):
            if name in attn:
                out[pre + "attn." + name] = _f32(attn[name][i])
        _dense_leaves(out, pre + "attn.proj", attn["proj"], i)
        for fc in ("fc1", "fc2"):
            _dense_leaves(out, pre + f"mlp.{fc}", mlp[fc], i)
        if "gamma_1" in blocks:
            out[pre + "gamma_1"] = _f32(blocks["gamma_1"][i])
            out[pre + "gamma_2"] = _f32(blocks["gamma_2"][i])


def _dense_leaves(out, name, leaves, i=None):
    """One JAX Dense (``kernel``, or int8 ``kernel_q`` + ``kernel_scale``,
    with ``bias`` and a calibrated ``act_amax``) into ``out`` under the
    torch ``name``; ``i`` picks one layer of a stacked tree."""
    def pick(a):
        return np.asarray(a if i is None else a[i])

    if "kernel_q" in leaves:
        out[name + ".weight_q"] = np.ascontiguousarray(
            pick(leaves["kernel_q"]).astype(np.int8).T)
        out[name + ".weight_scale"] = pick(leaves["kernel_scale"]).astype(
            np.float32)
    else:
        out[name + ".weight"] = np.ascontiguousarray(
            pick(leaves["kernel"]).astype(np.float32).T)
    for key in ("act_amax", "bias"):
        if key in leaves:
            out[f"{name}.{key}"] = pick(leaves[key]).astype(np.float32)


def _from_jax_iv2(params, tubelet_size: int, in_chans: int):
    """The JAX InternVideo2 tree (blocks scanned: stacked on a leading depth
    axis) -> reference-named state dict."""
    out: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _conv3d_from_kernel(
            _f32(params["patch_kernel"]), tubelet_size, in_chans),
        "patch_embed.proj.bias": _f32(params["patch_bias"]),
        "cls_token": _f32(params["cls_token"])}
    for key in ("pos_embed", "pos_embed_spatial", "pos_embed_temporal",
                "pos_embed_cls"):
        if key in params:
            out[key] = _f32(params[key])
    _from_jax_iv2_blocks(out, params["blocks"])
    _from_jax_pool(out, params["clip_projector"])
    out["fc_norm.weight"] = _f32(params["fc_norm"]["scale"])
    out["fc_norm.bias"] = _f32(params["fc_norm"]["bias"])
    if "head" in params:
        _dense_leaves(out, "head", params["head"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _from_jax_iv2_blocks(out, blocks, prefix: str = "blocks.") -> None:
    """The JAX InternVideo2 block stack (scanned: leaves stacked on a
    leading depth axis) into ``out`` under ``prefix``<i>."""
    attn = blocks["attn"]
    for i in range(np.shape(blocks["norm1"]["scale"])[0]):
        pre = f"{prefix}{i}."
        for norm in ("norm1", "norm2"):
            out[pre + norm + ".weight"] = _f32(blocks[norm]["scale"][i])
            if "act_amax" in blocks[norm]:
                out[pre + norm + ".act_amax"] = _f32(
                    blocks[norm]["act_amax"][i])
        out[pre + "ls1.gamma"] = _f32(blocks["gamma_1"][i])
        out[pre + "ls2.gamma"] = _f32(blocks["gamma_2"][i])
        _dense_leaves(out, pre + "attn.qkv", attn["qkv"], i)
        _dense_leaves(out, pre + "attn.proj", attn["proj"], i)
        for norm in ("q_norm", "k_norm"):
            if norm in attn:
                out[pre + f"attn.{norm}.weight"] = _f32(
                    attn[norm]["scale"][i])
        for name in ("qkv_amax", "out_amax"):
            if name in attn:
                out[pre + "attn." + name] = _f32(attn[name][i])
        for fc in ("fc1", "fc2"):
            _dense_leaves(out, pre + f"mlp.{fc}", blocks[fc], i)


def _from_jax_pool(out, pool) -> None:
    """The JAX attention-pooling head into ``out`` under clip_projector."""
    for side in ("q", "k", "v"):
        norm = pool[f"norm_{side}"]
        out[f"clip_projector.norm1_{side}.weight"] = _f32(norm["scale"])
        out[f"clip_projector.norm1_{side}.bias"] = _f32(norm["bias"])
        out[f"clip_projector.cross_attn.{side}.weight"] = np.ascontiguousarray(
            _f32(pool[f"{side}_kernel"]).T)
        out[f"clip_projector.cross_attn.{side}_bias"] = _f32(
            pool[f"{side}_bias"])
    _dense_leaves(out, "clip_projector.cross_attn.proj", pool["proj"])


def _from_jax_distill(params, tubelet_size: int, in_chans: int):
    """The JAX DistillInternVideo2 tree (its patch_embed Dense, the scanned
    ``blocks``, ``clip_decoder_<k>`` and ``final_clip_decoder``) -> the
    reference-named state dict."""
    out: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _conv3d_from_kernel(
            _f32(params["patch_embed"]["kernel"]), tubelet_size, in_chans),
        "patch_embed.proj.bias": _f32(params["patch_embed"]["bias"])}
    for key in ("cls_token", "pos_embed", "clip_pos_embed"):
        out[key] = _f32(params[key])
    _from_jax_iv2_blocks(out, params["blocks"])
    for name, tree in params.items():
        if name.startswith("clip_decoder_"):
            _from_jax_decoder(out, f"clip_decoder.{name.split('_')[-1]}",
                              tree)
    if "final_clip_decoder" in params:
        _from_jax_pool(out, params["clip_projector"])
        _from_jax_decoder(out, "final_clip_decoder",
                          params["final_clip_decoder"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _from_jax_decoder(out, prefix: str, tree) -> None:
    """A JAX FeatureDecoder (``head``, or ``fc1`` / ``fc2``, and ``norm``)
    into ``out`` under the reference's names (the MLP's Sequential indices
    head.0 / head.2)."""
    out[prefix + ".norm.weight"] = _f32(tree["norm"]["scale"])
    out[prefix + ".norm.bias"] = _f32(tree["norm"]["bias"])
    if "head" in tree:
        _dense_leaves(out, prefix + ".head", tree["head"])
    else:
        _dense_leaves(out, prefix + ".head.0", tree["fc1"])
        _dense_leaves(out, prefix + ".head.2", tree["fc2"])


class _Leaves:
    """A state dict read as the fp32 numpy leaves of a JAX tree."""

    def __init__(self, state: Mapping[str, torch.Tensor]):
        self.state = state

    def __contains__(self, name: str) -> bool:
        return name in self.state

    def arr(self, name: str) -> np.ndarray:
        return self.state[name].detach().float().cpu().numpy()

    def dense(self, name: str) -> Dict[str, np.ndarray]:
        leaves = {"kernel": self.arr(name + ".weight").T}
        if name + ".bias" in self:
            leaves["bias"] = self.arr(name + ".bias")
        return leaves

    def norm(self, name: str, bias: bool = True) -> Dict[str, np.ndarray]:
        leaves = {"scale": self.arr(name + ".weight")}
        if bias:
            leaves["bias"] = self.arr(name + ".bias")
        return leaves


def _stacked(layers) -> Dict[str, Any]:
    """Per-layer trees -> one tree, each leaf stacked on a leading depth
    axis (the scanned blocks)."""
    def stack(trees):
        return {k: (stack([t[k] for t in trees]) if isinstance(v, dict)
                    else np.stack([t[k] for t in trees]))
                for k, v in trees[0].items()}
    return stack(list(layers))


def _vit_layer(r: _Leaves, pre: str) -> Dict[str, Any]:
    attn = {"qkv_kernel": r.arr(pre + "attn.qkv.weight").T,
            "proj": r.dense(pre + "attn.proj")}
    for name in ("q_bias", "v_bias"):
        if pre + "attn." + name in r:
            attn[name] = r.arr(pre + "attn." + name)
    leaves = {"norm1": r.norm(pre + "norm1"), "norm2": r.norm(pre + "norm2"),
              "attn": attn,
              "mlp": {fc: r.dense(pre + f"mlp.{fc}") for fc in ("fc1", "fc2")}}
    if pre + "gamma_1" in r:
        leaves["gamma_1"] = r.arr(pre + "gamma_1")
        leaves["gamma_2"] = r.arr(pre + "gamma_2")
    return leaves


def _iv2_layer(r: _Leaves, pre: str) -> Dict[str, Any]:
    attn = {"qkv": r.dense(pre + "attn.qkv"),
            "proj": r.dense(pre + "attn.proj")}
    for norm in ("q_norm", "k_norm"):
        if pre + f"attn.{norm}.weight" in r:
            attn[norm] = r.norm(pre + f"attn.{norm}", bias=False)
    return {"norm1": r.norm(pre + "norm1", bias=False),
            "norm2": r.norm(pre + "norm2", bias=False),
            "gamma_1": r.arr(pre + "ls1.gamma"),
            "gamma_2": r.arr(pre + "ls2.gamma"), "attn": attn,
            "fc1": r.dense(pre + "mlp.fc1"), "fc2": r.dense(pre + "mlp.fc2")}


def _patch_kernel(r: _Leaves, name: str) -> np.ndarray:
    w = r.arr(name)                                     # (D, c, t, p, p)
    return np.ascontiguousarray(
        w.transpose(2, 3, 4, 1, 0).reshape(-1, w.shape[0]))


def _depth(state, prefix: str) -> int:
    return 1 + max(int(k[len(prefix):].split(".")[0]) for k in state
                   if k.startswith(prefix))


def _to_jax_mae(r: _Leaves, state) -> Dict[str, Any]:
    """PretrainVideoMAE's tree, or PretrainIV2VideoMAE's (IV2 encoder
    blocks)."""
    out: Dict[str, Any] = {
        "encoder_patch_embed": {
            "kernel": _patch_kernel(r, "encoder.patch_embed.proj.weight"),
            "bias": r.arr("encoder.patch_embed.proj.bias")},
        "encoder_to_decoder": {"kernel": r.arr(
            "encoder_to_decoder.weight").T},
        "mask_token": r.arr("mask_token"),
        "decoder_head": r.dense("decoder.head")}
    parts = ["decoder"]
    if "encoder.blocks.0.ls1.gamma" in r:
        pre = "encoder.blocks."
        out["encoder_blocks"] = _stacked(_iv2_layer(r, f"{pre}{i}.")
                                         for i in range(_depth(state, pre)))
        out["encoder_norm"] = r.norm("encoder.norm")
        for key in ("pos_embed", "pos_embed_spatial", "pos_embed_temporal"):
            if "encoder." + key in r:
                out[key] = r.arr("encoder." + key)
    else:
        parts.append("encoder")
        if "encoder_pos_embed" in r:
            out["encoder_pos_embed"] = r.arr("encoder_pos_embed")
    for part in parts:
        pre = f"{part}.blocks."
        out[part] = {"blocks": _stacked(_vit_layer(r, f"{pre}{i}.")
                                        for i in range(_depth(state, pre))),
                     "norm": r.norm(f"{part}.norm")}
    return out


def _to_jax_pool(r: _Leaves) -> Dict[str, Any]:
    pool = {"proj": r.dense("clip_projector.cross_attn.proj")}
    for side in ("q", "k", "v"):
        pool[f"norm_{side}"] = r.norm(f"clip_projector.norm1_{side}")
        pool[f"{side}_kernel"] = r.arr(
            f"clip_projector.cross_attn.{side}.weight").T
        pool[f"{side}_bias"] = r.arr(f"clip_projector.cross_attn.{side}_bias")
    return pool


def _to_jax_decoder(r: _Leaves, prefix: str) -> Dict[str, Any]:
    tree = {"norm": r.norm(prefix + ".norm")}
    if prefix + ".head.weight" in r:
        tree["head"] = r.dense(prefix + ".head")
    else:
        tree["fc1"] = r.dense(prefix + ".head.0")
        tree["fc2"] = r.dense(prefix + ".head.2")
    return tree


def _to_jax_distill(r: _Leaves, state) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "patch_embed": {"kernel": _patch_kernel(r, "patch_embed.proj.weight"),
                        "bias": r.arr("patch_embed.proj.bias")},
        "blocks": _stacked(_iv2_layer(r, f"blocks.{i}.")
                           for i in range(_depth(state, "blocks.")))}
    for key in ("cls_token", "pos_embed", "clip_pos_embed"):
        out[key] = r.arr(key)
    for k in range(_depth(state, "clip_decoder.")):
        out[f"clip_decoder_{k}"] = _to_jax_decoder(r, f"clip_decoder.{k}")
    if "final_clip_decoder.norm.weight" in r:
        out["clip_projector"] = _to_jax_pool(r)
        out["final_clip_decoder"] = _to_jax_decoder(r, "final_clip_decoder")
    return out


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``from_jax_params`` for the fp model: a reference-named
    state dict (or any dict keyed by the model's parameter names, such as
    its gradients or Adam moments) -> the JAX VisionTransformer,
    InternVideo2, PretrainVideoMAE or PretrainIV2VideoMAE tree of fp32
    numpy arrays, blocks
    stacked on a leading depth axis (InternVideo2: its flat
    ``patch_kernel``/``patch_bias`` and the pooling head, the inverse of
    ``_from_jax_iv2``)."""
    r = _Leaves(state)
    if "encoder.patch_embed.proj.weight" in r:
        return _to_jax_mae(r, state)
    if "clip_pos_embed" in r:
        return _to_jax_distill(r, state)
    iv2 = "blocks.0.ls1.gamma" in r
    kernel = _patch_kernel(r, "patch_embed.proj.weight")
    bias = r.arr("patch_embed.proj.bias")
    layer = _iv2_layer if iv2 else _vit_layer
    out: Dict[str, Any] = {
        "blocks": _stacked(layer(r, f"blocks.{i}.")
                           for i in range(_depth(state, "blocks.")))}
    if iv2:
        out.update(patch_kernel=kernel, patch_bias=bias,
                   cls_token=r.arr("cls_token"))
        for key in ("pos_embed", "pos_embed_spatial", "pos_embed_temporal",
                    "pos_embed_cls"):
            if key in r:
                out[key] = r.arr(key)
        out["clip_projector"] = _to_jax_pool(r)
    else:
        out["patch_embed"] = {"kernel": kernel, "bias": bias}
        for key in ("cls_token", "pos_embed"):
            if key in r:
                out[key] = r.arr(key)
    for norm in ("fc_norm", "norm"):
        if norm + ".weight" in r:
            out[norm] = r.norm(norm)
    if "head.weight" in r:
        out["head"] = r.dense("head")
    return out
