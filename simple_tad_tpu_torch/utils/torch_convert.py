"""Checkpoints into the port's models: reference ``.pth`` files and JAX
params.

Port of simple_tad_tpu/utils/torch_convert.py for the VideoMAE ViT and
InternVideo2.  The
port's parameters already carry the reference's torch names, so a ``.pth``
needs only the reference's key surgery (run_frame_finetuning.py:404-430):
'model' | 'module' unwrapping, 'backbone.' / 'encoder.' prefixes,
'encoder.norm' -> 'fc_norm', and dropping a classifier head whose class
count does not match.  A fixed sincos ``pos_embed`` is never loaded (the
port regenerates it).  ``from_jax_params`` is the inverse of the JAX
package's torch_to_vit_params: JAX VisionTransformer params (nested dicts
of numpy arrays, blocks stacked on a leading depth axis) -> a state dict.
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
``to_jax_params`` is its inverse for the fp ViT (tests compare
gradients, updated parameters and optimizer moments leaf by leaf with
it).  ``load_vit_checkpoint`` also initialises the fp32 training model
(cli/finetune.py ``--finetune``): values are copied into the model's own
parameter dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


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


def _drop_mismatched_head(sd, num_classes: int) -> None:
    """A classifier head of another class count is not loaded (the model
    keeps its fresh head, run_frame_finetuning.py:414-417)."""
    if "head.weight" in sd and sd["head.weight"].shape[0] != num_classes:
        sd.pop("head.weight")
        sd.pop("head.bias", None)


def load_vit_checkpoint(path: str, model, num_classes: Optional[int] = None):
    """Read a reference .pth into ``model`` by parameter name.

    Parameters the checkpoint lacks keep their values (a fresh head, for
    instance); checkpoint keys the model lacks are ignored; any other shape
    mismatch raises.  Returns the names that were loaded."""
    sd = remap_finetune_keys(load_torch_state_dict(path))
    cfg = model.cfg
    if cfg.final_reduction == "fc_norm" and "fc_norm.weight" not in sd \
            and "norm.weight" in sd:
        # some MAE-encoder exports keep the final norm as 'norm'
        sd["fc_norm.weight"] = sd.pop("norm.weight")
        sd["fc_norm.bias"] = sd.pop("norm.bias")
    _drop_mismatched_head(sd, cfg.num_classes if num_classes is None
                          else num_classes)
    sd.pop("pos_embed", None)
    return _load_by_name(model, sd)


def load_iv2_checkpoint(path: str, model):
    """Read a reference InternVideo2 .pth into ``model`` by parameter name,
    with the rules of ``load_vit_checkpoint``; the position table is a
    learned parameter and is loaded.  Returns the names that were
    loaded."""
    sd = load_torch_state_dict(path)
    _drop_mismatched_head(sd, model.cfg.num_classes)
    return _load_by_name(model, sd)


def load_checkpoint_auto(path: str, model):
    """Model-aware .pth loader: InternVideo2 or the ViT."""
    from simple_tad_tpu_torch.models.internvideo2 import InternVideo2
    if isinstance(model, InternVideo2):
        return load_iv2_checkpoint(path, model)
    return load_vit_checkpoint(path, model)


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

    out: Dict[str, np.ndarray] = {}
    out["patch_embed.proj.weight"] = _conv3d_from_kernel(
        _f32(params["patch_embed"]["kernel"]), tubelet_size or 2, in_chans)
    out["patch_embed.proj.bias"] = _f32(params["patch_embed"]["bias"])

    blocks = params["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    for i in range(np.shape(blocks["norm1"]["scale"])[0]):
        pre = f"blocks.{i}."
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
    for norm in ("fc_norm", "norm"):
        if norm in params:
            out[norm + ".weight"] = _f32(params[norm]["scale"])
            out[norm + ".bias"] = _f32(params[norm]["bias"])
    if "head" in params:
        _dense_leaves(out, "head", params["head"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


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
    blocks = params["blocks"]
    attn = blocks["attn"]
    for i in range(np.shape(blocks["norm1"]["scale"])[0]):
        pre = f"blocks.{i}."
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
    pool = params["clip_projector"]
    for side in ("q", "k", "v"):
        norm = pool[f"norm_{side}"]
        out[f"clip_projector.norm1_{side}.weight"] = _f32(norm["scale"])
        out[f"clip_projector.norm1_{side}.bias"] = _f32(norm["bias"])
        out[f"clip_projector.cross_attn.{side}.weight"] = np.ascontiguousarray(
            _f32(pool[f"{side}_kernel"]).T)
        out[f"clip_projector.cross_attn.{side}_bias"] = _f32(
            pool[f"{side}_bias"])
    _dense_leaves(out, "clip_projector.cross_attn.proj", pool["proj"])
    out["fc_norm.weight"] = _f32(params["fc_norm"]["scale"])
    out["fc_norm.bias"] = _f32(params["fc_norm"]["bias"])
    if "head" in params:
        _dense_leaves(out, "head", params["head"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def to_jax_params(state: Mapping[str, torch.Tensor], *,
                  tubelet_size: int = 2,
                  in_chans: int = 3) -> Dict[str, Any]:
    """Inverse of ``from_jax_params`` for the fp model: a reference-named
    state dict (or any dict keyed by the model's parameter names, such as
    its gradients or Adam moments) -> the JAX VisionTransformer tree of
    fp32 numpy arrays, blocks stacked on a leading depth axis."""
    def arr(name):
        return state[name].detach().float().cpu().numpy()

    def dense(name):
        leaves = {"kernel": arr(name + ".weight").T}
        if name + ".bias" in state:
            leaves["bias"] = arr(name + ".bias")
        return leaves

    def stack(leaves):
        return {k: (stack(v) if isinstance(v, dict) else np.stack(v))
                for k, v in leaves.items()}

    def append(tree, leaves):
        for k, v in leaves.items():
            if isinstance(v, dict):
                append(tree.setdefault(k, {}), v)
            else:
                tree.setdefault(k, []).append(v)

    out: Dict[str, Any] = {}
    w = arr("patch_embed.proj.weight")                  # (D, c, t, p, p)
    out["patch_embed"] = {
        "kernel": np.ascontiguousarray(
            w.transpose(2, 3, 4, 1, 0).reshape(-1, w.shape[0])),
        "bias": arr("patch_embed.proj.bias")}
    depth = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith("blocks."))
    blocks: Dict[str, Any] = {}
    for i in range(depth):
        pre = f"blocks.{i}."
        leaves = {norm: {"scale": arr(pre + norm + ".weight"),
                         "bias": arr(pre + norm + ".bias")}
                  for norm in ("norm1", "norm2")}
        attn = {"qkv_kernel": arr(pre + "attn.qkv.weight").T,
                "proj": dense(pre + "attn.proj")}
        for name in ("q_bias", "v_bias"):
            if pre + "attn." + name in state:
                attn[name] = arr(pre + "attn." + name)
        leaves["attn"] = attn
        leaves["mlp"] = {fc: dense(pre + f"mlp.{fc}") for fc in ("fc1", "fc2")}
        if pre + "gamma_1" in state:
            leaves["gamma_1"] = arr(pre + "gamma_1")
            leaves["gamma_2"] = arr(pre + "gamma_2")
        append(blocks, leaves)
    out["blocks"] = stack(blocks)
    for norm in ("fc_norm", "norm"):
        if norm + ".weight" in state:
            out[norm] = {"scale": arr(norm + ".weight"),
                         "bias": arr(norm + ".bias")}
    if "head.weight" in state:
        out["head"] = dense("head")
    return out
