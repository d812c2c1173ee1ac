"""Checkpoints into the port's ViT: reference ``.pth`` files and JAX params.

Port of simple_tad_tpu/utils/torch_convert.py for the VideoMAE ViT.  The
port's parameters already carry the reference's torch names, so a ``.pth``
needs only the reference's key surgery (run_frame_finetuning.py:404-430):
'model' | 'module' unwrapping, 'backbone.' / 'encoder.' prefixes,
'encoder.norm' -> 'fc_norm', and dropping a classifier head whose class
count does not match.  A fixed sincos ``pos_embed`` is never loaded (the
port regenerates it).  ``from_jax_params`` is the inverse of the JAX
package's torch_to_vit_params: JAX VisionTransformer params (nested dicts
of numpy arrays, blocks stacked on a leading depth axis) -> a state dict.
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


def load_vit_checkpoint(path: str, model, num_classes: Optional[int] = None):
    """Read a reference .pth into ``model`` by parameter name.

    Parameters the checkpoint lacks keep their values (a fresh head, for
    instance); checkpoint keys the model lacks are ignored; any other shape
    mismatch raises.  Returns the names that were loaded."""
    sd = remap_finetune_keys(load_torch_state_dict(path))
    cfg = model.cfg
    num_classes = cfg.num_classes if num_classes is None else num_classes
    if cfg.final_reduction == "fc_norm" and "fc_norm.weight" not in sd \
            and "norm.weight" in sd:
        # some MAE-encoder exports keep the final norm as 'norm'
        sd["fc_norm.weight"] = sd.pop("norm.weight")
        sd["fc_norm.bias"] = sd.pop("norm.bias")
    if "head.weight" in sd and sd["head.weight"].shape[0] != num_classes:
        sd.pop("head.weight")
        sd.pop("head.bias", None)
    sd.pop("pos_embed", None)
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


def from_jax_params(params: Mapping[str, Any], *, tubelet_size: int = 2,
                    in_chans: int = 3) -> Dict[str, torch.Tensor]:
    """JAX VisionTransformer params -> reference-named fp32 state dict."""
    def arr(a):
        return np.asarray(a, np.float32)

    def t(a):                                   # Dense (in, out) -> (out, in)
        return np.ascontiguousarray(arr(a).T)

    out: Dict[str, np.ndarray] = {}
    kernel = arr(params["patch_embed"]["kernel"])           # (t*p*p*c, D)
    rows, dim = kernel.shape
    p = int(round((rows // (tubelet_size * in_chans)) ** 0.5))
    out["patch_embed.proj.weight"] = np.ascontiguousarray(
        kernel.reshape(tubelet_size, p, p, in_chans, dim)
        .transpose(4, 3, 0, 1, 2))
    out["patch_embed.proj.bias"] = arr(params["patch_embed"]["bias"])

    blocks = params["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    depth = arr(blocks["norm1"]["scale"]).shape[0]
    for i in range(depth):
        pre = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[pre + norm + ".weight"] = arr(blocks[norm]["scale"][i])
            out[pre + norm + ".bias"] = arr(blocks[norm]["bias"][i])
        out[pre + "attn.qkv.weight"] = t(attn["qkv_kernel"][i])
        if "q_bias" in attn:
            out[pre + "attn.q_bias"] = arr(attn["q_bias"][i])
            out[pre + "attn.v_bias"] = arr(attn["v_bias"][i])
        out[pre + "attn.proj.weight"] = t(attn["proj"]["kernel"][i])
        out[pre + "attn.proj.bias"] = arr(attn["proj"]["bias"][i])
        for fc in ("fc1", "fc2"):
            out[pre + f"mlp.{fc}.weight"] = t(mlp[fc]["kernel"][i])
            out[pre + f"mlp.{fc}.bias"] = arr(mlp[fc]["bias"][i])
        if "gamma_1" in blocks:
            out[pre + "gamma_1"] = arr(blocks["gamma_1"][i])
            out[pre + "gamma_2"] = arr(blocks["gamma_2"][i])
    for norm in ("fc_norm", "norm"):
        if norm in params:
            out[norm + ".weight"] = arr(params[norm]["scale"])
            out[norm + ".bias"] = arr(params[norm]["bias"])
    if "head" in params:
        out["head.weight"] = t(params["head"]["kernel"])
        out["head.bias"] = arr(params["head"]["bias"])
    return {k: torch.from_numpy(v) for k, v in out.items()}
