"""Int8 inference of the ViT and InternVideo2: weight quantization, int8
GEMMs, calibration.

Port of simple_tad_tpu/ops/quant.py for the VisionTransformer and
InternVideo2 (whose block GEMMs carry the same names).  Weights
quantize offline per output channel (absmax / 127, symmetric), from fp32
masters only: quantizing a bf16 copy would give other codes and scales.
Activations quantize per row on the fly (``int8_matmul``, quant_mode
'dynamic' and 'calib') or against a calibrated per-tensor absmax
(``int8_matmul_static``, quant_mode 'static', the serving default).  Both
products are exact int8 x int8 -> int32 GEMMs (``torch._int_mm``: an fp32
product over K = 3072 is not exact, 127^2 * 3072 > 2^24), rescaled in fp32.
The JAX package leaves these GEMMs to XLA; here they are a library GEMM,
counted in ``INT_MM_CALLS``, unless the static model takes the fused int8
GEMM kernels (``fused_w8a8``, ``fused_mlp``: ops/int8_gemm.py), which make
none.

Static serving recipe (``quantize_and_calibrate``; FrameEvaluator and the
inference CLI do it for the user): ``quantize_vit_params`` (or
``quantize_iv2_params``) on the fp32 state dict, a 'calib' model run over a
few representative batches (``calibrate_act_amax``), the recorded absmax
written into the state (``apply_act_amax``), and the 'static' model built
from it (``quant_model`` dispatches on the config's family).  InternVideo2's
calib model records the per-head absmax of the post-norm q/k and the raw v
(``attn.qkv_amax``) and, with ``fused_rmsq``, that of norm1/norm2's output
in the norm scopes (``norm1.act_amax``, ``norm2.act_amax``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from simple_tad_tpu_torch.ops.ln import quantize_static

# the int8 GEMMs of every block, by state-dict module name
QUANT_GEMMS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
INT_MM_CALLS = 0


def quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(in, out) fp32 kernel -> (int8 kernel, (out,) fp32 scale).  The JAX
    package's numpy code, so the codes and scales are the same bits."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.maximum(scale, 1e-12)
    w_i8 = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w_i8, scale.astype(np.float32)


def _int_mm(x_i8, w_q):
    """(..., K) int8 x (N, K) int8 -> (..., N) exact int32."""
    global INT_MM_CALLS
    INT_MM_CALLS += 1
    lead = x_i8.shape[:-1]
    y = torch._int_mm(x_i8.reshape(-1, x_i8.shape[-1]), w_q.t())
    return y.reshape(*lead, w_q.shape[0])


def int8_matmul(x, w_q, w_scale):
    """Per-row dynamic activation scales: x (..., K) float, w_q (N, K) int8,
    w_scale (N,) -> (..., N) fp32."""
    x32 = x.float()
    x_scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0,
                          min=1e-12)
    x_i8 = torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8)
    return _int_mm(x_i8, w_q).float() * x_scale * w_scale


def int8_matmul_static(x, w_q, w_scale, a_amax):
    """Static activation scale ``a_amax`` (the calibrated absmax of this
    GEMM's input, one fp32 value on x's device): x (..., K) float, or int8
    already quantized against a_amax (LayerNormQuant's output), w_q (N, K)
    int8, w_scale (N,) -> (..., N) fp32."""
    if x.dtype != torch.int8:
        x = quantize_static(x.float(), a_amax)
    return _int_mm(x, w_q).float() * (w_scale * (a_amax / 127.0))


def quantize_vit_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """fp32 ViT or InternVideo2 state dict -> the int8 model's: each block
    GEMM's ``weight`` (out, in) becomes ``weight_q`` (out, in) int8 and
    ``weight_scale`` (out,) fp32; everything else passes through.  Raises
    unless those weights are fp32 (the masters, never a bf16 copy)."""
    out = {}
    for key, val in state.items():
        mod, _, leaf = key.rpartition(".")
        parts = mod.split(".", 2)
        if not (leaf == "weight" and parts[0] == "blocks" and len(parts) == 3
                and parts[2] in QUANT_GEMMS):
            out[key] = val
            continue
        if val.dtype != torch.float32:
            raise TypeError(
                f"{key} is {val.dtype}: the int8 model is made from the fp32 "
                f"masters (a .pth, from_jax_params, or an fp32 model's "
                f"state_dict), never from a lower-precision copy")
        w_q, scale = quantize_weight(val.detach().cpu().numpy().T)
        out[mod + ".weight_q"] = torch.from_numpy(np.ascontiguousarray(w_q.T))
        out[mod + ".weight_scale"] = torch.from_numpy(scale)
    return out


def quantize_iv2_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """fp32 InternVideo2 state dict -> the int8 model's (port of the JAX
    quantize_iv2_params): qkv, proj, fc1 and fc2 of every block become int8
    with per-channel scales; norms, LayerScale, position tables, the patch
    embedding and the pooling head stay fp32.  The block GEMMs have the
    ViT's names, so this is ``quantize_vit_params``."""
    return quantize_vit_params(state)


def calibrate_act_amax(model, batches, reduce="max", **forward_kwargs
                       ) -> Dict[str, torch.Tensor]:
    """Run ``model`` (built with quant_mode='calib') over ``batches`` and
    return the absmax of every recorded activation site, by the static
    model's state-dict name, as fp32 CPU tensors.

    reduce: how the per-batch absmax combine -- 'max' (never clips a
    calibration value) or a float q in (0, 1]: the q-quantile of the
    per-batch values, an outlier-robust clip when one batch holds a freak
    activation."""
    if model.cfg.quant_mode != "calib":
        raise ValueError("calibrate_act_amax needs a quant_mode='calib' model")
    if reduce != "max" and not 0.0 < float(reduce) <= 1.0:
        raise ValueError(f"reduce must be 'max' or a quantile, got {reduce}")
    sites = [(name, m) for name, m in model.named_modules()
             if hasattr(m, "observed")]
    per_batch = []
    with torch.inference_mode():
        for x in batches:
            for _, m in sites:
                m.observed.clear()
            model(x, **forward_kwargs)
            per_batch.append({f"{name}.{k}": v.float().cpu()
                              for name, m in sites
                              for k, v in m.observed.items()})
    if reduce == "max":
        return {k: functools.reduce(torch.maximum, [b[k] for b in per_batch])
                for k in per_batch[0]}
    return {k: torch.tensor(np.quantile(
        np.stack([b[k].numpy() for b in per_batch]), float(reduce), axis=0),
        dtype=torch.float32) for k in per_batch[0]}


def apply_act_amax(qstate, amax):
    """The int8 state with the calibrated ``*_amax`` entries written in."""
    return {**qstate, **amax}


def quant_model(cfg, qstate, mode: str, device):
    """The int8 model of ``cfg`` (a ViTConfig or an IV2Config) in quant
    ``mode`` holding ``qstate`` (quantize_vit_params' or
    quantize_iv2_params' output; with the calibrated absmax for mode
    'static').  The config's static serving options (``fused_w8a8``,
    ``fused_mlp``, ``qkv_i8``, ``fused_rmsq``; the ViT's ``int8_attn`` and
    ``add_lnq``) carry over.  A model that takes neither int8-storage nor
    int8-compute attention (``qkv_i8=False`` without ``int8_attn``) has no
    ``attn.qkv_amax``; one in ``qstate`` (calibration records it) is left
    out."""
    from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                          InternVideo2)
    from simple_tad_tpu_torch.models.vit import VisionTransformer
    family = InternVideo2 if isinstance(cfg, IV2Config) else VisionTransformer
    model = family(dataclasses.replace(cfg, quant=True, quant_mode=mode),
                   device=device)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in qstate.items()
                           if k in own or not k.endswith("attn.qkv_amax")})
    return model.eval()


def quantize_and_calibrate(cfg, fp32_state, batches, *, device,
                           reduce="max", **forward_kwargs):
    """fp32 state dict -> the static int8 model, calibrated on ``batches``
    (model inputs; ``forward_kwargs`` such as ``tokens_input=True`` go to
    each forward)."""
    qstate = quantize_vit_params(fp32_state)
    amax = calibrate_act_amax(quant_model(cfg, qstate, "calib", device),
                              batches, reduce, **forward_kwargs)
    return quant_model(cfg, apply_act_amax(qstate, amax), "static", device)
