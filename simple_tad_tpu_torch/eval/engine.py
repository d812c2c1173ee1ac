"""Batched sliding-window evaluation engine, in PyTorch.

Port of simple_tad_tpu/eval/engine.py (reference: final_test,
engine_for_frame_finetuning.py:386-545): score every window of every eval
clip and collect {clip, filename, logits_safe, logits_risk, label, ttc}
into predictions.csv + stats.txt.

Clip at once, as in the JAX package: the host decodes a clip's unique
frames once; on the device the frames are resized, every unique frame is
embedded once through the split tubelet kernel (``half_kernel_tokens``)
and each window gathers its token rows.  PyTorch runs eagerly, so the JAX
package's jit artefacts (frame-count buckets, fixed chunk shapes, per-step
program caches) are gone: chunks are simply the last, shorter slice.  One
device; while the device scores a clip, the host decodes the next.

The model is a VisionTransformer (VideoMAE, MVD with or without its CLS
token, UMT at tubelet 1: the position table and the CLS token are added
inside the model from tokens, as forward_features adds them) or an
InternVideo2 (tubelet 1, patch 14;
its patch embedding has the ViT's ``patch_embed.proj`` names, and the CLS
token and position table are added inside the model from tokens).
``quant8=True`` serves the int8 model (ops/quant.py) made from the fp32
masters, dispatched on the model's family; in the default 'static' mode the
first ``evaluate`` (or ``score_view``) calibrates it on the first clips,
through the pixel path, as the JAX package does.  ``fused_rmsq`` (static
int8 InternVideo2 only) makes its RMSNorms emit int8 through the
RMSNorm->int8 kernel, the JAX package's SIMPLE_TAD_FUSED_RMSQ opt-in;
``fused_w8a8``, ``fused_mlp`` and ``qkv_i8=False`` (static int8, ViT or
InternVideo2) are the model options of models/layers.py: the fused int8
GEMM kernels, and the bf16 attention with the int8 output epilogue.
``add_lnq`` and ``int8_attn`` (static int8 ViT only; the JAX package's
SIMPLE_TAD_ADD_LNQ and SIMPLE_TAD_INT8_ATTN) are the ViT's deferred-residual
carry through the add + LayerNorm->int8 kernel and its int8-compute
attention (models/vit.py).
"""

from __future__ import annotations

import csv
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from simple_tad_tpu_torch.data.frame_datasets import ClipEvalView, FrameDataset
from simple_tad_tpu_torch.eval.metrics import (BinaryMetrics, binary_metrics,
                                               risk_probs)
from simple_tad_tpu_torch.models.internvideo2 import IV2Config
from simple_tad_tpu_torch.models.layers import embed_tubelets, patch_matrix
from simple_tad_tpu_torch.ops import image as image_ops
from simple_tad_tpu_torch.ops.quant import (apply_act_amax,
                                            calibrate_act_amax, quant_model,
                                            quantize_vit_params)
from simple_tad_tpu_torch.utils.fold_norm import fold_normalization

COLUMNS = ("clip", "filename", "logits_safe", "logits_risk", "label", "ttc")


def half_kernel_tokens(frames, kernel, bias, patch: int, tubelet: int,
                       step: int, dtype):
    """Embed every unique frame ONCE for sliding-window serving.

    The tubelet kernel (t*p*p*c, D) splits along its t-major rows into
    per-frame halves, so token(pair i) = patches_i @ k0 +
    patches_{i+step} @ k1 + bias: each frame runs through both halves once
    instead of once per window that contains it.

    frames: (F, H, W, C) -> (F - step*(tubelet-1), P, D) tokens in
    ``dtype``, P = (H/p)*(W/p); row i embeds the tubelet whose first frame
    is i (step = the sequencer's stride between window slots).  Inputs and
    kernel are rounded to ``dtype``; the products accumulate in fp32.
    """
    F, H, W, C = frames.shape
    p = patch
    nh, nw = H // p, W // p
    pat = frames.reshape(F, nh, p, nw, p, C).permute(0, 1, 3, 2, 4, 5)
    pat = pat.reshape(F, nh * nw, p * p * C).to(dtype).float()
    k = kernel.to(dtype).float()
    b = bias.float()
    if tubelet == 1:
        return (torch.matmul(pat, k) + b).to(dtype)
    if tubelet != 2:
        raise ValueError("video ViT family uses tubelet 1 or 2")
    half = p * p * C
    u = torch.matmul(pat, k[:half])
    w = torch.matmul(pat, k[half:])
    return (u[:F - step] + w[step:] + b).to(dtype)


@dataclasses.dataclass
class EvalResult:
    rows: Dict[str, list]        # column name -> values, COLUMNS order
    metrics: BinaryMetrics
    windows_per_sec: float
    n_windows: int

    def save(self, preds_file: str, stats_file: Optional[str] = None,
             plots_dir: Optional[str] = None):
        """Write predictions.csv, then the stats, then (``plots_dir``) the
        metric plots ``plots_dir``/plots/{pr,roc,confusion,dist}.jpg."""
        with open(preds_file, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(COLUMNS)
            writer.writerows(zip(*(self.rows[c] for c in COLUMNS)))
        if stats_file:
            with open(stats_file, "w") as f:
                for k, v in self.metrics.scalars().items():
                    f.write(f"{k}: {v}\n")
                f.write(f"n_windows: {self.n_windows}\n")
                f.write(f"windows_per_sec: {self.windows_per_sec:.2f}\n")
        if plots_dir:
            from simple_tad_tpu_torch.eval.plots import save_metric_plots
            save_metric_plots(self.metrics,
                              risk_probs(self.rows["logits_safe"],
                                         self.rows["logits_risk"]),
                              np.asarray(self.rows["label"]), plots_dir)


class FrameEvaluator:
    """Scores FrameDataset eval views with ``model`` on ``device``.

    quant8: serve the int8 model instead, quantized from ``fp32_state``
    (the fp32 masters, e.g. an fp32 model's state_dict; default: the
    model's own state, which must then be fp32) in ``quant8_mode``
    'static' (calibrated, see ``calibrate``) or 'dynamic'.  ``fused_rmsq``:
    the static int8 InternVideo2's norms emit int8 (kernel D3);
    ``fused_w8a8``, ``fused_mlp``, ``qkv_i8``: the static int8 model's
    options (models/layers.py), the JAX package's defaults unless given;
    ``add_lnq``, ``int8_attn``: the static int8 ViT's (models/vit.py).
    """

    def __init__(self, model, *, device, batch_size: int = 96,
                 resize_on_host: bool = False, precompute_tubelets: bool = True,
                 quant8: bool = False, quant8_mode: str = "static",
                 fp32_state=None, devices=None, fused_rmsq: bool = False,
                 fused_w8a8: bool = False, fused_mlp: bool = False,
                 qkv_i8: bool = True, add_lnq: bool = False,
                 int8_attn: bool = False):
        if devices is not None:
            raise NotImplementedError(
                "multi-device evaluation is not ported yet (ROADMAP.md "
                "queue 1 item 5)")
        cfg = model.cfg
        self.device = torch.device(device)
        self._qstate = None
        if fused_rmsq and not (quant8 and quant8_mode == "static"
                               and isinstance(cfg, IV2Config)):
            raise ValueError("fused_rmsq is an option of static int8 "
                             "InternVideo2 serving (quant8=True, "
                             "quant8_mode='static')")
        options = dict(fused_w8a8=fused_w8a8, fused_mlp=fused_mlp,
                       qkv_i8=qkv_i8)
        if options != dict(fused_w8a8=False, fused_mlp=False, qkv_i8=True) \
                and not (quant8 and quant8_mode == "static"):
            raise ValueError("fused_w8a8, fused_mlp and qkv_i8 are options "
                             "of static int8 serving (quant8=True, "
                             "quant8_mode='static')")
        vit_options = dict(add_lnq=add_lnq, int8_attn=int8_attn)
        if any(vit_options.values()):
            if not (quant8 and quant8_mode == "static"
                    and not isinstance(cfg, IV2Config)):
                raise ValueError("add_lnq and int8_attn are options of "
                                 "static int8 ViT serving (quant8=True, "
                                 "quant8_mode='static', not InternVideo2)")
            options.update(vit_options)
        if quant8:
            if quant8_mode not in ("static", "dynamic"):
                raise ValueError(f"quant8_mode must be 'static' or "
                                 f"'dynamic', got {quant8_mode!r}")
            qstate = quantize_vit_params(
                model.state_dict() if fp32_state is None else fp32_state)
            static = quant8_mode == "static"
            if fused_rmsq:
                cfg = dataclasses.replace(cfg, fused_rmsq=True)
            if static:
                cfg = dataclasses.replace(cfg, **options)
            # a static model is served by its calib twin until calibrate()
            self._qstate = qstate if static else None
            model = quant_model(cfg, qstate,
                                "calib" if static else "dynamic", self.device)
        self.model = model
        self.batch_size = batch_size
        self.dtype = cfg.dtype
        self.resize_on_host = resize_on_host
        self.crop = cfg.img_size
        self.patch = cfg.patch_size
        self.tubelet = cfg.tubelet_size
        self.precompute_tubelets = (precompute_tubelets
                                    and self.tubelet in (1, 2))
        # the evaluator embeds raw [0, 255] frames itself (token or pixel
        # path) with its own copy of the patch weights, ImageNet
        # normalization folded in; the model runs from tokens and is never
        # modified
        weight, bias = fold_normalization(model.patch_embed.proj.weight,
                                          model.patch_embed.proj.bias)
        self.patch_kernel = patch_matrix(weight).detach().contiguous()
        self.patch_bias = bias.detach()

    def _device_frames(self, dataset: FrameDataset, view: ClipEvalView):
        """Decode once, move, resize and cast the clip's unique frames ->
        (F, crop, crop, C) raw pixel values in the compute dtype."""
        frames = dataset.decode_clip_frames(
            view, resize_on_host=self.resize_on_host)
        x = torch.from_numpy(frames)
        if self.device.type == "cuda":
            # from pageable memory the copy runs at a fraction of the link
            # rate and the host waits for the device to drain first (11% of
            # ViT-B b32 device time on an H100, PERF.md); pinned, it is one
            # asynchronous DMA
            x = x.pin_memory()
        x = x.to(self.device, non_blocking=True)
        if not self.resize_on_host:
            x = image_ops.resize_bicubic(x, (self.crop, self.crop))
        return x.to(self.dtype)

    def _pixel_tokens(self, frames, chunk):
        """Tokens of the windows ``chunk`` (b, T) embedded from pixels."""
        return embed_tubelets(image_ops.make_windows(frames, chunk),
                              self.patch_kernel, self.patch_bias,
                              self.patch, self.tubelet, self.dtype)

    def calibrate(self, dataset: FrameDataset, n_views: int = 4, views=None,
                  reduce="max") -> None:
        """Static int8 calibration: the first ``batch_size`` windows of the
        first ``n_views`` eval clips go through the pixel path of the calib
        model; the absmax it records (combined by ``reduce``: 'max' or a
        quantile, see ops/quant.py:calibrate_act_amax) become the static
        model's activation scales.  A no-op once calibrated, and for the
        bf16 or dynamic int8 model."""
        if self._qstate is None:
            return
        if views is None:
            views = dataset.clip_eval_views()
        batches = []
        for view in views[:n_views]:
            chunk = torch.from_numpy(view.window_idx[:self.batch_size].astype(
                np.int64)).to(self.device)
            batches.append(self._pixel_tokens(
                self._device_frames(dataset, view), chunk))
        amax = calibrate_act_amax(self.model, batches, reduce,
                                  tokens_input=True)
        self.model = quant_model(self.model.cfg,
                                 apply_act_amax(self._qstate, amax),
                                 "static", self.device)
        self._qstate = None

    @torch.inference_mode()
    def score_view_async(self, dataset: FrameDataset,
                         view: ClipEvalView) -> torch.Tensor:
        """Launch every window chunk of one clip; -> (W, num_classes) fp32
        logits on the device (not yet synchronised)."""
        self.calibrate(dataset)
        frames = self._device_frames(dataset, view)
        idx = torch.from_numpy(view.window_idx.astype(np.int64)).to(
            self.device)
        W, T = view.window_idx.shape
        step = int(view.window_idx[0, 1] - view.window_idx[0, 0]) \
            if T >= 2 else 0
        tokens = None
        if self.precompute_tubelets and step > 0:
            tokens = half_kernel_tokens(frames, self.patch_kernel,
                                        self.patch_bias, self.patch,
                                        self.tubelet, step, self.dtype)
        out = []
        for s in range(0, W, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if tokens is not None:
                g = tokens[chunk[:, ::self.tubelet]]     # (b, T/t, P, D)
                x = g.reshape(g.shape[0], -1, g.shape[-1])
            else:
                x = self._pixel_tokens(frames, chunk)
            out.append(self.model(x, tokens_input=True).float())
        return torch.cat(out)

    def score_view(self, dataset: FrameDataset, view: ClipEvalView
                   ) -> np.ndarray:
        """-> (W, num_classes) float32 logits for all windows of one clip."""
        return self.score_view_async(dataset, view).cpu().numpy()

    def evaluate(self, dataset: FrameDataset, *,
                 exact_metrics: bool = False) -> EvalResult:
        """Score every window of every eval view of ``dataset``."""
        views = dataset.clip_eval_views()
        self.calibrate(dataset, views=views)
        rows: Dict[str, list] = {k: [] for k in COLUMNS}
        t0 = time.perf_counter()

        def drain(view, logits):
            logits = logits.cpu().numpy()
            rows["clip"].extend([view.clip.name] * logits.shape[0])
            rows["filename"].extend(view.frame_names)
            rows["logits_safe"].extend(logits[:, 0].tolist())
            rows["logits_risk"].extend(logits[:, 1].tolist())
            rows["label"].extend(view.labels.tolist())
            rows["ttc"].extend(np.asarray(view.ttc).tolist())

        # one clip in flight: the host decodes and launches clip k+1 while
        # the device still scores clip k; rows keep dispatch order
        inflight = None
        for view in views:
            launched = (view, self.score_view_async(dataset, view))
            if inflight is not None:
                drain(*inflight)
            inflight = launched
        if inflight is not None:
            drain(*inflight)
        elapsed = time.perf_counter() - t0

        n_windows = len(rows["clip"])
        logits = torch.tensor([rows["logits_safe"], rows["logits_risk"]],
                              dtype=torch.float32).T
        probs = torch.softmax(logits, dim=-1)[:, 1].numpy()
        metrics = binary_metrics(probs, np.asarray(rows["label"]),
                                 exact=exact_metrics)
        return EvalResult(rows=rows, metrics=metrics,
                          windows_per_sec=n_windows / max(elapsed, 1e-9),
                          n_windows=n_windows)
