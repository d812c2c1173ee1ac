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
"""

from __future__ import annotations

import csv
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from simple_tad_tpu_torch.data.frame_datasets import ClipEvalView, FrameDataset
from simple_tad_tpu_torch.eval.metrics import BinaryMetrics, binary_metrics
from simple_tad_tpu_torch.models.layers import embed_tubelets, patch_matrix
from simple_tad_tpu_torch.ops import image as image_ops
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
        if plots_dir:
            raise NotImplementedError(
                "metric plots are not ported yet (ROADMAP.md queue 1, "
                "evaluation path)")
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


class FrameEvaluator:
    """Scores FrameDataset eval views with ``model`` on ``device``."""

    def __init__(self, model, *, device, batch_size: int = 96,
                 resize_on_host: bool = False, precompute_tubelets: bool = True,
                 devices=None):
        if devices is not None:
            raise NotImplementedError(
                "multi-device evaluation is not ported yet (ROADMAP.md "
                "queue 1, evaluation path)")
        cfg = model.cfg
        self.model = model
        self.device = torch.device(device)
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

    @torch.inference_mode()
    def score_view_async(self, dataset: FrameDataset,
                         view: ClipEvalView) -> torch.Tensor:
        """Launch every window chunk of one clip; -> (W, num_classes) fp32
        logits on the device (not yet synchronised)."""
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
                x = embed_tubelets(image_ops.make_windows(frames, chunk),
                                   self.patch_kernel, self.patch_bias,
                                   self.patch, self.tubelet, self.dtype)
            out.append(self.model(x, tokens_input=True).float())
        return torch.cat(out)

    def score_view(self, dataset: FrameDataset, view: ClipEvalView
                   ) -> np.ndarray:
        """-> (W, num_classes) float32 logits for all windows of one clip."""
        return self.score_view_async(dataset, view).cpu().numpy()

    def evaluate(self, dataset: FrameDataset, *,
                 exact_metrics: bool = False) -> EvalResult:
        """Score every window of every eval view of ``dataset``."""
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
        for view in dataset.clip_eval_views():
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
