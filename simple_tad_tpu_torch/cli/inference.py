"""Streaming frame-by-frame inference over a folder of frames, in PyTorch.

Port of simple_tad_tpu/cli/inference.py (reference: run_inference.py):
fill a T-frame window from the first frames, then per new frame shift the
window, append the frame and emit a risk probability.  The uint8 window
stays on the device; only the new frame crosses from the host.
``--batched`` scores all windows of the folder in batches instead.

Usage:
  python -m simple_tad_tpu_torch.cli.inference --ckpt model.pth \
      --frames_folder /path/to/frames --model vit_small_patch16_224
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import time

import numpy as np
import torch

from simple_tad_tpu_torch.models.layers import embed_tubelets, patch_matrix
from simple_tad_tpu_torch.ops.image import make_windows
from simple_tad_tpu_torch.utils.fold_norm import fold_normalization


def prepare_image(path: str, crop: int = 224) -> np.ndarray:
    """cv2 read -> cubic resize -> RGB uint8 (run_inference.py:15-34)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read {path}")
    img = cv2.resize(img, (crop, crop), interpolation=cv2.INTER_CUBIC)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class StreamingScorer:
    """Risk of raw uint8 windows, with ImageNet normalization folded into
    a copy of the model's patch-embed weights (the model is unchanged)."""

    def __init__(self, model):
        cfg = model.cfg
        self.model = model
        self.dtype = cfg.dtype
        self.patch, self.tubelet = cfg.patch_size, cfg.tubelet_size
        weight, bias = fold_normalization(model.patch_embed.proj.weight,
                                          model.patch_embed.proj.bias)
        self.kernel = patch_matrix(weight).contiguous()
        self.bias = bias

    @torch.inference_mode()
    def risk(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) uint8 windows -> (B,) fp32 risk probabilities."""
        tokens = embed_tubelets(windows_u8.to(self.dtype), self.kernel,
                                self.bias, self.patch, self.tubelet,
                                self.dtype)
        logits = self.model(tokens, tokens_input=True).float()
        return torch.softmax(logits, dim=-1)[:, 1]

    @torch.inference_mode()
    def step(self, window_u8: torch.Tensor, new_frame_u8: torch.Tensor):
        """Shift the (T, H, W, C) window left, append the frame, score it
        -> (new window, risk as a 0-d device tensor)."""
        window_u8 = torch.cat([window_u8[1:], new_frame_u8[None]])
        return window_u8, self.risk(window_u8[None])[0]

    @torch.inference_mode()
    def score_windows(self, frames_u8: torch.Tensor, idx: torch.Tensor):
        """frames (F, H, W, C) uint8, idx (B, T) -> (B,) risks."""
        return self.risk(make_windows(frames_u8, idx))


def main(argv=None):
    parser = argparse.ArgumentParser("simple_tad_tpu_torch streaming inference")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--frames_folder", required=True)
    parser.add_argument("--model", default="vit_small_patch16_224")
    parser.add_argument("--num_frames", type=int, default=16)
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--batched", action="store_true",
                        help="score all windows in batches instead of "
                             "simulating a stream")
    parser.add_argument("--output_csv", default="")
    parser.add_argument("--quant8", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.quant8:
        raise NotImplementedError(
            "--quant8 is not ported yet (ROADMAP.md queue 1, int8 serving)")
    if not args.ckpt.endswith(".pth"):
        raise NotImplementedError(
            "only reference .pth checkpoints load into the port")

    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.utils.torch_convert import load_vit_checkpoint

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = create_model(args.model, device=device,
                         generator=torch.Generator().manual_seed(0),
                         num_classes=2, all_frames=args.num_frames,
                         img_size=args.input_size, dtype=dtype)
    load_vit_checkpoint(args.ckpt, model)
    scorer = StreamingScorer(model)

    files = sorted(glob.glob(os.path.join(args.frames_folder, "*")))
    files = [f for f in files if os.path.splitext(f)[1].lower()
             in (".jpg", ".jpeg", ".png")]
    T, S = args.num_frames, args.input_size
    if len(files) < T:
        raise ValueError(f"need at least {T} frames, found {len(files)}")

    results = []
    if args.batched:
        frames = torch.from_numpy(
            np.stack([prepare_image(f, S) for f in files])).to(device)
        n_windows = len(files) - T + 1
        B = 32
        t0 = time.perf_counter()
        for s in range(0, n_windows, B):
            idx = torch.stack([torch.arange(i, i + T)
                               for i in range(s, min(s + B, n_windows))])
            risk = scorer.score_windows(frames, idx.to(device)).cpu()
            for j in range(idx.shape[0]):
                results.append((files[s + j + T - 1], float(risk[j])))
        dt = time.perf_counter() - t0
        print(f"[batched] {n_windows} windows in {dt:.2f}s "
              f"({n_windows / dt:.1f} windows/s)")
    else:
        window = torch.from_numpy(
            np.stack([prepare_image(f, S) for f in files[:T]])).to(device)
        scorer.step(window, window[-1])        # warm up
        t0 = time.perf_counter()
        for f in files[T:]:
            frame = torch.from_numpy(prepare_image(f, S)).to(device)
            window, risk = scorer.step(window, frame)
            results.append((f, float(risk)))
        dt = time.perf_counter() - t0
        n = max(len(files) - T, 1)
        print(f"[stream] {n} frames in {dt:.2f}s ({n / dt:.1f} FPS)")

    for path, risk in results[:10]:
        print(f"{os.path.basename(path)}  risk={risk:.4f}")
    if args.output_csv:
        with open(args.output_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(("frame", "risk"))
            writer.writerows(results)
    return results


if __name__ == "__main__":
    main()
