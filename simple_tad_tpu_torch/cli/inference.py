"""Streaming frame-by-frame inference over a folder of frames, in PyTorch.

Port of simple_tad_tpu/cli/inference.py (reference: run_inference.py):
fill a T-frame window from the first frames, then per new frame shift the
window, append the frame and emit a risk probability.  The uint8 window
stays on the device; only the new frame crosses from the host.
``--batched`` scores all windows of the folder in batches instead.
``--quant8`` serves the static int8 model, quantized from fp32 masters
and calibrated on the first T frames (batch 1), as the JAX CLI does.
``--model mvd_vit_*_patch16_224`` / ``umt_vit_*_patch16_224`` serve the
MVD and UMT trunks (UMT: its registry geometry, tubelet 1 and 8 frames).
``--model internvideo2_*_patch14_224`` serves InternVideo2 (e.g.
``--num_frames 8``); ``--fused_rmsq`` adds its RMSNorm->int8 kernel to
``--quant8``.  ``--fused_w8a8``, ``--fused_mlp`` and ``--no_qkv_i8`` are
the static int8 model's options (cli/eval_frames.py), in both modes, and
``--add_lnq`` and ``--int8_attn`` the static int8 ViT's.

Usage:
  python -m simple_tad_tpu_torch.cli.inference --ckpt model.pth \
      --frames_folder /path/to/frames --model vit_small_patch16_224
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
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

    def tokens(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) uint8 windows -> (B, N, D) model input tokens."""
        return embed_tubelets(windows_u8.to(self.dtype), self.kernel,
                              self.bias, self.patch, self.tubelet, self.dtype)

    @torch.inference_mode()
    def risk(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) uint8 windows -> (B,) fp32 risk probabilities."""
        tokens = self.tokens(windows_u8)
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
    parser.add_argument("--fused_rmsq", action="store_true",
                        help="with --quant8, InternVideo2's RMSNorms emit "
                             "int8 (RMSNorm->int8 kernel)")
    parser.add_argument("--fused_w8a8", action="store_true",
                        help="with --quant8, every int8 GEMM is the fused "
                             "int8 GEMM kernel")
    parser.add_argument("--fused_mlp", action="store_true",
                        help="with --quant8, each MLP is one fused int8 "
                             "kernel")
    parser.add_argument("--no_qkv_i8", dest="qkv_i8", action="store_false",
                        help="with --quant8, bf16 attention with an int8 "
                             "output instead of int8-storage attention")
    parser.add_argument("--add_lnq", action="store_true",
                        help="with --quant8 on a ViT, each residual add runs "
                             "inside the next norm's LayerNorm->int8 kernel")
    parser.add_argument("--int8_attn", action="store_true",
                        help="with --quant8 on a ViT, int8-compute "
                             "attention")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.ckpt.endswith(".pth"):
        raise NotImplementedError(
            "only reference .pth checkpoints load into the port")

    from simple_tad_tpu_torch.models import create_model, model_family
    from simple_tad_tpu_torch.ops.quant import quantize_and_calibrate
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    def build(dev, dt):
        model = create_model(args.model, device=dev,
                             generator=torch.Generator().manual_seed(0),
                             num_classes=2, all_frames=args.num_frames,
                             img_size=args.input_size, dtype=dt)
        load_checkpoint_auto(args.ckpt, model)
        return model

    model = build(device, dtype)
    scorer = StreamingScorer(model)

    files = sorted(glob.glob(os.path.join(args.frames_folder, "*")))
    files = [f for f in files if os.path.splitext(f)[1].lower()
             in (".jpg", ".jpeg", ".png")]
    T, S = args.num_frames, args.input_size
    if len(files) < T:
        raise ValueError(f"need at least {T} frames, found {len(files)}")
    if args.fused_rmsq and not (args.quant8
                                and model_family(args.model) == "iv2"):
        raise ValueError("--fused_rmsq is an option of --quant8 with an "
                         "InternVideo2 model")
    options = dict(fused_w8a8=args.fused_w8a8, fused_mlp=args.fused_mlp,
                   qkv_i8=args.qkv_i8)
    if not args.quant8 and options != dict(fused_w8a8=False, fused_mlp=False,
                                           qkv_i8=True):
        raise ValueError("--fused_w8a8, --fused_mlp and --no_qkv_i8 are "
                         "options of --quant8")
    if args.add_lnq or args.int8_attn:
        if not args.quant8 or model_family(args.model) == "iv2":
            raise ValueError("--add_lnq and --int8_attn are options of "
                             "--quant8 with a ViT model")
        options.update(add_lnq=args.add_lnq, int8_attn=args.int8_attn)
    if args.quant8:
        # quantize the fp32 masters (never the compute-dtype copy) and
        # calibrate the activation scales on the first window
        first = torch.from_numpy(
            np.stack([prepare_image(f, S) for f in files[:T]])).to(device)
        cfg = model.cfg
        if args.fused_rmsq:
            cfg = dataclasses.replace(cfg, fused_rmsq=True)
        cfg = dataclasses.replace(cfg, **options)
        model = quantize_and_calibrate(
            cfg, build(torch.device("cpu"), torch.float32).state_dict(),
            [scorer.tokens(first[None])], device=device, tokens_input=True)
        scorer = StreamingScorer(model)

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
