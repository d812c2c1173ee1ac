"""Sliding-window frame-level evaluation CLI, in PyTorch.

Port of simple_tad_tpu/cli/eval_frames.py (reference:
``run_frame_finetuning.py --eval``): builds the test-mode dataset (stride
1: every frame gets a window), scores every window, writes
predictions.csv + stats.txt + params.json.  Same flags as the JAX CLI,
plus ``--device`` (default cuda).

Usage:
  python -m simple_tad_tpu_torch.cli.eval_frames \
      --data_set DoTA --data_path /data/dota \
      --model vit_base_patch16_224 --finetune ckpt.pth \
      --output_dir out/ --device cuda
"""

from __future__ import annotations

import argparse
import os

import torch

from simple_tad_tpu_torch.config import FinetuneConfig


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    dev_args, rest = pre.parse_known_args(argv)
    cfg = FinetuneConfig.from_args(rest)
    if cfg.quant8:
        raise NotImplementedError(
            "--quant8 is not ported yet (ROADMAP.md queue 1, int8 serving)")
    # dist_eval is on by default in the reference flags, where one device
    # makes it a no-op; asked for explicitly it needs multi-device eval
    if "--dist_eval" in rest:
        raise NotImplementedError(
            "--dist_eval is not ported yet (ROADMAP.md queue 1, evaluation "
            "path: multi-device)")

    from simple_tad_tpu_torch.data.frame_datasets import (
        FrameDataset, read_dada_clips, read_dota_clips)
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.utils.torch_convert import load_vit_checkpoint

    device = torch.device(dev_args.device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = create_model(
        cfg.model, device=device,
        generator=torch.Generator().manual_seed(cfg.seed),
        num_classes=cfg.nb_classes, all_frames=cfg.num_frames,
        img_size=cfg.input_size, tubelet_size=cfg.tubelet_size,
        final_reduction=cfg.final_reduction, init_scale=cfg.init_scale,
        dtype=dtype)
    if cfg.finetune:
        if not cfg.finetune.endswith(".pth"):
            raise NotImplementedError(
                "only reference .pth checkpoints load into the port")
        load_vit_checkpoint(cfg.finetune, model)
        print(f"loaded checkpoint {cfg.finetune}")

    if cfg.data_set == "DoTA":
        clips = read_dota_clips(cfg.data_path, "val_split.txt",
                                orig_fps=10, ttc_TT=cfg.ttc_TT,
                                ttc_TA=cfg.ttc_TA)
        orig_fps = 10
    elif cfg.data_set in ("DADA2K", "DADA"):
        # test split = validation.txt (datasets_frame.py:253-258)
        clips = read_dada_clips(cfg.data_path,
                                "DADA2K_my_split/validation.txt",
                                orig_fps=30, ttc_TT=cfg.ttc_TT,
                                ttc_TA=cfg.ttc_TA)
        orig_fps = 30
    else:
        raise ValueError(f"unknown data_set {cfg.data_set}")

    ds = FrameDataset(clips, mode="test", view_len=cfg.num_frames,
                      target_fps=cfg.view_fps, orig_fps=orig_fps,
                      view_step=1, crop_size=cfg.input_size)
    print(f"eval windows: {len(ds)} over {len(clips)} clips")

    ev = FrameEvaluator(model, device=device, batch_size=cfg.batch_size,
                        resize_on_host=cfg.resize_on_host)
    res = ev.evaluate(ds, exact_metrics=cfg.exact_metrics)
    print(f"AUROC {res.metrics.auroc:.4f}  AP {res.metrics.ap:.4f}  "
          f"AUC-MCC {res.metrics.mcc_auc:.4f}  "
          f"MCC@0.5 {res.metrics.mcc_05:.4f}  "
          f"({res.windows_per_sec:.1f} windows/s on {device})")
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        res.save(os.path.join(cfg.output_dir, "predictions.csv"),
                 os.path.join(cfg.output_dir, "stats.txt"))
        cfg.save(os.path.join(cfg.output_dir, "params.json"))
        print(f"wrote {cfg.output_dir}/predictions.csv")
    return res


if __name__ == "__main__":
    main()
