"""Sliding-window frame-level evaluation CLI, in PyTorch.

Port of simple_tad_tpu/cli/eval_frames.py (reference:
``run_frame_finetuning.py --eval``): builds the test-mode dataset (stride
1: every frame gets a window), scores every window, writes
predictions.csv + stats.txt + plots/{pr,roc,confusion,dist}.jpg +
params.json (the plots need matplotlib and Pillow, the package's
``plots`` extra: with ``--output_dir`` the CLI checks for them before it
evaluates).  Same flags as the JAX CLI,
plus ``--device`` (default cuda).  ``--quant8`` serves the int8 model,
quantized from fp32 masters (the seeded fp32 build with the checkpoint
loaded), in ``--quant8_mode`` static (calibrated on the first clips, the
default) or dynamic.

``--model mvd_vit_{size}_patch16_224`` and ``umt_vit_{base,large}_patch16_224``
serve the MVD and UMT trunks (UMT-B's job: ``--tubelet_size 1 --num_frames
8 --view_fps 5``).
``--model internvideo2_{small,base,large,1B,6B}_patch14_224`` serves
InternVideo2 (tubelet 1, patch 14; the DoTA job's setting is
``--num_frames 8 --view_fps 5``).  Its tubelet is the family's own: the
ViT's ``--tubelet_size`` and ``--final_reduction`` do not apply to it.
``--fused_rmsq`` (static int8 InternVideo2 only) makes its RMSNorms emit
int8 through the RMSNorm->int8 kernel, the JAX package's
SIMPLE_TAD_FUSED_RMSQ opt-in.  With static ``--quant8``, ``--fused_w8a8``
and ``--fused_mlp`` run the fused int8 GEMM kernels (per GEMM, and the
whole MLP) and ``--no_qkv_i8`` the bf16 attention with the int8 output
epilogue instead of int8 storage: the JAX package's SIMPLE_TAD_FUSED_W8A8,
SIMPLE_TAD_FUSED_MLP and SIMPLE_TAD_QKV_I8=0 programs.  With static
``--quant8`` on a ViT, ``--add_lnq`` runs each residual add inside the next
norm's LayerNorm->int8 kernel (the deferred-residual carry) and
``--int8_attn`` the int8-compute attention: the JAX package's
SIMPLE_TAD_ADD_LNQ and SIMPLE_TAD_INT8_ATTN programs.

``--dist_eval`` (on by default, as in the reference) under torchrun:
rank r scores ``clip_eval_views()[r::world]`` on its card and writes
``predictions.<r>.csv``; the metrics come from a ragged gather of every
rank's windows, on every rank; rank 0 merges the shards into
``predictions.csv`` and writes the stats and plots.  Without torchrun and
with several local cards, the clips go round-robin over them
(FrameEvaluator ``devices``).

Usage:
  python -m simple_tad_tpu_torch.cli.eval_frames \
      --data_set DoTA --data_path /data/dota \
      --model vit_base_patch16_224 --finetune ckpt.pth \
      --output_dir out/ --device cuda [--quant8 [--quant8_mode dynamic]
      [--add_lnq] [--int8_attn]]
"""

from __future__ import annotations

import argparse
import os

import torch

from simple_tad_tpu_torch.config import FinetuneConfig


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--fused_rmsq", action="store_true")
    pre.add_argument("--fused_w8a8", action="store_true")
    pre.add_argument("--fused_mlp", action="store_true")
    pre.add_argument("--no_qkv_i8", dest="qkv_i8", action="store_false")
    pre.add_argument("--add_lnq", action="store_true")
    pre.add_argument("--int8_attn", action="store_true")
    dev_args, rest = pre.parse_known_args(argv)
    cfg = FinetuneConfig.from_args(rest)
    if cfg.output_dir:
        # the plots come last: fail before the evaluation, not after it
        from simple_tad_tpu_torch.eval.plots import require_plotting
        require_plotting()

    from simple_tad_tpu_torch.data.frame_datasets import (
        FrameDataset, read_dada_clips, read_dota_clips)
    from simple_tad_tpu_torch.eval.engine import (FrameEvaluator,
                                                  evaluate_distributed,
                                                  read_predictions)
    from simple_tad_tpu_torch.models import create_model, model_family
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import data_parallel_setup
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    world, rank, device = (data_parallel_setup(dev_args.device)
                           if cfg.dist_eval
                           else (1, 0, torch.device(dev_args.device)))
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.finetune and not cfg.finetune.endswith(".pth"):
        raise NotImplementedError(
            "only reference .pth checkpoints load into the port")

    vit_only = {} if model_family(cfg.model) == "iv2" else dict(
        tubelet_size=cfg.tubelet_size, final_reduction=cfg.final_reduction)

    def build(dev, dt):
        model = create_model(
            cfg.model, device=dev,
            generator=torch.Generator().manual_seed(cfg.seed),
            num_classes=cfg.nb_classes, all_frames=cfg.num_frames,
            img_size=cfg.input_size, init_scale=cfg.init_scale, dtype=dt,
            **vit_only)
        if cfg.finetune:
            load_checkpoint_auto(cfg.finetune, model)
        return model

    model = build(device, dtype)
    if cfg.finetune:
        print(f"loaded checkpoint {cfg.finetune}")
    # the int8 model is quantized from the fp32 masters, never from the
    # compute-dtype copy
    fp32_state = (build(torch.device("cpu"), torch.float32).state_dict()
                  if cfg.quant8 else None)

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

    devices = None
    if (cfg.dist_eval and world == 1 and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    ev = FrameEvaluator(model, device=device, batch_size=cfg.batch_size,
                        resize_on_host=cfg.resize_on_host, quant8=cfg.quant8,
                        quant8_mode=cfg.quant8_mode, fp32_state=fp32_state,
                        fused_rmsq=dev_args.fused_rmsq,
                        fused_w8a8=dev_args.fused_w8a8,
                        fused_mlp=dev_args.fused_mlp,
                        qkv_i8=dev_args.qkv_i8,
                        add_lnq=dev_args.add_lnq,
                        int8_attn=dev_args.int8_attn, devices=devices)
    res = evaluate_distributed(ev, ds, exact_metrics=cfg.exact_metrics)
    print(f"AUROC {res.metrics.auroc:.4f}  AP {res.metrics.ap:.4f}  "
          f"AUC-MCC {res.metrics.mcc_auc:.4f}  "
          f"MCC@0.5 {res.metrics.mcc_05:.4f}  "
          f"({res.windows_per_sec:.1f} windows/s on {device})")
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        preds = os.path.join(cfg.output_dir, "predictions.csv")
        if world > 1:
            # each rank's shard, merged on rank 0, whose rows are then all
            # the windows'
            res.save(os.path.join(cfg.output_dir, f"predictions.{rank}.csv"))
            multihost.barrier()
            merged = multihost.merge_csv_shards(cfg.output_dir,
                                                "predictions", world)
            if merged:
                res.rows = read_predictions(merged)
        if multihost.is_main_process():
            cfg.save(os.path.join(cfg.output_dir, "params.json"))
            res.save(preds, os.path.join(cfg.output_dir, "stats.txt"),
                     plots_dir=cfg.output_dir)
            print(f"wrote {preds}")
    return res


if __name__ == "__main__":
    main()
