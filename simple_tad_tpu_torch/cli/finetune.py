"""Frame fine-tuning CLI, in PyTorch, on one device.

Port of simple_tad_tpu/cli/finetune.py (reference: run_frame_finetuning.py):
dataset build, model build (fp32 masters computed in ``--dtype``) and
``--finetune`` checkpoint init, layer-decay AdamW with per-step cosine
lr/wd, the epoch loop with validation, best-metric checkpoints and
auto-resume.  Same flags as the JAX CLI, plus ``--device`` (default cuda)
and ``--attn_dropout_form``.
Validation scores a copy of the weights in the compute dtype (the EMA
weights under ``--model_ema``); the fp32 masters are never touched.

``--model internvideo2_{small,base,large,1B,6B}_patch14_224`` fine-tunes
InternVideo2 (``jobs/finetune/IV2-S_DoTA.sh``: ``--num_frames 8
--view_fps 5``).  Its tubelet is the family's own (1): the ViT's
``--tubelet_size`` and ``--final_reduction`` do not apply to it, as in
cli/eval_frames.py (the JAX CLI passes them to every model; ROADMAP.md F3).
``--finetune`` loads a reference ``.pth`` of either family, or a
pre-training checkpoint (cli/pretrain.py's ``checkpoint-<epoch>.pth``, or
the reference's): its encoder's weights, by the reference's key surgery.
``--model mvd_vit_{size}_patch16_224`` and ``umt_vit_{base,large}_patch16_224``
fine-tune the MVD and UMT trunks (``jobs/finetune/MVD-B_DoTA.sh``,
``UMT-B_D2K.sh``: ``--tubelet_size 1 --num_frames 8 --view_fps 5``).

``--attn_drop_rate`` > 0 trains the ViT with attention dropout (kernels
C4) in the form ``--attn_dropout_form`` selects: ``rng`` (the default, the
TPU program's: the kernels draw Philox bits from a seed) or ``mask`` (an
int8 keep mask in memory; the JAX package's SIMPLE_TAD_DROPOUT_MASK).
InternVideo2 has no attention dropout, as in the JAX package.

Not ported: more than one device (``--zero_stage``, or ``--device`` naming
several devices, raise: ROADMAP.md queue 1, DDP), gradient checkpointing
(``--use_checkpoint``), and the optimizers of the menu other than adamw
and adam.

Usage:
  python -m simple_tad_tpu_torch.cli.finetune --data_set DoTA \\
      --data_path /data/dota --model vit_base_patch16_224 \\
      --finetune k400_init.pth --output_dir out/ --epochs 20 --device cuda
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from simple_tad_tpu_torch.config import FinetuneConfig


def build_datasets(cfg: FinetuneConfig):
    from simple_tad_tpu_torch.data.frame_datasets import (
        FrameDataset, read_dada_clips, read_dota_clips)
    if cfg.data_set == "DoTA":
        orig_fps = 10
        train_clips = read_dota_clips(cfg.data_path, "train_split.txt",
                                      orig_fps=orig_fps, ttc_TT=cfg.ttc_TT,
                                      ttc_TA=cfg.ttc_TA)
        val_clips = read_dota_clips(cfg.data_path, "val_split.txt",
                                    orig_fps=orig_fps, ttc_TT=cfg.ttc_TT,
                                    ttc_TA=cfg.ttc_TA)
    elif cfg.data_set in ("DADA2K", "DADA"):
        orig_fps = 30
        train_clips = read_dada_clips(
            cfg.data_path, "DADA2K_my_split/training.txt",
            orig_fps=orig_fps, ttc_TT=cfg.ttc_TT, ttc_TA=cfg.ttc_TA)
        val_clips = read_dada_clips(
            cfg.data_path, "DADA2K_my_split/validation.txt",
            orig_fps=orig_fps, ttc_TT=cfg.ttc_TT, ttc_TA=cfg.ttc_TA)
    else:
        raise ValueError(cfg.data_set)
    train_ds = FrameDataset(train_clips, mode="train",
                            view_len=cfg.num_frames,
                            target_fps=cfg.view_fps, orig_fps=orig_fps,
                            view_step=cfg.sampling_rate,
                            crop_size=cfg.input_size)
    # validation stride 1 (datasets_frame.py:219)
    val_ds = FrameDataset(val_clips, mode="validation",
                          view_len=cfg.num_frames, target_fps=cfg.view_fps,
                          orig_fps=orig_fps, view_step=1,
                          crop_size=cfg.input_size)
    return train_ds, val_ds


def build_model(cfg: FinetuneConfig, device, dtype, param_dtype=None,
                attn_dropout_form: str = "rng"):
    from simple_tad_tpu_torch.models import create_model, model_family
    vit_only = {} if model_family(cfg.model) == "iv2" else dict(
        tubelet_size=cfg.tubelet_size, final_reduction=cfg.final_reduction,
        attn_dropout_form=attn_dropout_form)
    return create_model(
        cfg.model, device=device,
        generator=torch.Generator().manual_seed(cfg.seed),
        num_classes=cfg.nb_classes, all_frames=cfg.num_frames,
        img_size=cfg.input_size, fc_drop_rate=cfg.fc_drop_rate,
        drop_rate=cfg.drop, drop_path_rate=cfg.drop_path,
        attn_drop_rate=cfg.attn_drop_rate, init_scale=cfg.init_scale,
        dtype=dtype, param_dtype=param_dtype, remat=cfg.use_checkpoint,
        **vit_only)


def build_optimizer(cfg: FinetuneConfig, model, steps_per_epoch: int):
    """The layer-decay AdamW of the JAX CLI, with schedules sized in
    optimizer updates (steps_per_epoch // update_freq per epoch)."""
    from simple_tad_tpu_torch.train import optim as O
    total_batch = cfg.batch_size * cfg.update_freq
    lr = O.scale_lr_by_batch(cfg.lr, total_batch)
    min_lr = O.scale_lr_by_batch(cfg.min_lr, total_batch)
    warmup_lr = O.scale_lr_by_batch(cfg.warmup_lr, total_batch)
    opt_steps_per_epoch = max(steps_per_epoch // cfg.update_freq, 1)
    lr_sched = O.cosine_scheduler(lr, min_lr, cfg.epochs,
                                  opt_steps_per_epoch,
                                  warmup_epochs=cfg.warmup_epochs,
                                  start_warmup_value=warmup_lr,
                                  warmup_steps=cfg.warmup_steps)
    wd_end = (cfg.weight_decay if cfg.weight_decay_end is None
              else cfg.weight_decay_end)
    wd_sched = O.cosine_scheduler(cfg.weight_decay, wd_end, cfg.epochs,
                                  opt_steps_per_epoch)
    return O.FinetuneOptimizer(
        dict(model.named_parameters()),
        lr_schedule=O.array_schedule(lr_sched),
        wd_schedule=O.array_schedule(wd_sched),
        weight_decay=cfg.weight_decay, layer_decay=cfg.layer_decay,
        depth=model.cfg.depth, betas=tuple(cfg.opt_betas), eps=cfg.opt_eps,
        clip_grad=cfg.clip_grad, freeze_layers=cfg.freeze_layers,
        opt=cfg.opt, update_freq=cfg.update_freq)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--attn_dropout_form", choices=("rng", "mask"),
                     default="rng")
    dev_args, rest = pre.parse_known_args(argv)
    cfg = FinetuneConfig.from_args(rest)
    if cfg.zero_stage or "," in dev_args.device:
        raise NotImplementedError(
            "training on more than one device (DDP, --zero_stage) is not "
            "ported yet (ROADMAP.md queue 1, frame fine-tuning: DDP)")
    if cfg.finetune and not cfg.finetune.endswith(".pth"):
        raise NotImplementedError(
            "only reference .pth checkpoints load into the port")

    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.train import losses as L
    from simple_tad_tpu_torch.train.engine import (FinetuneTrainer,
                                                   TrainLoader, validate)
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    from simple_tad_tpu_torch.utils import checkpoint as ckpt_utils
    from simple_tad_tpu_torch.utils.logging import (JsonlLogger,
                                                    TensorboardLogger)
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    np.random.seed(cfg.seed)
    device = torch.device(dev_args.device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_model(cfg, device, dtype, param_dtype=torch.float32,
                        attn_dropout_form=dev_args.attn_dropout_form)
    if cfg.finetune:
        load_checkpoint_auto(cfg.finetune, model)
        print(f"initialized from {cfg.finetune}")

    train_ds, val_ds = build_datasets(cfg)
    loader = TrainLoader(train_ds, cfg.batch_size, seed=cfg.seed,
                         nb_samples_per_epoch=cfg.nb_samples_per_epoch,
                         num_threads=cfg.num_workers,
                         num_sample=cfg.num_sample)
    steps_per_epoch = loader.steps_per_epoch()
    print(f"train windows: {len(train_ds)}  steps/epoch: {steps_per_epoch} "
          f"device: {device}")

    ema_decay = cfg.model_ema_decay if cfg.model_ema else None
    step = make_finetune_train_step(L.create_criterion(cfg.loss,
                                                       cfg.smoothing),
                                    ema_decay=ema_decay)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed + 1)
    state = TrainState.create(model,
                              build_optimizer(cfg, model, steps_per_epoch),
                              generator, ema_decay=ema_decay)

    start_epoch = cfg.start_epoch
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.output_dir, "params.json"))
        if cfg.auto_resume and not cfg.resume:
            state, start_epoch = ckpt_utils.load_train_state(cfg.output_dir,
                                                             state)
            if start_epoch:
                print(f"auto-resumed at epoch {start_epoch}")

    log_writer = TensorboardLogger(cfg.log_dir)
    jsonl = JsonlLogger(cfg.output_dir or None)
    tracker = (ckpt_utils.BestTracker(cfg.output_dir)
               if cfg.output_dir else None)
    trainer = FinetuneTrainer(step, state, device=device,
                              crop_size=cfg.input_size, reprob=cfg.reprob,
                              dtype=dtype, log_writer=log_writer,
                              seed=cfg.seed)
    # validation model: the weights in the compute dtype, rebuilt from the
    # masters (or the EMA) each epoch
    eval_model = build_model(cfg, device, dtype)

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        train_stats = trainer.train_one_epoch(loader, epoch)
        weights = (state.ema if state.ema is not None
                   else state.model.state_dict())
        eval_model.load_state_dict(weights)
        evaluator = FrameEvaluator(eval_model, device=device,
                                   batch_size=cfg.batch_size * 2)
        val_stats = validate(evaluator, val_ds)
        print(f"[epoch {epoch}] train loss {train_stats.get('loss', 0):.4f} "
              f"val auroc {val_stats['auroc']:.4f} ap {val_stats['ap']:.4f} "
              f"mccauc {val_stats['mccauc']:.4f} "
              f"({time.time() - t0:.0f}s)")
        jsonl.write({"epoch": epoch,
                     **{f"train_{k}": v for k, v in train_stats.items()},
                     **{f"val_{k}": v for k, v in val_stats.items()}})
        if cfg.output_dir and cfg.save_ckpt:
            ckpt_utils.save_train_state(cfg.output_dir, state, epoch)
            if tracker:
                tracker.update(weights, val_stats)
            if (epoch + 1) % cfg.save_ckpt_freq == 0:
                ckpt_utils.save_weights(cfg.output_dir,
                                        state.model.state_dict(),
                                        f"checkpoint-{epoch}")
    return state


if __name__ == "__main__":
    main()
