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

Data parallelism (the reference's DDP, the JAX package's data mesh):
launched as ``torchrun --nproc_per_node=N -m simple_tad_tpu_torch.cli.finetune
...`` (``--standalone`` on one node), one process per card.
``--batch_size`` is per card: the loader draws the global batch of
batch_size x N and each rank decodes its own rows; the lr scales by
batch_size x update_freq x N / 256.  Gradients are averaged across the
ranks after each backward (bucketed all-reduces of the optimizer's named
gradients, not a DistributedDataParallel reducer), before the norm and
``--clip_grad``; ``--zero_stage 1`` or ``2`` shards the optimizer state.
Rank 0 writes the logs and checkpoints (the optimizer state gathered);
auto-resume loads on every rank; validation with ``--dist_eval`` (on by
default) splits the clips over the ranks (eval/engine.py:
evaluate_distributed).  ``--use_checkpoint`` checkpoints each block
(models/layers.py:block_call).  ``--grad_norm_heads N`` (N = the model's
heads) records the per-layer / per-head gradient norms each step and
writes ``grad_norms/gradnorm_ep<epoch>.npz`` (utils/diagnostics.py).
Every name of the optimizer menu is ported (train/optim.py).

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


def build_datasets(cfg: FinetuneConfig, native_decoder: bool = False):
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
                            crop_size=cfg.input_size,
                            native_decoder=native_decoder)
    # validation stride 1 (datasets_frame.py:219)
    val_ds = FrameDataset(val_clips, mode="validation",
                          view_len=cfg.num_frames, target_fps=cfg.view_fps,
                          orig_fps=orig_fps, view_step=1,
                          crop_size=cfg.input_size,
                          native_decoder=native_decoder)
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


def build_optimizer(cfg: FinetuneConfig, model, steps_per_epoch: int,
                    data_parallel=None):
    """The layer-decay AdamW (or ``--opt``) of the JAX CLI, with schedules
    sized in optimizer updates (steps_per_epoch // update_freq per epoch)
    and the lr scaled by the global batch."""
    from simple_tad_tpu_torch.train import optim as O
    world = data_parallel.world if data_parallel is not None else 1
    total_batch = cfg.batch_size * cfg.update_freq * world
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
        opt=cfg.opt, update_freq=cfg.update_freq,
        data_parallel=data_parallel, zero_stage=cfg.zero_stage)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--attn_dropout_form", choices=("rng", "mask"),
                     default="rng")
    pre.add_argument("--grad_norm_heads", type=int, default=None)
    pre.add_argument("--native_decoder", action="store_true",
                     help="decode the zips with the C++ decoder "
                          "(data/native.py); raises where it cannot be "
                          "built")
    dev_args, rest = pre.parse_known_args(argv)
    cfg = FinetuneConfig.from_args(rest)
    check_device(dev_args.device)
    if dev_args.native_decoder:     # fail before the model is built
        from simple_tad_tpu_torch.data import native
        native.load()
    if cfg.finetune and not cfg.finetune.endswith(".pth"):
        raise NotImplementedError(
            "only reference .pth checkpoints load into the port")

    from simple_tad_tpu_torch.eval.engine import (FrameEvaluator,
                                                  evaluate_distributed)
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import (data_parallel_setup,
                                                    rank_seed)
    from simple_tad_tpu_torch.train import losses as L
    from simple_tad_tpu_torch.train.engine import (FinetuneTrainer,
                                                   TrainLoader, validate)
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    from simple_tad_tpu_torch.utils import checkpoint as ckpt_utils
    from simple_tad_tpu_torch.utils.logging import (JsonlLogger,
                                                    TensorboardLogger)
    from simple_tad_tpu_torch.utils.diagnostics import GradNormAccumulator
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    np.random.seed(cfg.seed)
    dp = data_parallel_setup(dev_args.device)
    world, rank, device = dp
    main_rank = multihost.is_main_process()
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_model(cfg, device, dtype, param_dtype=torch.float32,
                        attn_dropout_form=dev_args.attn_dropout_form)
    if cfg.finetune:
        load_checkpoint_auto(cfg.finetune, model)
        print(f"initialized from {cfg.finetune}")

    train_ds, val_ds = build_datasets(cfg, dev_args.native_decoder)
    loader = TrainLoader(train_ds, cfg.batch_size * world, seed=cfg.seed,
                         nb_samples_per_epoch=cfg.nb_samples_per_epoch,
                         num_threads=cfg.num_workers,
                         num_sample=cfg.num_sample, rank=rank, world=world)
    steps_per_epoch = loader.steps_per_epoch()
    print(f"train windows: {len(train_ds)}  steps/epoch: {steps_per_epoch} "
          f"device: {device} (rank {rank} of {world})")

    ema_decay = cfg.model_ema_decay if cfg.model_ema else None
    step = make_finetune_train_step(L.create_criterion(cfg.loss,
                                                       cfg.smoothing),
                                    ema_decay=ema_decay,
                                    grad_norm_heads=dev_args.grad_norm_heads)
    generator = torch.Generator(device=device)
    generator.manual_seed(rank_seed(cfg.seed + 1, rank))
    state = TrainState.create(model,
                              build_optimizer(cfg, model, steps_per_epoch,
                                              dp),
                              generator, ema_decay=ema_decay)

    start_epoch = cfg.start_epoch
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        if main_rank:
            cfg.save(os.path.join(cfg.output_dir, "params.json"))
        if cfg.auto_resume and not cfg.resume:
            state, start_epoch = ckpt_utils.load_train_state(cfg.output_dir,
                                                             state)
            if start_epoch:
                print(f"auto-resumed at epoch {start_epoch}")

    log_writer = TensorboardLogger(cfg.log_dir if main_rank else None)
    jsonl = JsonlLogger(cfg.output_dir if main_rank else None)
    tracker = (ckpt_utils.BestTracker(cfg.output_dir)
               if cfg.output_dir and main_rank else None)
    grad_norms = (GradNormAccumulator(cfg.output_dir if main_rank else None,
                                      dev_args.grad_norm_heads)
                  if dev_args.grad_norm_heads is not None else None)
    trainer = FinetuneTrainer(step, state, device=device,
                              crop_size=cfg.input_size, reprob=cfg.reprob,
                              dtype=dtype, log_writer=log_writer,
                              seed=cfg.seed, rank=rank,
                              grad_norms=grad_norms)
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
        # --dist_eval: each rank scores its share of the clips
        val_stats = validate(evaluator, val_ds, evaluate=(
            (lambda: evaluate_distributed(evaluator, val_ds))
            if cfg.dist_eval else None))
        if grad_norms is not None:
            grad_norms.save_epoch(epoch)
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


def check_device(device: str) -> None:
    """One device a process: several cards train through torchrun."""
    if "," in device:
        raise ValueError(f"--device {device!r}: one device a process; "
                         f"launch one process per card with torchrun "
                         f"--nproc_per_node=N")


if __name__ == "__main__":
    main()
