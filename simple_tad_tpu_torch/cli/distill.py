"""Knowledge-distillation CLI, in PyTorch: teacher -> student, on one
device or data-parallel under ``torchrun --nproc_per_node=N -m
simple_tad_tpu_torch.cli.distill ...`` (as cli/finetune.py: ``--batch_size``
per card, each rank decodes its rows of the global batch, the lr scales by
the global batch, the student's gradients are averaged across the ranks;
each rank holds its own copy of the frozen teacher).

Port of simple_tad_tpu/cli/distill.py, with its flags plus ``--device``
(default cuda; the run does not fall back to the CPU, ``--device cpu``
asks for it).  Three objectives (train/distill.py):

* ``--objective logit_kd`` (labeled, DoTA / DADA frame windows): the frozen
  teacher's soft logits at temperature T beside the hard-label loss;
* ``--objective feature`` (unlabeled): 2 - 2 cos between the final
  features, through a Linear aligner where the widths differ;
* ``--objective masked_feature`` (unlabeled, the reference's stage-2
  recipe, jobs/distill/IV2-S_dist_1B.sh): the frozen InternVideo2 teacher
  on the whole clip returns K l2-normalized block outputs, its pooled
  feature and its pooling attention; the distill_internvideo2_* student
  runs on the visible tokens of a masked clip (``--mask_type tube``,
  ``random`` or ``attention``: importance-sampled from the teacher's
  pooling attention with Gumbel noise from the step's generator) and
  aligns each decoded tap with the teacher's at the visible positions,
  and its decoded final feature with the teacher's.

Kinetics sources (K700) go through the pre-training loader
(data/pretrain_datasets.py: one TSN window a video an epoch; its tube
masks are generated and ignored for ``attention``), DoTA and DADA through
the frame-window loader (train/engine.py:TrainLoader).  Each batch goes
to the device as uint8 and is augmented there (ops/augment.py:
train_augment).  The student trains with fp32 masters computed in
``--dtype``; the teacher keeps its weights in ``--dtype`` and runs grad
free.  AdamW (train/optim.py; ``--opt_betas`` and ``--opt_eps``, the
JAX CLI's values unless given) at lr ``--lr`` x batch / 256 on a cosine
schedule; ``DistillTrainer`` is the epoch loop.  Each epoch writes the student's weights as
``checkpoint-<epoch>.pth`` (weights only, the reference's key names;
utils/torch_convert.py:load_checkpoint_auto reads them).  A teacher
``.pth`` (``--teacher_ckpt``) loads through the model's loader.

Usage (jobs/distill/IV2-S_dist_1B.sh):
  python -m simple_tad_tpu_torch.cli.distill \\
      --objective masked_feature --mask_type attention --mask_ratio 0.8 \\
      --clip_return_layer 6 --clip_teacher_return_interval 3.34 \\
      --clip_student_return_interval 1 --clip_teacher_embed_dim 1408 \\
      --clip_teacher_final_dim 768 --clip_loss_ratio 1 1 \\
      --clip_norm_type l2 --clip_student_decoder mlp --drop_path 0.05 \\
      --data_set K700 --data_path /data/k700 \\
      --model distill_internvideo2_small_patch14_224 \\
      --teacher_model internvideo2_1B_patch14_224 \\
      --teacher_ckpt internvideo2_1B_stage2.pth \\
      --batch_size 128 --epochs 101 --warmup_epochs 20 --lr 1e-3 \\
      --weight_decay 0.05 --num_frames 8 --sampling_rate 1 \\
      --output_dir out/ --device cuda
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("simple_tad_tpu_torch distillation")
    p.add_argument("--data_set", default="DoTA")
    p.add_argument("--data_path", required=True)
    p.add_argument("--model", default="vit_small_patch16_224")
    p.add_argument("--teacher_model", default="vit_large_patch16_224")
    p.add_argument("--teacher_ckpt", default="")
    p.add_argument("--finetune", default="", help="student init ckpt")
    p.add_argument("--nb_classes", type=int, default=2)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--view_fps", type=int, default=10)
    p.add_argument("--sampling_rate", type=int, default=1)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--warmup_epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--opt_betas", type=float, nargs=2, default=[0.9, 0.999],
                   help="AdamW betas (the JAX CLI's; the reference stage-2 "
                        "recipe's are 0.9 0.98)")
    p.add_argument("--opt_eps", type=float, default=1e-8,
                   help="AdamW eps (the JAX CLI's; the recipe's is 1e-6)")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--objective", default="logit_kd",
                   choices=["logit_kd", "feature", "masked_feature"])
    # the stage-2 recipe (run_distill.py:67-95; defaults from
    # scripts/distillation/S14_dist_1B_stage2.sh)
    p.add_argument("--mask_type", default="attention",
                   choices=["tube", "random", "attention"])
    p.add_argument("--mask_ratio", type=float, default=0.8)
    p.add_argument("--clip_return_layer", type=int, default=6)
    p.add_argument("--clip_teacher_return_interval", type=float,
                   default=1.0)
    p.add_argument("--clip_student_return_interval", type=float,
                   default=1.0)
    p.add_argument("--clip_teacher_embed_dim", type=int, default=0,
                   help="teacher middle-feature width (0 = the teacher "
                        "trunk's embed_dim)")
    p.add_argument("--clip_teacher_final_dim", type=int, default=768,
                   help="0 disables final-feature alignment")
    p.add_argument("--clip_loss_ratio", type=float, nargs=2,
                   default=[1.0, 1.0], help="middle/final loss weights")
    p.add_argument("--clip_norm_type", default="l2", choices=["l2", "none"])
    p.add_argument("--clip_student_decoder", default="mlp",
                   choices=["linear", "mlp"])
    p.add_argument("--drop_path", type=float, default=0.05)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--output_dir", default="")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--attn_impl", default="auto",
                   help="accepted for the JAX CLI's flag set; the port has "
                        "one attention path")
    p.add_argument("--device", default="cuda")
    p.add_argument("--native_decoder", action="store_true",
                   help="decode the DoTA / DADA zips with the C++ decoder "
                        "(data/native.py); raises where it cannot be built")
    return p


def _feat_dim(model) -> int:
    return getattr(model.cfg, "clip_embed_dim", None) or model.cfg.embed_dim


def build_models(args, device, dtype):
    """-> (student, teacher): the teacher in ``dtype``, grad free; the
    student with fp32 masters computed in ``dtype``, seeded from
    ``--seed`` (the teacher from seed + 1), then the checkpoints."""
    from simple_tad_tpu_torch.models import create_model, model_family
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    common = dict(num_classes=args.nb_classes, all_frames=args.num_frames,
                  img_size=args.input_size, dtype=dtype)
    # the teacher (IV2-1B: 1B weights) is initialised where it runs
    teacher = create_model(
        args.teacher_model, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        **common)
    if args.objective == "masked_feature":
        if model_family(args.model) != "iv2_distill":
            raise ValueError("masked_feature needs a distill_* student "
                             "(masked trunk + tap decoders)")
        if model_family(args.teacher_model) != "iv2":
            raise ValueError("masked_feature needs an InternVideo2 teacher")
        extra = dict(
            drop_path_rate=args.drop_path,
            clip_teacher_embed_dim=(args.clip_teacher_embed_dim
                                    or teacher.cfg.embed_dim),
            clip_teacher_final_dim=args.clip_teacher_final_dim,
            clip_return_layer=args.clip_return_layer,
            clip_student_return_interval=args.clip_student_return_interval,
            clip_norm_type=args.clip_norm_type,
            clip_student_decoder=args.clip_student_decoder)
    else:
        extra = {}
    student = create_model(
        args.model, device=device, param_dtype=torch.float32,
        generator=torch.Generator().manual_seed(args.seed),
        **common, **extra)
    if args.objective == "masked_feature":
        if student.cfg.grid_size != teacher.cfg.grid_size:
            raise ValueError(
                f"student grid {student.cfg.grid_size} != teacher grid "
                f"{teacher.cfg.grid_size}: middle-feature alignment needs "
                "matching token grids")
        if (args.clip_teacher_final_dim > 0
                and args.clip_teacher_final_dim
                != teacher.cfg.clip_embed_dim):
            raise ValueError(
                f"--clip_teacher_final_dim {args.clip_teacher_final_dim} "
                f"!= teacher clip_embed_dim {teacher.cfg.clip_embed_dim} "
                "(final alignment targets the teacher's pooled feature)")
    if args.finetune:
        load_checkpoint_auto(args.finetune, student)
    if args.teacher_ckpt:
        load_checkpoint_auto(args.teacher_ckpt, teacher)
        print(f"teacher from {args.teacher_ckpt}")
    return student, teacher


def build_loader(args, rank: int = 0, world: int = 1):
    """-> (loader, kinetics): the unlabeled Kinetics loader of the feature
    objectives, or the frame-window loader of DoTA / DADA; at ``world`` >
    1 each draws the global batch and yields this ``rank``'s rows."""
    if args.data_set in ("K700", "Kinetics-700", "Kinetics-400"):
        if args.objective not in ("feature", "masked_feature"):
            raise ValueError("Kinetics sources are unlabeled - use "
                             "--objective feature/masked_feature")
        from simple_tad_tpu_torch.data.pretrain_datasets import (
            KineticsPretrainDataset, PretrainLoader, VideoFileSource,
            read_kinetics_clips)
        paths = read_kinetics_clips(args.data_path, "annotations/train.csv")
        ds = KineticsPretrainDataset(
            VideoFileSource(paths, half_first=False),
            view_len=args.num_frames, sampling_rate=args.sampling_rate,
            mode="tsn", target_fps=args.view_fps, seed=args.seed)
        window = (args.num_frames, args.input_size // 14,
                  args.input_size // 14)
        # the attention mask is drawn from the teacher on the device; the
        # loader still generates (ignored) tube masks
        return PretrainLoader(
            ds, args.batch_size * world, rank=rank, world=world,
            window_size=window,
            mask_ratio=(args.mask_ratio
                        if args.objective == "masked_feature" else 0.75),
            mask_type=("tube" if args.mask_type == "attention"
                       else args.mask_type),
            seed=args.seed, num_threads=args.num_workers), True
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dada_clips,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.train.engine import TrainLoader
    if args.objective == "masked_feature":
        raise ValueError("masked_feature trains on unlabeled video lists "
                         "(K700/K710) - use a Kinetics source")
    if args.data_set == "DoTA":
        clips = read_dota_clips(args.data_path, "train_split.txt",
                                orig_fps=10)
        orig_fps = 10
    elif args.data_set in ("DADA2K", "DADA"):
        clips = read_dada_clips(args.data_path,
                                "DADA2K_my_split/training.txt", orig_fps=30)
        orig_fps = 30
    else:
        raise ValueError(f"unknown data_set {args.data_set}")
    ds = FrameDataset(clips, mode="train", view_len=args.num_frames,
                      target_fps=args.view_fps, orig_fps=orig_fps,
                      view_step=args.sampling_rate, crop_size=args.input_size,
                      native_decoder=args.native_decoder)
    return TrainLoader(ds, args.batch_size * world, seed=args.seed,
                       num_threads=args.num_workers, rank=rank,
                       world=world), False


class DistillTrainer:
    """The distillation epoch loop on one device (one rank of a
    data-parallel run).  Each loader batch goes to the device as uint8 and
    is augmented there (ops/augment.py: train_augment) from one generator
    seeded from ``seed`` + 3 and ``rank``; then ``train_step`` runs on it,
    with the batch's mask (masked_feature) or labels (logit_kd)."""

    def __init__(self, train_step, state, *, device, objective: str,
                 crop_size: int = 224, reprob: float = 0.25,
                 dtype=torch.bfloat16, seed: int = 0, rank: int = 0):
        from simple_tad_tpu_torch.parallel.mesh import rank_seed
        self.train_step = train_step
        self.state = state
        self.device = torch.device(device)
        self.objective = objective
        self.crop_size = crop_size
        self.reprob = reprob
        self.dtype = dtype
        self.aug = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed + 3, rank))

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        from simple_tad_tpu_torch.ops.augment import train_augment
        u8 = torch.from_numpy(np.ascontiguousarray(batch["video_u8"]))
        out = {"video": train_augment(u8.to(self.device), self.aug,
                                      crop_size=self.crop_size,
                                      reprob=self.reprob, dtype=self.dtype)}
        if self.objective == "masked_feature":
            out["mask"] = torch.from_numpy(batch["mask"]).to(self.device)
        elif self.objective == "logit_kd":
            out["label"] = torch.as_tensor(batch["label"]).to(self.device)
        return out

    def train_one_epoch(self, batches, epoch: int, print_freq: int = 10):
        """-> the epoch's MetricLogger."""
        from simple_tad_tpu_torch.utils.logging import MetricLogger
        ml = MetricLogger(print_freq=print_freq)
        for batch in ml.log_every(batches, header=f"Epoch [{epoch}]"):
            metrics = self.train_step(self.state, self.device_batch(batch))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss is {loss}")
            ml.update(**{k: float(v) for k, v in metrics.items()})
        return ml


def build_trainer(args, student, teacher, device, dtype,
                  steps_per_epoch: int, loader_masked: Optional[int] = None,
                  data_parallel=None) -> DistillTrainer:
    """The objective's step, the optimizer (train/optim.py: AdamW at lr
    ``--lr`` x global batch / 256 on a cosine schedule) and the train state
    -> the trainer.  ``loader_masked``: the tokens the loader's tube or
    random masks hide (masked_feature without ``attention``)."""
    from simple_tad_tpu_torch.parallel.mesh import rank_seed
    from simple_tad_tpu_torch.train import distill as D
    from simple_tad_tpu_torch.train import optim as O
    from simple_tad_tpu_torch.train.steps import TrainState

    world, rank = ((data_parallel.world, data_parallel.rank)
                   if data_parallel is not None else (1, 0))
    lr = args.lr * args.batch_size * world / 256.0
    sched = O.cosine_scheduler(lr, 1e-6, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs)
    model = student
    if args.objective == "masked_feature":
        t_taps = D.teacher_tap_indices(teacher.cfg.depth,
                                       args.clip_return_layer,
                                       args.clip_teacher_return_interval)
        n_patch = student.cfg.num_patches
        num_masked = (int(n_patch * args.mask_ratio)
                      if args.mask_type == "attention"
                      else int(loader_masked))
        print(f"teacher taps {t_taps}, student taps "
              f"{student.cfg.return_index}, num_masked {num_masked}/"
              f"{n_patch}")
        step_fn = D.make_masked_distill_step(
            teacher, num_masked=num_masked, teacher_taps=t_taps,
            loss_ratio=args.clip_loss_ratio, mask_type=args.mask_type)
    elif args.objective == "feature":
        if _feat_dim(student) != _feat_dim(teacher):
            # the reference's Linear_Decoder aligns the student's width to
            # the teacher's; the IV2 trunks all share clip_embed_dim 768
            model = D.FeatureStudent(
                student, _feat_dim(student), _feat_dim(teacher),
                generator=torch.Generator().manual_seed(args.seed + 4))
        step_fn = D.make_feature_distill_step(teacher)
    else:
        step_fn = D.make_distill_step(teacher, alpha=args.alpha,
                                      temperature=args.temperature)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(sched),
                              weight_decay=args.weight_decay,
                              betas=tuple(args.opt_betas), eps=args.opt_eps,
                              data_parallel=data_parallel)
    generator = torch.Generator(device=device).manual_seed(
        rank_seed(args.seed + 2, rank))
    state = TrainState.create(model, opt, generator)
    return DistillTrainer(step_fn, state, device=device,
                          objective=args.objective,
                          crop_size=args.input_size, reprob=args.reprob,
                          dtype=dtype, seed=args.seed, rank=rank)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from simple_tad_tpu_torch.cli.finetune import check_device
    from simple_tad_tpu_torch.parallel.mesh import data_parallel_setup
    from simple_tad_tpu_torch.utils import checkpoint as ckpt_utils

    check_device(args.device)
    if args.native_decoder:         # fail before the models are built
        from simple_tad_tpu_torch.data import native
        native.load()
    dp = data_parallel_setup(args.device)
    world, rank, device = dp
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    student, teacher = build_models(args, device, dtype)
    loader, _ = build_loader(args, rank, world)
    trainer = build_trainer(args, student, teacher, device, dtype,
                            loader.steps_per_epoch(),
                            getattr(loader, "num_masked", None), dp)
    for epoch in range(args.epochs):
        t0 = time.time()
        ml = trainer.train_one_epoch(loader.epoch(epoch), epoch)
        print(f"[epoch {epoch}] {ml} ({time.time() - t0:.0f}s)")
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            ckpt_utils.save_weights(args.output_dir,
                                    trainer.state.model.state_dict(),
                                    f"checkpoint-{epoch}")
    return trainer.state


if __name__ == "__main__":
    main()
