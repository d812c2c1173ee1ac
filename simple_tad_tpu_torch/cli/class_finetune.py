"""Action-recognition (Kinetics / SSV2 / ANet / HMDB) class fine-tuning
CLI, in PyTorch, on one device.

Port of simple_tad_tpu/cli/class_finetune.py (reference:
run_class_finetuning.py + engine_for_finetuning.py): TSN-sampled training
clips decoded on the host (data/video_cls_datasets.py), uploaded as uint8
and augmented on the device (ops/augment.py:train_augment_cls:
RandomResizedCrop -> flip -> full RandAugment -> normalize -> erasing ->
mixup / cutmix with label-smoothed soft targets), soft-target cross
entropy, AdamW with layer decay over ``model.cfg.depth`` and a per-step
cosine lr scaled by batch / 256; ``--eval`` runs the multi-(segment x
crop) test, the views in batches, softmax-averaged per video into top-1 /
top-5 (``merge_test_views``).  Same flags as the JAX CLI, plus
``--device`` (default cuda).  The model keeps fp32 masters computed in
``--dtype``; ``--finetune`` loads a reference ``.pth``
(utils/torch_convert.py:load_checkpoint_auto; ``--head_label_map`` remaps
a K710 head to 600 / 700 classes, 400 slices itself).

Probing (``--open_block_num``, cli/linear_probe.py): the freeze spec
'probe;K;P' of train/optim.py:freeze_mask_tree.  Without ``--clip_grad``
every parameter it freezes stops requiring a gradient
(FinetuneOptimizer.detach_frozen), so with ``--open_block_num 0`` the
trunk runs forward only (its attention the forward kernel, no lse, no
activations kept) and only the pooling head (with
``--open_clip_projector``), fc_norm and the classifier take part in
autograd.  Parameters after a step equal the JAX update-mask's; the
frozen parameters' Adam moments stay zero.  With ``--clip_grad`` the whole
graph is kept, as the JAX global norm counts the frozen gradients.

Not ported: more than one device (the JAX CLI's data-parallel mesh;
ROADMAP.md queue 1 item 5), and the optimizers of the menu other than
adamw and adam.

Usage (jobs/finetune/IV2-B_ft_K710.sh):
  python -m simple_tad_tpu_torch.cli.class_finetune \\
      --model internvideo2_base_patch14_224 --data_path /data/k710 \\
      --anno_train /data/k710/train.csv --nb_classes 710 \\
      --finetune B14_dist_1B_stage2.pth --batch_size 32 --epochs 20 \\
      --warmup_epochs 4 --lr 2e-4 --layer_decay 0.75 --num_frames 8 \\
      --sparse_sampling --short_side_size 224 --output_dir out/
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch

from simple_tad_tpu_torch.train.losses import cross_entropy


def get_args(argv=None):
    p = argparse.ArgumentParser("simple_tad_tpu_torch class finetuning")
    p.add_argument("--model", default="vit_base_patch16_224")
    p.add_argument("--data_path", default="")
    p.add_argument("--anno_train", required=True)
    p.add_argument("--anno_val", default="")
    p.add_argument("--anno_test", default="")
    p.add_argument("--nb_classes", type=int, default=400)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--sampling_rate", type=int, default=4)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--short_side_size", type=int, default=256)
    p.add_argument("--sparse_sampling", action="store_true",
                   help="SSV2-style TSN segment sampling")
    p.add_argument("--data_set", default="Kinetics",
                   help="Kinetics/SSV2-style CSV (default), ANet/HACS "
                        "(interval reader), HMDB51 (video TSN), "
                        "HMDB51_rawframe (frame folders)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--opt_eps", type=float, default=1e-8)
    p.add_argument("--opt_betas", type=float, nargs="+",
                   default=(0.9, 0.999))
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup_switch_prob", type=float, default=0.5)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--test_num_segment", type=int, default=5)
    p.add_argument("--test_num_crop", type=int, default=3)
    p.add_argument("--finetune", default="")
    p.add_argument("--head_label_map", default="",
                   help="json list of 710-space indices remapping a "
                        "K710-pretrained head to nb_classes 600/700")
    p.add_argument("--open_block_num", type=int, default=None)
    p.add_argument("--open_clip_projector", action="store_true")
    p.add_argument("--freeze", default="")
    p.add_argument("--output_dir", default="")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--attn_impl", default="auto",
                   help="accepted for the JAX CLI's flags; the port has "
                        "one attention path")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def build_model(args, device, param_dtype=torch.float32):
    """The model of ``--model`` at the run's geometry, seeded, with fp32
    masters (``param_dtype``; None: the weights in the compute dtype), then
    ``--finetune``'s weights."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto
    model = create_model(args.model, device=device,
                         generator=torch.Generator(device=device).manual_seed(
                             args.seed),
                         num_classes=args.nb_classes,
                         all_frames=args.num_frames, img_size=args.input_size,
                         drop_path_rate=args.drop_path,
                         dtype=compute_dtype(args), param_dtype=param_dtype)
    if args.finetune:
        label_map = None
        if args.head_label_map:
            import json
            with open(args.head_label_map) as f:
                label_map = json.load(f)
        load_checkpoint_auto(args.finetune, model, head_label_map=label_map)
    return model


def freeze_spec(args) -> str:
    """--freeze, or the probing spec of --open_block_num."""
    if args.open_block_num is not None:
        return f"probe;{args.open_block_num};{int(args.open_clip_projector)}"
    return args.freeze


def build_optimizer(args, model, steps_per_epoch: int):
    """The JAX CLI's AdamW: lr scaled by the batch over 256 on a per-step
    cosine (min_lr not scaled), constant weight decay, layer decay over
    the model's depth, the freeze spec; frozen parameters detached unless
    ``--clip_grad``."""
    from simple_tad_tpu_torch.train import optim as O
    lr = O.scale_lr_by_batch(args.lr, args.batch_size)
    sched = O.cosine_scheduler(lr, args.min_lr, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs)
    opt = O.FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=O.array_schedule(sched),
        weight_decay=args.weight_decay, layer_decay=args.layer_decay,
        depth=model.cfg.depth, betas=tuple(args.opt_betas), eps=args.opt_eps,
        clip_grad=args.clip_grad, freeze_layers=freeze_spec(args) or None,
        opt=args.opt)
    if opt.freeze is not None and not args.clip_grad:
        opt.detach_frozen()
    return opt


def build_dataset(args, mode: str):
    from simple_tad_tpu_torch.data.video_cls_datasets import build_cls_dataset
    anno = (args.anno_train if mode == "train"
            else args.anno_test or args.anno_val)
    kw = dict(mode=mode, clip_len=args.num_frames,
              frame_sample_rate=args.sampling_rate,
              crop_size=args.input_size,
              short_side_size=args.short_side_size,
              sparse_sampling=args.sparse_sampling)
    if mode == "test":
        kw.update(test_num_segment=args.test_num_segment,
                  test_num_crop=args.test_num_crop)
    return build_cls_dataset(args.data_set, anno, args.data_path, **kw)


def epoch_batches(train_ds, batch_size: int, steps: int,
                  rng: np.random.Generator) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of host batches, as the JAX CLI draws them: a permutation
    (wrapped to fill every batch of a tiny dataset), each clip decoded and
    TSN-sampled with ``rng``, cropped to the batch's smallest frame ->
    {'video_u8': (B, T, H, W, 3) uint8, 'label': (B,) int64}."""
    n = steps * batch_size
    order = rng.permutation(len(train_ds))[:n]
    if len(order) < n:
        order = np.resize(order, n)
    for s in range(steps):
        clips, ys = zip(*(train_ds.get_train_clip(int(i), rng)
                          for i in order[s * batch_size:(s + 1) * batch_size]))
        h = min(c.shape[1] for c in clips)
        w = min(c.shape[2] for c in clips)
        yield {"video_u8": np.stack([c[:, :h, :w] for c in clips]),
               "label": np.asarray(ys, np.int64)}


class ClassFinetuneTrainer:
    """The class fine-tuning epoch loop on one device.  Each host batch is
    pinned while the previous step runs; after that step's loss is read it
    is uploaded as uint8 and augmented on the device (train_augment_cls,
    from a generator seeded from ``seed`` and the epoch), and
    ``train_step`` runs on the video and its soft targets."""

    def __init__(self, train_step, state, *, device, args):
        self.train_step = train_step
        self.state = state
        self.device = torch.device(device)
        self.aug = dict(crop_size=args.input_size,
                        num_classes=args.nb_classes, reprob=args.reprob,
                        mixup=args.mixup, cutmix=args.cutmix,
                        switch_prob=args.mixup_switch_prob,
                        smoothing=args.smoothing, dtype=compute_dtype(args))
        self.seed = args.seed + 2

    def stage(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def device_batch(self, staged, generator) -> Dict[str, torch.Tensor]:
        from simple_tad_tpu_torch.ops.augment import train_augment_cls
        u8 = staged["video_u8"].to(self.device, non_blocking=True)
        labels = staged["label"].to(self.device, non_blocking=True)
        video, targets = train_augment_cls(u8, labels, generator, **self.aug)
        return {"video": video, "label": labels, "smoothed": targets}

    def train_one_epoch(self, batches, epoch: int,
                        print_freq: int = 10) -> Dict[str, float]:
        from simple_tad_tpu_torch.utils.logging import MetricLogger
        ml = MetricLogger(print_freq=print_freq)
        aug = torch.Generator(device=self.device)
        aug.manual_seed(self.seed * 1_000_003 + epoch)
        metrics = None
        for batch in ml.log_every(batches, header=f"Epoch [{epoch}]"):
            staged = self.stage(batch)    # overlaps the step in flight
            if metrics is not None:
                self._log(ml, metrics)
            metrics, _ = self.train_step(self.state,
                                         self.device_batch(staged, aug))
        if metrics is not None:
            self._log(ml, metrics)
        return ml.epoch_stats()

    @staticmethod
    def _log(ml, metrics) -> None:
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss is {loss}")
        ml.update(loss=loss, grad_norm=float(metrics["grad_norm"]))


def soft_target_criterion(logits, labels, smoothed, ttc):
    """SoftTargetCrossEntropy (run_class_finetuning.py:467)."""
    return cross_entropy(logits, smoothed)


@torch.no_grad()
def evaluate(model, test_ds, batch_size: int, device):
    """The multi-view test: the views in batches of ``batch_size``,
    normalized on the device, logits in fp32, softmax-averaged per video
    -> (top-1, top-5, videos, views)."""
    from simple_tad_tpu_torch.data.video_cls_datasets import merge_test_views
    from simple_tad_tpu_torch.ops.augment import normalize
    model.eval()
    dtype = model.cfg.dtype
    logits_all, vids, labels, buf = [], [], [], []
    for vi in range(len(test_ds)):
        clip, y, vid, _, _ = test_ds.get_test_view(vi)
        buf.append((clip, y, vid))
        if len(buf) == batch_size or vi == len(test_ds) - 1:
            x = torch.from_numpy(np.stack([b[0] for b in buf])).to(device)
            lg = model(normalize(x.float()).to(dtype)).float().cpu().numpy()
            for j, (_, y_j, vid_j) in enumerate(buf):
                logits_all.append(lg[j])
                labels.append(y_j)
                vids.append(vid_j)
            buf = []
    top1, top5 = merge_test_views(logits_all, vids, labels)
    return top1, top5, len(set(vids)), len(vids)


def main(argv=None):
    args = get_args(argv)
    if "," in args.device:
        raise NotImplementedError(
            "training on more than one device is not ported yet "
            "(ROADMAP.md queue 1 item 5)")
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    from simple_tad_tpu_torch.utils import checkpoint as ckpt_utils

    device = torch.device(args.device)
    if args.eval:
        model = build_model(args, device, param_dtype=None)
        top1, top5, n_vid, n_view = evaluate(
            model, build_dataset(args, "test"), args.batch_size, device)
        print(f"test top1 {top1:.2f} top5 {top5:.2f} ({n_vid} videos, "
              f"{n_view} views)")
        return top1, top5

    model = build_model(args, device)
    train_ds = build_dataset(args, "train")
    steps = max(len(train_ds) // args.batch_size, 1)
    optimizer = build_optimizer(args, model, steps)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + 1)
    state = TrainState.create(model, optimizer, generator)
    trainer = ClassFinetuneTrainer(
        make_finetune_train_step(soft_target_criterion), state,
        device=device, args=args)
    print(f"train clips: {len(train_ds)}  steps/epoch: {steps}  frozen "
          f"(detached): {len(optimizer.detached)} parameters  device: "
          f"{device}")
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        t0 = time.time()
        stats = trainer.train_one_epoch(
            epoch_batches(train_ds, args.batch_size, steps, rng), epoch)
        print(f"[epoch {epoch}] loss {stats.get('loss', 0):.4f} "
              f"({time.time() - t0:.0f}s)")
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            ckpt_utils.save_train_state(args.output_dir, state, epoch)
    return state


if __name__ == "__main__":
    main()
