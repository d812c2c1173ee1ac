"""MAE / DAPT pre-training CLI, in PyTorch, on one device.

Port of simple_tad_tpu/cli/pretrain.py (reference: run_mae_pretraining.py,
and run_mae_double_pretraining.py for the dual-dataset DAPT: BDD100K +
CAP-DATA, batches concatenated per step, a hard stop at --stop_at_epoch):
the single loop, the double loop (``CyclicZip``: the longer dataset drives
the epoch, the shorter cycles) and the triple loop (--data_set3,
``CyclicZipN``); ``--from_ckpt`` warm-starts from a reference VideoMAE
pre-training .pth; auto-resume from ``checkpoint-last.pth``.  Same flags
as the JAX CLI, plus ``--device`` (default cuda; the run does not fall
back to the CPU, ``--device cpu`` asks for it).  Each batch goes to the
device as uint8 and is augmented there (ops/augment.py:
pretrain_augment_align with ``--transforms_finetune_align``, else
pretrain_augment_orig); the model is PretrainVideoMAE (or
PretrainIV2VideoMAE) with fp32 masters
computed in ``--dtype``.  Every epoch writes ``checkpoint-last.pth``, and
every ``--save_ckpt_freq`` epochs the weights as ``checkpoint-<epoch>.pth``
under the reference's key names, which cli/finetune.py ``--finetune``
loads into the ViT (the encoder's weights; utils/torch_convert.py).

``--model pretrain_videomae_internvideo2_{,small_,base_,...}patch14_224``
pre-trains InternVideo2 (PretrainIV2VideoMAE; jobs/dapt/
IV2-S_dapt_bdd_capdata.sh: tube masks at 0.75 over 16 x 16 x 16 tokens,
BDD100K + CAP-DATA).  Its tubelet is the family's own (1) whatever
``--tubelet_size`` says: the JAX CLI passes the flag's default 2 to the
model, whose 588-wide head then fails its assertion (ROADMAP.md F7).
``--from_ckpt`` takes a DAPT checkpoint, or an InternVideo2 trunk or
stage-2 student ``.pth`` for the encoder (utils/torch_convert.py:
load_iv2_mae_checkpoint).

``--use_checkpoint`` checkpoints each encoder and decoder block
(models/layers.py:block_call): the DAPT job's 240 + 160 clips a step fit
one H100 that way, or as 2 x (120 + 80) with ``--update_freq 2``
(README.md).  Data parallelism as cli/finetune.py: ``torchrun
--nproc_per_node=N -m simple_tad_tpu_torch.cli.pretrain ...``; each
``--batch_size*`` is per card, every loader draws the global batch and
each rank decodes its own rows of each, and the lr scales by the global
batch (batch_size + batch_size2 + batch_size3) x update_freq x N / 256.

Usage (the DAPT job, jobs/dapt/pretrain_bdd_capdata.sh):
  python -m simple_tad_tpu_torch.cli.pretrain \\
      --model pretrain_videomae_base_patch16_224 \\
      --data_set BDD100K --data_path /data/bdd100k --batch_size 240 \\
      --data_set2 DoTA --data_path2 /data/capdata --batch_size2 160 \\
      --mask_ratio 0.75 --transforms_finetune_align --decoder_depth 4 \\
      --sampling_rate 16 --lr 3e-4 --min_lr 1e-5 --opt_betas 0.9 0.95 \\
      --warmup_epochs 1 --epochs 800 --stop_at_epoch 12 \\
      --nb_samples_per_epoch 1000000 --from_ckpt k700.pth \\
      --output_dir out/ --device cuda
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from simple_tad_tpu_torch.config import PretrainConfig


def _build_source(data_set: str, data_path: str, cfg,
                  view_list: str = "", clips_list: str = "",
                  native_decoder: bool = False):
    """The window dataset of one ``--data_set`` (the JAX CLI's
    _build_source); ``native_decoder`` decodes DoTA / DADA zips with the
    C++ decoder (data/native.py)."""
    from simple_tad_tpu_torch.data.frame_datasets import (read_dada_clips,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.data.pretrain_datasets import (
        PretrainWindowDataset, VideoFileSource, ZipClipSource)
    if data_set == "DoTA":
        clips = read_dota_clips(data_path, "all_split.txt", orig_fps=10)
        source = ZipClipSource(clips, native_decoder=native_decoder)
        orig_fps = 10
    elif data_set in ("DADA2K", "DADA"):
        clips = read_dada_clips(data_path, "DADA2K_my_split/all.txt",
                                orig_fps=30)
        source = ZipClipSource(clips, native_decoder=native_decoder)
        orig_fps = 30
    elif data_set == "BDD100K":
        from simple_tad_tpu_torch.data.pretrain_datasets import read_bdd_clips
        names = read_bdd_clips(data_path, clips_list=clips_list or None)
        paths = [os.path.join(data_path, "videos", n) for n in names]
        # BDD100K enumerates views with RegularSequencerWithStart
        # (bdd100k.py:32,38-49)
        return PretrainWindowDataset(
            VideoFileSource(paths), view_len=cfg.num_frames,
            target_fps=cfg.view_fps, orig_fps=30,
            view_step=cfg.sampling_rate, view_list=view_list or None,
            with_start=True)
    elif data_set in ("K700", "Kinetics-700", "Kinetics-400",
                      "K700_aligned"):
        # one window per video per epoch: TSN sampling, or fps-aligned
        # interpolation (kinetics.py VideoMAE:463 / _aligned:850)
        from simple_tad_tpu_torch.data.pretrain_datasets import (
            KineticsPretrainDataset, read_kinetics_clips)
        paths = read_kinetics_clips(data_path, "annotations/train.csv")
        return KineticsPretrainDataset(
            VideoFileSource(paths, half_first=False),
            view_len=cfg.num_frames, sampling_rate=cfg.sampling_rate,
            mode="aligned" if data_set == "K700_aligned" else "tsn",
            target_fps=cfg.view_fps, seed=cfg.seed)
    else:
        raise ValueError(data_set)
    return PretrainWindowDataset(
        source, view_len=cfg.num_frames, target_fps=cfg.view_fps,
        orig_fps=orig_fps, view_step=cfg.sampling_rate,
        view_list=view_list or None)


class PretrainTrainer:
    """The pre-training epoch loop on one device (one rank of a
    data-parallel run).  Each step's loader batches (one per dataset) are
    copied into pinned host memory while the previous step runs on the
    device; after that step's loss is read they are uploaded as uint8,
    concatenated and augmented on the device from a generator seeded from
    ``seed``, the epoch and ``rank``, and ``train_step`` runs on them."""

    def __init__(self, train_step, state, *, device, crop_size: int = 224,
                 align: bool = True, dtype=torch.bfloat16, seed: int = 0,
                 rank: int = 0):
        from simple_tad_tpu_torch.ops import augment
        self.train_step = train_step
        self.state = state
        self.device = torch.device(device)
        self.crop_size = crop_size
        self.augment = (augment.pretrain_augment_align if align
                        else augment.pretrain_augment_orig)
        self.dtype = dtype
        self.seed = seed
        self.rank = rank

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if self.device.type == "cuda" else t

    def stage(self, parts):
        """The host side of a batch: each part's uint8 video and mask as
        tensors, pinned for the device (no concatenation on the host)."""
        return [(self._stage(p["video_u8"]), self._stage(p["mask"]))
                for p in parts]

    def device_batch(self, staged, generator) -> Dict[str, torch.Tensor]:
        """Upload the staged parts, concatenate them on the device and
        augment the video there."""
        def put(ts):
            ts = [t.to(self.device, non_blocking=True) for t in ts]
            return ts[0] if len(ts) == 1 else torch.cat(ts)
        return {"video": self.augment(put([v for v, _ in staged]), generator,
                                      crop_size=self.crop_size,
                                      dtype=self.dtype),
                "mask": put([m for _, m in staged])}

    def train_one_epoch(self, batches, epoch: int,
                        print_freq: int = 10) -> Dict[str, float]:
        from simple_tad_tpu_torch.utils.logging import MetricLogger
        ml = MetricLogger(print_freq=print_freq)
        from simple_tad_tpu_torch.parallel.mesh import rank_seed
        aug = torch.Generator(device=self.device)
        aug.manual_seed(rank_seed(self.seed * 1_000_003 + epoch, self.rank))
        metrics = None
        for parts in ml.log_every(batches, header=f"Epoch [{epoch}]"):
            staged = self.stage(parts)    # overlaps the step in flight
            if metrics is not None:
                self._log(ml, metrics)
            metrics = self.train_step(self.state,
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


def epoch_batches(epoch: int, loader1, loader2=None, loader3=None):
    """One epoch of loader batches as tuples, one batch per dataset: the
    first loader alone; two zipped, the longer dataset driving and the
    shorter cycling (CyclicZip); three with the first driving
    (CyclicZipN)."""
    from simple_tad_tpu_torch.data.pretrain_datasets import (CyclicZip,
                                                             CyclicZipN)
    if loader2 is None:
        for b in loader1.epoch(epoch):
            yield (b,)
    elif loader3 is not None:
        yield from CyclicZipN(loader1.epoch, loader2.epoch,
                              loader3.epoch).epoch(epoch)
    else:
        first_longer = len(loader1.dataset) >= len(loader2.dataset)
        long, short = (loader1, loader2) if first_longer else (loader2,
                                                                loader1)
        yield from CyclicZip(long.epoch, short.epoch).epoch(epoch)


def build_optimizer(cfg: PretrainConfig, model, steps_per_epoch: int,
                    data_parallel=None):
    """AdamW (or ``--opt``) of the JAX CLI: lr scaled by the global batch /
    256 (min_lr and warmup_lr are not scaled), per-update cosine lr and wd
    schedules, no layer decay."""
    from simple_tad_tpu_torch.train import optim as O
    world = data_parallel.world if data_parallel is not None else 1
    total_batch = ((cfg.batch_size + (cfg.batch_size2 or 0)
                    + (cfg.batch_size3 or 0)) * cfg.update_freq * world)
    lr = cfg.lr * total_batch / 256.0
    opt_steps_per_epoch = max(steps_per_epoch // cfg.update_freq, 1)
    lr_sched = O.cosine_scheduler(lr, cfg.min_lr, cfg.epochs,
                                  opt_steps_per_epoch,
                                  warmup_epochs=cfg.warmup_epochs,
                                  start_warmup_value=cfg.warmup_lr,
                                  warmup_steps=cfg.warmup_steps)
    wd_end = (cfg.weight_decay if cfg.weight_decay_end is None
              else cfg.weight_decay_end)
    wd_sched = O.cosine_scheduler(cfg.weight_decay, wd_end, cfg.epochs,
                                  opt_steps_per_epoch)
    return O.FinetuneOptimizer(
        dict(model.named_parameters()),
        lr_schedule=O.array_schedule(lr_sched),
        wd_schedule=O.array_schedule(wd_sched),
        weight_decay=cfg.weight_decay, betas=tuple(cfg.opt_betas),
        eps=cfg.opt_eps, clip_grad=cfg.clip_grad, opt=cfg.opt,
        update_freq=cfg.update_freq, data_parallel=data_parallel)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--native_decoder", action="store_true",
                     help="decode the zips with the C++ decoder "
                          "(data/native.py); raises where it cannot be "
                          "built")
    dev_args, rest = pre.parse_known_args(argv)
    cfg = PretrainConfig.from_args(rest)
    if dev_args.native_decoder:     # fail before the model is built
        from simple_tad_tpu_torch.data import native
        native.load()

    from simple_tad_tpu_torch.data.pretrain_datasets import PretrainLoader
    from simple_tad_tpu_torch.models import create_model, model_family
    from simple_tad_tpu_torch.parallel import multihost
    from simple_tad_tpu_torch.parallel.mesh import (data_parallel_setup,
                                                    rank_seed)
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_mae_train_step)
    from simple_tad_tpu_torch.utils import checkpoint as ckpt_utils
    from simple_tad_tpu_torch.utils.logging import JsonlLogger
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto

    family = model_family(cfg.model)
    if family not in ("mae", "iv2_mae"):
        raise ValueError(f"{cfg.model!r} is not a pre-training model")
    if cfg.data_set3 and not cfg.data_set2:
        raise ValueError("--data_set3 requires --data_set2")
    dp = data_parallel_setup(dev_args.device)
    world, rank, device = dp
    main_rank = multihost.is_main_process()
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tubelet = {}
    if family == "mae":
        tubelet = dict(tubelet_size=cfg.tubelet_size)
    else:
        print(f"InternVideo2 DAPT: tubelet 1, the family's own "
              f"(--tubelet_size {cfg.tubelet_size} is not used)")
    model = create_model(cfg.model, device=device,
                         generator=torch.Generator().manual_seed(cfg.seed),
                         all_frames=cfg.num_frames, img_size=cfg.input_size,
                         decoder_depth=cfg.decoder_depth,
                         drop_path_rate=cfg.drop_path, dtype=dtype,
                         param_dtype=torch.float32, remat=cfg.use_checkpoint,
                         **tubelet)
    patch = model.cfg.patch_size
    window_size = (cfg.num_frames // model.cfg.tubelet_size,
                   cfg.input_size // patch, cfg.input_size // patch)

    def loader(data_set, data_path, view_list, clips_list, batch, seed):
        ds = _build_source(data_set, data_path, cfg, view_list, clips_list,
                           dev_args.native_decoder)
        return PretrainLoader(ds, batch * world, window_size=window_size,
                              mask_ratio=cfg.mask_ratio,
                              mask_type=cfg.mask_type, seed=seed,
                              nb_samples_per_epoch=cfg.nb_samples_per_epoch,
                              num_threads=cfg.num_workers, rank=rank,
                              world=world)

    loader1 = loader(cfg.data_set, cfg.data_path, cfg.view_list,
                     cfg.clips_list, cfg.batch_size, cfg.seed)
    loader2 = loader3 = None
    if cfg.data_set2:
        loader2 = loader(cfg.data_set2, cfg.data_path2, cfg.view_list2,
                         cfg.clips_list2, cfg.batch_size2 or cfg.batch_size,
                         cfg.seed + 1)
    if cfg.data_set3:
        loader3 = loader(cfg.data_set3, cfg.data_path3, cfg.view_list3,
                         cfg.clips_list3, cfg.batch_size3 or cfg.batch_size,
                         cfg.seed + 7)
    num_masked = loader1.num_masked

    if cfg.from_ckpt:
        load_checkpoint_auto(cfg.from_ckpt, model)
        print(f"warm-started from {cfg.from_ckpt}")

    steps_per_epoch = loader1.steps_per_epoch()
    generator = torch.Generator(device=device)
    generator.manual_seed(rank_seed(cfg.seed + 2, rank))
    state = TrainState.create(model,
                              build_optimizer(cfg, model, steps_per_epoch,
                                              dp),
                              generator)
    step = make_mae_train_step(num_masked=num_masked,
                               normalize_target=cfg.normlize_target)
    print(f"windows: {len(loader1.dataset)}  steps/epoch: {steps_per_epoch}"
          f"  masked tokens: {num_masked} of {model.cfg.num_patches}  "
          f"device: {device} (rank {rank} of {world})")

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

    jsonl = JsonlLogger(cfg.output_dir if main_rank else None)
    trainer = PretrainTrainer(step, state, device=device,
                              crop_size=cfg.input_size,
                              align=cfg.transforms_finetune_align,
                              dtype=dtype, seed=cfg.seed + 3, rank=rank)
    stop_epoch = cfg.epochs if cfg.stop_at_epoch < 0 else min(
        cfg.epochs, cfg.stop_at_epoch)
    for epoch in range(start_epoch, stop_epoch):
        t0 = time.time()
        stats = trainer.train_one_epoch(
            epoch_batches(epoch, loader1, loader2, loader3), epoch)
        print(f"[epoch {epoch}] mae loss {stats.get('loss', 0):.4f} "
              f"({time.time() - t0:.0f}s)")
        jsonl.write({"epoch": epoch, **stats})
        if cfg.output_dir:
            ckpt_utils.save_train_state(cfg.output_dir, state, epoch)
            if (epoch + 1) % cfg.save_ckpt_freq == 0:
                ckpt_utils.save_weights(cfg.output_dir,
                                        state.model.state_dict(),
                                        f"checkpoint-{epoch}")
    return state


if __name__ == "__main__":
    main()
