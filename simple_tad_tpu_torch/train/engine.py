"""Epoch-level training engine for frame fine-tuning, in PyTorch.

Port of simple_tad_tpu/train/engine.py (reference: train_one_epoch /
validation_one_epoch, engine_for_frame_finetuning.py:44-382, and the epoch
loop of run_frame_finetuning.py:620-747).  Host threads decode raw windows
(uint8, scaled resolution) while the device runs the previous step; all
augmentation runs on the device (ops/augment.py:train_augment).

``TrainLoader`` is a copy of the JAX package's (that module imports jax at
the top); tests/test_torch_host_copies.py holds it to the original.  Its
decode threads hand the batches over in the epoch's order
(data/prefetch.py), where the original's come in the order the threads
finish, and at world > 1 it decodes this rank's rows only.
``FinetuneTrainer`` owns the train state on one device; ``validate``
scores the validation split through the port's FrameEvaluator.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from simple_tad_tpu_torch.data.frame_datasets import FrameDataset
from simple_tad_tpu_torch.data.prefetch import ordered_batches
from simple_tad_tpu_torch.eval.metrics import binary_metrics
from simple_tad_tpu_torch.ops.augment import train_augment
from simple_tad_tpu_torch.parallel.mesh import rank_rows, rank_seed
from simple_tad_tpu_torch.utils.logging import MetricLogger


class TrainLoader:
    """Threaded window decoder -> fixed-shape uint8 batches.

    Yields dicts {video_u8 (B,T,H,W,C), label, smoothed, ttc}.  Short final
    batches are dropped (the reference's DataLoader uses drop_last=True for
    training).  ``nb_samples_per_epoch`` caps an epoch like
    ShortDistributedSampler (utils.py:1154-1181).  With ``world`` > 1,
    ``batch_size`` is the global batch and each batch holds, and decodes,
    only this ``rank``'s rows of it (parallel/mesh.py:rank_rows).
    """

    def __init__(self, dataset: FrameDataset, batch_size: int, *,
                 seed: int = 0, nb_samples_per_epoch: int = 0,
                 num_threads: int = 4, prefetch: int = 4,
                 resize_scale: float = 1.0, num_sample: int = 1,
                 balanced_ratio: Optional[float] = None, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.rows = rank_rows(batch_size, rank, world)
        self.batch_size = batch_size
        self.seed = seed
        self.cap = nb_samples_per_epoch
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.resize_scale = resize_scale
        # repeated augmentation: each window decoded once, duplicated
        # num_sample times in the batch; the device augmentation pipeline
        # draws independent parameters per copy (multiple_samples_collate,
        # utils.py:596-621 — effective batch = batch_size * num_sample)
        self.num_sample = max(int(num_sample), 1)
        # pos:neg batch composition (BalancedDistributedBatchSampler,
        # utils.py:1184-1264; off by default like the reference)
        self.balanced_ratio = balanced_ratio

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.cap:
            n = min(n, self.cap)
        return n // self.batch_size

    def _epoch_order(self, rng) -> np.ndarray:
        if self.balanced_ratio is None:
            order = rng.permutation(len(self.dataset))
            if self.cap:
                order = order[:self.cap]
            return order
        labels = self.dataset.labels
        pos = np.flatnonzero(labels == 1)
        neg = np.flatnonzero(labels == 0)
        if len(pos) == 0 or len(neg) == 0:
            # degenerate split: fall back to plain shuffling
            order = rng.permutation(len(self.dataset))
            return order[:self.cap] if self.cap else order
        n = min(len(self.dataset), self.cap) if self.cap \
            else len(self.dataset)
        n_batches = n // self.batch_size
        k_pos = max(int(round(self.batch_size * self.balanced_ratio)), 1)
        rows = []
        for _ in range(n_batches):
            p = rng.choice(pos, k_pos, replace=len(pos) < k_pos)
            q = rng.choice(neg, self.batch_size - k_pos,
                           replace=len(neg) < self.batch_size - k_pos)
            row = np.concatenate([p, q])
            rng.shuffle(row)
            rows.append(row)
        return np.concatenate(rows) if rows else np.array([], np.int64)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = self._epoch_order(rng)
        n_batches = len(order) // self.batch_size
        order = order[:n_batches * self.batch_size]
        batches = order.reshape(n_batches, self.batch_size)

        def decode_with_retry(i):
            # bad samples get a random substitute instead of failing
            # (dota.py:231-237)
            for _ in range(5):
                try:
                    return self.dataset.get_window_frames(
                        int(i), final_resize=False,
                        resize_scale=self.resize_scale)
                except Exception:
                    import warnings
                    warnings.warn(f"window {i} failed to load; substituting")
                    i = rng.integers(len(self.dataset))
            raise IOError("too many corrupt samples")

        def make_batch(idx_row):
            frames, labels, smoothed, ttc = [], [], [], []
            for i in idx_row[self.rows]:
                f, s = decode_with_retry(i)
                # repeated augmentation: decode once, duplicate; device augs
                # draw independent params per copy
                for _ in range(self.num_sample):
                    frames.append(f)
                    labels.append(s.label)
                    smoothed.append(s.smoothed)
                    ttc.append(s.ttc)
            return {
                "video_u8": np.stack(frames),
                "label": np.asarray(labels, np.int32),
                "smoothed": np.stack(smoothed).astype(np.float32),
                "ttc": np.asarray(ttc, np.float32),
            }

        yield from ordered_batches(batches, make_batch, self.num_threads,
                                   self.prefetch)


class FinetuneTrainer:
    """Owns the train step, the train state and the epoch loop on one
    device (one rank of a data-parallel run).  Augmentation masks come
    from a generator on the device seeded from ``seed``, the epoch and
    ``rank``.  ``grad_norms``: a utils/diagnostics.py:GradNormAccumulator
    fed each step's ``metrics['grad_norms']``."""

    def __init__(self, train_step, state, *, device, crop_size: int = 224,
                 aug_magnitude: float = 6.0, aug_layers: int = 3,
                 reprob: float = 0.25, dtype=torch.bfloat16,
                 log_writer=None, seed: int = 0, rank: int = 0,
                 grad_norms=None):
        self.train_step = train_step
        self.state = state
        self.device = torch.device(device)
        self.crop_size = crop_size
        self.aug_magnitude = aug_magnitude
        self.aug_layers = aug_layers
        self.reprob = reprob
        self.dtype = dtype
        self.log_writer = log_writer
        self.seed = seed
        self.rank = rank
        self.grad_norms = grad_norms

    def _put(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def device_batch(self, batch, generator) -> Dict[str, torch.Tensor]:
        """Upload one loader batch and augment it on the device."""
        video = train_augment(
            self._put(batch["video_u8"]), generator,
            crop_size=self.crop_size, magnitude=self.aug_magnitude,
            num_layers=self.aug_layers, reprob=self.reprob, dtype=self.dtype)
        return {"video": video,
                "label": self._put(batch["label"]).long(),
                "smoothed": self._put(batch["smoothed"]),
                "ttc": self._put(batch["ttc"])}

    def train_one_epoch(self, loader: TrainLoader, epoch: int,
                        print_freq: int = 10) -> Dict[str, float]:
        ml = MetricLogger(print_freq=print_freq)
        aug = torch.Generator(device=self.device)
        aug.manual_seed(rank_seed(self.seed * 1_000_003 + epoch, self.rank))
        all_logits, all_labels = [], []
        for batch in ml.log_every(loader.epoch(epoch),
                                  header=f"Epoch [{epoch}]"):
            metrics, logits = self.train_step(
                self.state, self.device_batch(batch, aug))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                # NaN hard exit (engine_for_frame_finetuning.py:148-150)
                raise FloatingPointError(f"loss is {loss}, stopping")
            acc = float(metrics["acc"])
            ml.update(loss=loss, grad_norm=float(metrics["grad_norm"]),
                      acc=acc)
            if self.grad_norms is not None and "grad_norms" in metrics:
                self.grad_norms.update(metrics["grad_norms"])
            all_logits.append(logits.float().cpu())
            all_labels.append(batch["label"])
            if self.log_writer is not None:
                self.log_writer.set_step()
                self.log_writer.update(head="train", loss=loss, acc=acc)
        stats = ml.epoch_stats()
        if all_logits:
            probs = torch.softmax(torch.cat(all_logits), -1)[:, 1].numpy()
            m = binary_metrics(probs, np.concatenate(all_labels))
            stats.update(auroc=m.auroc, ap=m.ap, mcc_auc=m.mcc_auc)
        return stats


def validate(evaluator, dataset: FrameDataset, evaluate=None
             ) -> Dict[str, float]:
    """validation_one_epoch equivalent: returns the metric dict keyed the
    way BestTracker expects (auroc/ap/acc/mccauc).  ``evaluate``: the call
    that scores (default ``evaluator.evaluate(dataset)``)."""
    res = evaluate() if evaluate is not None else evaluator.evaluate(dataset)
    m = res.metrics
    return {"auroc": m.auroc, "ap": m.ap, "acc": m.acc,
            "mccauc": m.mcc_auc, "mcc_05": m.mcc_05, "f1": m.f1,
            "windows_per_sec": res.windows_per_sec}
