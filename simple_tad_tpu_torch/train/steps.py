"""The frame fine-tuning and MAE pre-training train steps, in PyTorch.

Port of simple_tad_tpu/train/steps.py:make_finetune_train_step (reference:
the per-step body of engine_for_frame_finetuning.py:85-200): forward in
train mode, criterion, backward, optimizer update, then the EMA of the
parameters.  Metrics are ``loss``, ``grad_norm`` (global norm of the raw
gradients, before clipping) and ``acc``, as 0-dim tensors on the device;
the logits are returned beside them.  The JAX package splits one PRNG key
per step for dropout and stochastic depth; here one ``torch.Generator`` on
the model's device (``TrainState.generator``) draws every mask.

``make_mae_train_step`` is the port of make_mae_train_step (reference:
engine_for_pretraining.py:16-150): the per-patch-normalised pixel targets
of the masked tokens from the normalised batch (models/mae.py:mae_targets,
gather first, then fp32), the PretrainVideoMAE forward, the MSE over the
masked tokens (``mae_loss``), backward and update; metrics ``loss`` and
``grad_norm``.  It takes PretrainIV2VideoMAE as it is: the targets follow
the model's patch (14) and tubelet (1), 588 values a token.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simple_tad_tpu_torch.models.mae import mae_targets
from simple_tad_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
from simple_tad_tpu_torch.train.optim import FinetuneOptimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the fp32 masters), the optimizer, the
    generator of the training masks, the count of train steps taken and the
    EMA of the parameters ({name: fp32 tensor}, or None)."""
    model: nn.Module
    optimizer: FinetuneOptimizer
    generator: torch.Generator
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model, optimizer, generator,
               ema_decay: Optional[float] = None):
        ema = ({n: p.detach().clone() for n, p in optimizer.params.items()}
               if ema_decay else None)
        return cls(model=model, optimizer=optimizer, generator=generator,
                   ema=ema)


def make_finetune_train_step(criterion: Callable, *,
                             ema_decay: Optional[float] = None):
    """-> step(state, batch) -> (metrics, logits).

    batch: {'video': (B, T, H, W, C) normalized, 'label': (B,),
    'smoothed': (B, 2), 'ttc': (B,)} on the model's device; criterion from
    train.losses.create_criterion.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        logits = model(batch["video"], generator=state.generator)
        loss = criterion(logits, batch["label"], batch.get("smoothed"),
                         batch.get("ttc"))
        loss.backward()
        with torch.no_grad():
            grad_norm = global_norm(p.grad for p in opt.params.values()
                                    if p.grad is not None)
            opt.step()
            if ema_decay is not None and state.ema is not None:
                for n, p in opt.params.items():
                    e = state.ema[n]
                    e.copy_(e * ema_decay + p * (1 - ema_decay))
            acc = (logits.argmax(-1) == batch["label"]).float().mean()
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "acc": acc}
        return metrics, logits.detach()

    return step


def mae_loss(model, batch: Dict[str, torch.Tensor], num_masked: int,
             generator: torch.Generator, *,
             normalize_target: bool = True) -> torch.Tensor:
    """The MAE loss of one batch, in train mode: the MSE of the
    PretrainVideoMAE prediction against the targets of the masked tokens.

    batch: {'video': (B, T, H, W, C) ImageNet-normalised, 'mask': (B, N)
    bool, True = masked, ``num_masked`` a row} on the model's device."""
    cfg = model.cfg
    video, mask = batch["video"], batch["mask"]
    with torch.no_grad():
        mean = torch.as_tensor(IMAGENET_MEAN, device=video.device)
        std = torch.as_tensor(IMAGENET_STD, device=video.device)
        targets = mae_targets(video, mask, num_masked,
                              patch_size=cfg.patch_size,
                              tubelet_size=cfg.tubelet_size,
                              normalize_target=normalize_target,
                              mean=mean, std=std)
    model.train()
    pred = model(video, mask, num_masked, generator=generator)
    return (pred - targets).square().mean()


def make_mae_train_step(*, num_masked: int, normalize_target: bool = True):
    """-> step(state, batch) -> metrics, for a PretrainVideoMAE state; batch
    as ``mae_loss`` takes it."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad()
        loss = mae_loss(state.model, batch, num_masked, state.generator,
                        normalize_target=normalize_target)
        loss.backward()
        with torch.no_grad():
            grad_norm = global_norm(p.grad for p in opt.params.values()
                                    if p.grad is not None)
            opt.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
