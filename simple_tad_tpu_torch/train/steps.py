"""The frame fine-tuning train step, in PyTorch.

Port of simple_tad_tpu/train/steps.py:make_finetune_train_step (reference:
the per-step body of engine_for_frame_finetuning.py:85-200): forward in
train mode, criterion, backward, optimizer update, then the EMA of the
parameters.  Metrics are ``loss``, ``grad_norm`` (global norm of the raw
gradients, before clipping) and ``acc``, as 0-dim tensors on the device;
the logits are returned beside them.  The JAX package splits one PRNG key
per step for dropout and stochastic depth; here one ``torch.Generator`` on
the model's device (``TrainState.generator``) draws every mask.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

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
