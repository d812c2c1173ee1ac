"""Training criteria for frame-level anomaly classification, in PyTorch.

Port of simple_tad_tpu/train/losses.py (reference: utils.py:638-1118 and
the selection table in run_frame_finetuning.py:570-589): batch logits
(N, 2) -> scalar, computed in fp32.

Named criteria (reference flag --loss):
  crossentropy | focal | focal6x100 | focal2_6 | focal2_2 | 2bce |
  smoothap | exponential1
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Mean softmax CE over int labels (N,) or soft targets (N, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.ndim == logits.ndim:
        target = labels.float()
    else:
        target = F.one_hot(labels.long(), logits.shape[-1]).float()
        if label_smoothing > 0:
            c = logits.shape[-1]
            target = target * (1 - label_smoothing) + label_smoothing / c
    return -(target * logp).sum(dim=-1).mean()


def _ce_per_sample(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def focal_loss(logits, labels, *, alpha: float = 0.75, gamma: float = 2.0,
               multiplier: float = 1.0):
    """FocalLoss (utils.py:638-657): m * a * (1-pt)^g * ce."""
    ce = _ce_per_sample(logits, labels)
    pt = torch.exp(-ce)
    return (multiplier * alpha * (1 - pt) ** gamma * ce).mean()


def focal_loss2(logits, labels, *, alpha=(0.40, 0.60), gamma: float = 2.0,
                multiplier: float = 1.0):
    """FocalLoss2 (utils.py:659-682): per-class alpha inside the ce term."""
    ce = _ce_per_sample(logits, labels)
    pt = torch.exp(-ce)
    at = torch.tensor(alpha, dtype=torch.float32,
                      device=logits.device)[labels.long()]
    return ((1 - pt) ** gamma * (at * ce) * multiplier).mean()


def double_bce(logits, smoothed_labels):
    """'2bce' (utils.py:1091-1118): independent BCE per output neuron on
    sigmoid-smoothed 2-channel targets; sum channels, mean batch."""
    logits = logits.float()
    targets = smoothed_labels.float()
    per = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return per.sum(dim=-1).mean()


def smooth_ap(logits, labels, *, delta: float = 0.01):
    """SmoothAPLoss (utils.py:685-708): sum of hinge rank violations of
    every (positive, negative) pair, averaged over positives."""
    probs = torch.softmax(logits.float(), dim=-1)[:, 1]
    pos = (labels == 1).float()
    neg = (labels == 0).float()
    diff = torch.relu(probs[None, :] - probs[:, None] + delta)
    pair = diff * pos[:, None] * neg[None, :]
    return pair.sum() / torch.clamp(pos.sum(), min=1)


def temporal_exponential(logits, labels, ttc, *, alpha_pre: float = 0.1,
                         alpha_post: float = 0.5):
    """TemporalExponentialLoss (utils.py:711-734): CE weighted by
    exp(alpha_pre * t) before / exp(-alpha_post * t) after, clamped to 1."""
    ce = _ce_per_sample(logits, labels)
    t = ttc.float()
    one = torch.ones_like(t)
    w = torch.where(t < 0, torch.exp(alpha_pre * t),
                    torch.where(t > 0, torch.exp(-alpha_post * t), one))
    return (ce * torch.minimum(w, one)).mean()


def create_criterion(name: str, label_smoothing: float = 0.0) -> Callable:
    """Returns loss_fn(logits, labels, smoothed_labels, ttc) -> scalar,
    wiring the same hyperparameters as run_frame_finetuning.py:570-589."""
    if name == "crossentropy":
        if label_smoothing > 0:
            return lambda lg, lb, sm, ttc: cross_entropy(
                lg, lb, label_smoothing)
        return lambda lg, lb, sm, ttc: cross_entropy(lg, lb)
    if name == "focal":
        return lambda lg, lb, sm, ttc: focal_loss(lg, lb, alpha=0.75, gamma=2)
    if name == "focal6x100":
        return lambda lg, lb, sm, ttc: focal_loss(lg, lb, alpha=0.75,
                                                  gamma=6, multiplier=100)
    if name == "focal2_6":
        return lambda lg, lb, sm, ttc: focal_loss2(lg, lb, gamma=6,
                                                   multiplier=50)
    if name == "focal2_2":
        return lambda lg, lb, sm, ttc: focal_loss2(lg, lb, gamma=2,
                                                   multiplier=10)
    if name == "2bce":
        return lambda lg, lb, sm, ttc: double_bce(lg, sm)
    if name == "smoothap":
        return lambda lg, lb, sm, ttc: smooth_ap(lg, lb)
    if name == "exponential1":
        return lambda lg, lb, sm, ttc: temporal_exponential(lg, lb, ttc)
    raise NotImplementedError(f"loss not implemented: {name}")
