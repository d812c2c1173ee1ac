"""Knowledge-distillation train steps, in PyTorch: teacher -> student.

Port of the step makers of simple_tad_tpu/cli/distill.py (reference:
run_distill.py and engines/engine_for_pretraining.py:63-143 of the
InternVideo2 single-modality code):

* ``make_distill_step`` (``--objective logit_kd``, labeled): the frozen
  teacher's soft logits supervise the student beside the hard labels,
  loss = alpha * T^2 * KL(teacher_T || student_T) + (1 - alpha) * CE;
* ``make_feature_distill_step`` (``feature``): 2 - 2 cos between the
  l2-normalized ``features_only`` outputs, through a Linear aligner
  (``FeatureStudent``) where the widths differ;
* ``make_masked_distill_step`` (``masked_feature``, the stage-2 recipe):
  the grad-free teacher's ``return_taps`` on the whole clip, the mask
  (the loader's, or drawn from the teacher's pooling attention,
  ``attention_mask_from_importance``), the teacher's taps at the student's
  visible positions, and loss = ratio[0] * mean(2 - 2 cos(middle)) +
  ratio[1] * mean(2 - 2 cos(final)).

Each step is ``step(state, batch) -> metrics`` on a train.steps.TrainState
whose model is the student (its parameters the fp32 masters): forward in
train mode, backward, the optimizer update; the metrics are 0-dim
tensors on the device, ``grad_norm`` the global norm of the raw
gradients.  The student's stochastic-depth masks and the attention mask's
Gumbel noise come from ``state.generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from simple_tad_tpu_torch.models.internvideo2 import l2_normalize
from simple_tad_tpu_torch.models.layers import Linear, trunc_normal
from simple_tad_tpu_torch.models.mae import mask_partition
from simple_tad_tpu_torch.train.losses import cross_entropy
from simple_tad_tpu_torch.train.steps import backward_and_update


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), fp32
    (jax.random.gumbel's form), drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def attention_mask_from_importance(attn, num_masked: int, gumbel):
    """(B, N) non-negative importance and (B, N) Gumbel noise -> (B, N + 1)
    bool mask with a leading always-visible CLS slot (True = masked).

    Sampling without replacement by importance (the reference's
    ``torch.multinomial(attn, N)`` prefix, engine_for_pretraining.py:
    106-118) as Gumbel top-k: keys = log(attn) + noise; a token is masked
    where its key is below the ``num_masked``-th smallest key of its row
    (exactly ``num_masked`` with distinct keys), the JAX package's
    threshold form."""
    keys = torch.log(attn.float().clamp(min=1e-20)) + gumbel.float()
    thresh = torch.sort(keys, dim=1).values[:, num_masked:num_masked + 1]
    masked = keys < thresh
    return torch.cat([torch.zeros_like(masked[:, :1]), masked], dim=1)


def teacher_tap_indices(depth: int, clip_return_layer: int,
                        interval: float) -> Tuple[int, ...]:
    """The teacher's tap indices, ascending (internvideo2_teacher.py:
    396-404): depth - int(i * interval) - 1 for i < clip_return_layer."""
    return tuple(sorted(depth - int(i * interval) - 1
                        for i in range(clip_return_layer)))


def _cosine_loss(s, t):
    """mean(2 - 2 <s, t>) over the leading axes, in fp32."""
    return (2.0 - 2.0 * (s.float() * t).sum(-1)).mean()


def _update(state, loss) -> torch.Tensor:
    """Backward and the optimizer update -> the global gradient norm."""
    grad_norm = backward_and_update(state.optimizer, loss)
    state.step += 1
    return grad_norm


def masked_distill_loss(student, teacher, batch, *, num_masked: int,
                        teacher_taps: Sequence[int],
                        loss_ratio=(1.0, 1.0), mask_type: str = "tube",
                        generator=None):
    """The stage-2 loss of one batch -> (loss, middle loss, final loss).

    batch: {'video': (B, T, H, W, C) normalized, 'mask': (B, N) bool from
    the loader (ignored for ``mask_type`` 'attention'), optionally
    'gumbel': (B, N) the attention mask's noise (else drawn from
    ``generator``)}.  ``num_masked`` counts non-CLS tokens."""
    video = batch["video"]
    teacher.eval()
    with torch.no_grad():
        t_mid, t_fin, t_attn = teacher(video, return_taps=teacher_taps)
        if mask_type == "attention":
            noise = batch.get("gumbel")
            if noise is None:
                noise = gumbel_noise(t_attn.shape, generator, video.device)
            mask = attention_mask_from_importance(t_attn, num_masked, noise)
        else:
            m = batch["mask"]
            mask = torch.cat([torch.zeros_like(m[:, :1]), m], dim=1)
        vis_idx, _ = mask_partition(mask, num_masked)
        # the teacher's taps at the visible positions, shared by the taps
        # (engine_for_pretraining.py:119-122)
        K, _, _, C = t_mid.shape
        tgt = torch.gather(t_mid, 2, vis_idx[None, :, :, None].expand(
            K, -1, -1, C))
        del t_mid
    student.train()
    s_mid, s_fin = student(video, mask, num_masked, generator=generator)
    r_mid, r_fin = float(loss_ratio[0]), float(loss_ratio[1])
    l_mid = _cosine_loss(s_mid, tgt)
    if s_fin is not None and r_fin > 0:
        l_fin = _cosine_loss(s_fin, t_fin)
    else:
        l_fin = torch.zeros((), device=video.device)
    return r_mid * l_mid + r_fin * l_fin, l_mid, l_fin


def make_masked_distill_step(teacher, *, num_masked: int,
                             teacher_taps: Sequence[int],
                             loss_ratio=(1.0, 1.0), mask_type: str = "tube"):
    """-> step(state, batch) -> {loss, loss_clip_middle, loss_clip_final,
    grad_norm}, for a DistillInternVideo2 state; batch as
    ``masked_distill_loss`` takes it."""
    taps = tuple(teacher_taps)

    def step(state, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        loss, l_mid, l_fin = masked_distill_loss(
            state.model, teacher, batch, num_masked=num_masked,
            teacher_taps=taps, loss_ratio=loss_ratio, mask_type=mask_type,
            generator=state.generator)
        grad_norm = _update(state, loss)
        return {"loss": loss.detach(), "loss_clip_middle": l_mid.detach(),
                "loss_clip_final": l_fin.detach(), "grad_norm": grad_norm}

    return step


class FeatureStudent(nn.Module):
    """The feature objective's trainable parameters when the student's
    feature width differs from the teacher's: the student and a Linear
    ``aligner`` (fp32, lecun-normal kernel, zero bias: flax Dense's
    initialisers), the JAX CLI's {'student', 'aligner'} tree."""

    def __init__(self, student, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.student = student
        device = next(student.parameters()).device
        self.aligner = Linear(in_dim, out_dim, dtype=torch.float32,
                              device=device)
        self.aligner.requires_grad_(True)
        if generator is not None:
            with torch.no_grad():
                self.aligner.weight.copy_(
                    trunc_normal((out_dim, in_dim), 1.0 / math.sqrt(in_dim),
                                 generator) / 0.87962566103423978)
                self.aligner.bias.zero_()

    def forward(self, video, generator=None):
        feats = self.student(video, features_only=True, generator=generator)
        return self.aligner(feats.float())


def feature_distill_loss(model, teacher, batch, generator=None):
    """mean(2 - 2 cos) between the l2-normalized features of the student
    (``model``: the student, or a FeatureStudent) in train mode and of
    the grad-free teacher (engine_for_pretraining.py:131-143)."""
    video = batch["video"]
    teacher.eval()
    with torch.no_grad():
        t_feat = l2_normalize(teacher(video, features_only=True))
    model.train()
    if isinstance(model, FeatureStudent):
        s_feat = model(video, generator=generator)
    else:
        s_feat = model(video, features_only=True, generator=generator)
    return _cosine_loss(l2_normalize(s_feat), t_feat)


def make_feature_distill_step(teacher):
    """-> step(state, batch) -> {loss, grad_norm}; batch {'video'}."""

    def step(state, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        loss = feature_distill_loss(state.model, teacher, batch,
                                    state.generator)
        grad_norm = _update(state, loss)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_distill_step(teacher, *, alpha: float = 0.5,
                      temperature: float = 2.0):
    """-> step(state, batch) -> {loss, kd, ce, grad_norm}: labeled logit
    distillation; batch {'video', 'label'}."""
    T = float(temperature)

    def step(state, batch: Dict[str, torch.Tensor]):
        video = batch["video"]
        teacher.eval()
        with torch.no_grad():
            t_soft = torch.softmax(teacher(video).float() / T, dim=-1)
        model = state.model
        state.optimizer.zero_grad()
        model.train()
        s_logits = model(video, generator=state.generator).float()
        s_log = torch.log_softmax(s_logits / T, dim=-1)
        kd = -(t_soft * s_log).sum(-1).mean() * T * T
        ce = cross_entropy(s_logits, batch["label"])
        loss = alpha * kd + (1 - alpha) * ce
        grad_norm = _update(state, loss)
        return {"loss": loss.detach(), "kd": kd.detach(), "ce": ce.detach(),
                "grad_norm": grad_norm}

    return step
