"""Optimizer for frame fine-tuning: AdamW with layer-wise LR decay and
per-step cosine lr/wd schedules, in PyTorch.

Port of simple_tad_tpu/train/optim.py (reference: optim_factory.py,
utils.py:430-447 and run_frame_finetuning.py:505-560).  The JAX package
applies one optax chain to the whole parameter tree; ``FinetuneOptimizer``
applies the same chain, in the same order, to the port's named
parameters:

  clip by global norm -> Adam direction -> + wd_t * p on the decayed
  parameters -> x layer scale -> x freeze mask -> x (-lr_t) -> p += update

The lr and wd schedules are indexed by the number of optimizer updates
done so far (the optax count), which advances once per update.  With
``update_freq > 1`` gradients are averaged over that many calls (the
running mean of optax.MultiSteps) and the chain runs on every
``update_freq``-th call; the calls between leave the parameters as they
are.  Masks and scales are keyed by the port's parameter names
(``blocks.<i>.attn.qkv.weight``, ...).

Of the reference's 14-name optimizer menu, ``adamw`` and ``adam`` are
ported (both are the Adam direction here; decoupled weight decay is its
own step of the chain).  The others raise (ROADMAP.md queue 1).

``FinetuneOptimizer.detach_frozen`` is the probing freeze in PyTorch's
idiom: every parameter whose freeze multiplier is 0 stops requiring a
gradient, so autograd keeps no activations for a trunk that takes no
update, and the chain skips those parameters.  Their values stay as they
are, as the JAX package's zero update leaves them; two things differ from
its mask: the frozen parameters' Adam moments stay zero (JAX fills them
from gradients that never reach a parameter), and their gradients leave
the global norm, so a caller with ``clip_grad`` keeps the mask alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# prefix-matched, as in the JAX package
NO_DECAY_PREFIXES = ("pos_embed", "cls_token", "mask_token")
EMBED_PREFIXES = ("patch_embed", "patch_kernel", "patch_bias")
PORTED_OPTIMIZERS = ("adamw", "adam")
OPTIMIZER_MENU = ("adamw", "adam", "nadam", "nadamw", "sgd", "nesterov",
                  "momentum", "radam", "novograd", "rmsprop", "rmsproptf",
                  "adadelta", "adafactor", "adabelief", "lamb", "lion")


def _parts(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


def _is_no_decay(part: str) -> bool:
    return part.startswith(NO_DECAY_PREFIXES)


def _is_embed_layer(part: str) -> bool:
    return part.startswith(EMBED_PREFIXES) or _is_no_decay(part)


def _block_index(name: str) -> Optional[int]:
    parts = _parts(name)
    return int(parts[1]) if parts[0] == "blocks" else None


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0,
                     warmup_steps: int = -1) -> np.ndarray:
    """Per-step schedule array, exactly utils.py:430-447: linspace warmup
    then cosine from base to final."""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters)
              if warmup_iters > 0 else np.array([]))
    n = epochs * niter_per_ep - warmup_iters
    it = np.arange(n)
    main = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * it / max(n, 1)))
    sched = np.concatenate([warmup, main])
    if len(sched) != epochs * niter_per_ep:
        raise ValueError(f"schedule has {len(sched)} steps, expected "
                         f"{epochs * niter_per_ep}")
    return sched


def scale_lr_by_batch(base_lr: float, total_batch_size: int) -> float:
    """Linear LR scaling rule (run_frame_finetuning.py:505)."""
    return base_lr * total_batch_size / 256.0


def array_schedule(values) -> Callable[[int], float]:
    """Step -> value lookup into a precomputed schedule (clamped at its
    last entry), in fp32 as the JAX package stores it."""
    arr = np.asarray(values, np.float32)

    def fn(step: int) -> float:
        return float(arr[min(int(step), arr.shape[0] - 1)])
    return fn


def _constant(value: float) -> Callable[[int], float]:
    value = float(np.float32(value))
    return lambda step: value


def weight_decay_mask(names: Iterable[Tuple[str, torch.Tensor]]
                      ) -> Dict[str, bool]:
    """True where decoupled weight decay applies: ndim > 1 and not in the
    no-decay list (optim_factory.py:49-56: 1-dim or bias or skip)."""
    return {name: (not any(_is_no_decay(p) for p in _parts(name))
                   and t.ndim > 1)
            for name, t in names}


def layer_scale_tree(names: Iterable[str], layer_decay: float,
                     depth: int) -> Dict[str, float]:
    """LR multipliers of get_num_layer_for_vit: block i ->
    decay^(depth - i); patch embed and position/cls/mask tables ->
    decay^(depth + 1); everything else (fc_norm, head) -> 1."""
    scales = {}
    for name in names:
        i = _block_index(name)
        if i is not None:
            scales[name] = layer_decay ** (depth - i)
        elif any(_is_embed_layer(p) for p in _parts(name)):
            scales[name] = layer_decay ** (depth + 1)
        else:
            scales[name] = 1.0
    return scales


def freeze_mask_tree(names: Iterable[str], freeze_layers: Optional[str],
                     depth: int) -> Optional[Dict[str, float]]:
    """Update multipliers of --freeze_layers (run_frame_finetuning.py:
    465-485 and the probing variant): 'first N blocks;K' freezes the
    embeddings and the first K blocks; 'probe;K;P' freezes the embeddings
    and every block but the last K, and the attention-pooling head
    ('clip_projector') unless P is 1."""
    if not freeze_layers:
        return None
    names = list(names)
    if freeze_layers.startswith("probe"):
        parts = freeze_layers.split(";")
        open_blocks = int(parts[1]) if len(parts) > 1 else 0
        open_proj = bool(int(parts[2])) if len(parts) > 2 else False

        def mult(name):
            i = _block_index(name)
            if i is not None:
                return float(i >= depth - open_blocks)
            if any(p.startswith("clip_projector") for p in _parts(name)):
                return float(open_proj)
            return 0.0 if any(_is_embed_layer(p) for p in _parts(name)) \
                else 1.0
        return {name: mult(name) for name in names}
    if not freeze_layers.startswith("first N blocks"):
        raise ValueError(f"unknown freeze spec {freeze_layers!r}")
    k = int(freeze_layers.split(";")[1])

    def mult(name):
        i = _block_index(name)
        if i is not None:
            return float(i >= k)
        return 0.0 if any(_is_embed_layer(p) for p in _parts(name)) else 1.0
    return {name: mult(name) for name in names}


def check_optimizer(opt: str) -> str:
    name = opt.lower()
    if name in PORTED_OPTIMIZERS:
        return name
    if name in OPTIMIZER_MENU:
        raise NotImplementedError(
            f"optimizer {opt!r} is not ported yet (ROADMAP.md queue 1, "
            f"frame fine-tuning: optimizer menu); ported: "
            f"{', '.join(PORTED_OPTIMIZERS)}")
    raise ValueError(f"unknown optimizer {opt!r} (optim_factory.py menu: "
                     f"{'/'.join(OPTIMIZER_MENU)})")


class FinetuneOptimizer:
    """The JAX package's create_optimizer chain on named parameters.

    ``params``: {name: parameter}, the trainable parameters (fp32
    masters).  ``lr_schedule`` / ``wd_schedule``: step -> value callables
    (``array_schedule``) or floats.  ``step()`` reads each parameter's
    ``.grad`` and returns True when it updated the parameters.
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 lr_schedule, wd_schedule=None, weight_decay: float = 0.05,
                 layer_decay: float = 1.0, depth: int = 12,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None,
                 freeze_layers: Optional[str] = None, opt: str = "adamw",
                 update_freq: int = 1):
        check_optimizer(opt)
        self.params = dict(params)
        self.lr = (lr_schedule if callable(lr_schedule)
                   else _constant(lr_schedule))
        if wd_schedule is None:
            wd_schedule = weight_decay
        self.wd = (wd_schedule if callable(wd_schedule)
                   else _constant(wd_schedule))
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.clip_grad = clip_grad
        self.update_freq = max(int(update_freq), 1)
        names = list(self.params)
        self.decay = weight_decay_mask(self.params.items())
        self.scale = (layer_scale_tree(names, layer_decay, depth)
                      if layer_decay < 1.0 else None)
        self.freeze = freeze_mask_tree(names, freeze_layers, depth)
        self.count = 0            # optimizer updates done (optax count)
        self.mini_step = 0        # calls since the last update
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.update_freq > 1 else None)
        self.detached = set()     # frozen by detach_frozen

    def detach_frozen(self) -> list:
        """``requires_grad_(False)`` on every parameter whose freeze
        multiplier is 0, which the chain then skips -> their names.  Not
        with ``clip_grad``: the JAX global norm counts their gradients."""
        if self.clip_grad:
            raise ValueError("with clip_grad the frozen parameters' "
                             "gradients enter the global norm: keep the "
                             "freeze mask alone")
        for n, m in (self.freeze or {}).items():
            if m == 0.0:
                self.params[n].requires_grad_(False)
                self.detached.add(n)
        return sorted(self.detached)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _grads(self) -> Dict[str, torch.Tensor]:
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                for n, p in self.params.items() if n not in self.detached}

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._grads()
        if self.acc is not None:
            # optax.MultiSteps: running mean of the micro-batch gradients
            for n, g in grads.items():
                a = self.acc[n]
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.update_freq - 1:
                self.mini_step += 1
                return False
            grads = {n: a.clone() for n, a in self.acc.items()
                     if n not in self.detached}
            for a in self.acc.values():
                a.zero_()
            self.mini_step = 0
        self._update(grads)
        return True

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip_grad:
            norm = global_norm(grads.values())
            for n, g in grads.items():
                grads[n] = torch.where(norm < self.clip_grad, g,
                                       g / norm * self.clip_grad)
        self.count += 1
        # fp32 bias corrections, as optax computes decay ** count
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(self.count)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(self.count)
        wd = self.wd(self.count - 1)
        neg_lr = -self.lr(self.count - 1)
        for n, g in grads.items():
            p = self.params[n]
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + self.eps)
            if self.decay[n]:
                u = u + wd * p
            if self.scale is not None:
                u = u * self.scale[n]
            if self.freeze is not None:
                u = u * self.freeze[n]
            p.add_(u * neg_lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for n, t in mine.items():
                t.copy_(state[key][n])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    a 0-dim fp32 tensor on the tensors' device."""
    sq = [t.float().pow(2).sum() for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())
