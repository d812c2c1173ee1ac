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

The direction is any name of the reference's optimizer menu
(``OPTIMIZER_MENU``), each the optax transform the JAX package's
_direction_transform picks for it, with its defaults: adam / adamw
(scale_by_adam), nadam / nadamw (the same, nesterov=True), sgd and
nesterov (trace with Nesterov momentum), momentum (trace), radam
(rectified below a threshold of 5), novograd (one second moment per
leaf), rmsprop / rmsproptf (eps outside the sqrt, then a momentum trace),
adadelta, adafactor (scale_by_factored_rms), adabelief, lamb (Adam, then
the trust ratio of each leaf) and lion (the sign of the interpolated
momentum).  Decoupled weight decay is its own step of the chain for all
of them.  A JAX "leaf" of a block parameter stacks it over the depth
axis: the per-leaf statistics (novograd's second moment, lamb's norms)
are taken over every block's tensor of that name (``leaf_key``), and
adafactor factors each parameter in the JAX package's layout
(``jax_view``: Linear kernels transposed, the patch kernel as its
(t*p*p*c, D) matrix).

Data parallelism (``data_parallel``, parallel/mesh.py): ``reduce_grads``
averages the gradients across ranks before the norm and the clip, and
with ``update_freq > 1`` the update averages the accumulated means
instead (the accumulating calls communicate nothing).  With
``zero_stage`` 1 or 2 each rank keeps the optimizer state of its share of
the leaves only, updates that share and broadcasts it; ``state_dict``
gathers the whole state, so a checkpoint reads back at any world size.

Tensor parallelism (``model_parallel``, parallel/tp.py:ModelParallel): each
model rank holds and updates its share of the block weights, whose
gradients are its own; the global norm of the clip and of the logged
grad_norm sums the squares of the cut parameters over the model group and
counts the replicated ones once (``global_norm_of``).  The data group
(``data_parallel``) averages the gradients and partitions the ZeRO state
as without it.  The elementwise directions need nothing more; novograd,
lamb and adafactor, whose statistics span a whole leaf or a factored
matrix, raise under tensor parallelism.

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

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

# prefix-matched, as in the JAX package
NO_DECAY_PREFIXES = ("pos_embed", "cls_token", "mask_token")
EMBED_PREFIXES = ("patch_embed", "patch_kernel", "patch_bias")
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
    if name in OPTIMIZER_MENU:
        return name
    raise ValueError(f"unknown optimizer {opt!r} (optim_factory.py menu: "
                     f"{'/'.join(OPTIMIZER_MENU)})")


def leaf_key(name: str) -> str:
    """The JAX leaf a parameter belongs to: its name with the block index
    replaced by '*' (the JAX package stacks the blocks on a depth axis)."""
    parts = list(_parts(name))
    for i in range(len(parts) - 1):
        if parts[i] == "blocks":
            parts[i + 1] = "*"
    return ".".join(parts)


def jax_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """The parameter (or its gradient) as the JAX package lays out the
    leaf of one block: a Linear's (out, in) weight as its (in, out) kernel,
    a Conv3d patch weight as its (t*p*p*c, D) matrix; other tensors as
    they are."""
    if t.ndim == 5 and name.endswith("patch_embed.proj.weight"):
        return t.permute(2, 3, 4, 1, 0).reshape(-1, t.shape[0])
    if t.ndim == 2 and name.endswith(".weight"):
        return t.T
    return t


def _from_jax_view(name: str, v: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
    """Inverse of ``jax_view`` for a tensor shaped like ``like``."""
    if like.ndim == 5 and name.endswith("patch_embed.proj.weight"):
        D, c, tb, p, _ = like.shape
        return v.reshape(tb, p, p, c, D).permute(4, 3, 0, 1, 2)
    if like.ndim == 2 and name.endswith(".weight"):
        return v.T
    return v


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's _factored_dims at min_dim_size_to_factor 128: the axes of
    the two largest dims (second largest, largest), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _f32(x) -> float:
    return float(np.float32(x))


# the optimizer state each direction keeps, by slot name
_SLOTS = {"adam": ("mu", "nu"), "nadam": ("mu", "nu"), "radam": ("mu", "nu"),
          "lamb": ("mu", "nu"), "adabelief": ("mu", "nu"),
          "trace": ("trace",), "novograd": ("mu", "nu"),
          "rmsprop": ("nu", "trace"), "adadelta": ("e_g", "e_x"),
          "adafactor": ("v_row", "v_col", "v"), "lion": ("mu",)}
_KIND = {"adamw": "adam", "adam": "adam", "nadam": "nadam",
         "nadamw": "nadam", "sgd": "trace", "nesterov": "trace",
         "momentum": "trace", "radam": "radam", "novograd": "novograd",
         "rmsprop": "rmsprop", "rmsproptf": "rmsprop",
         "adadelta": "adadelta", "adafactor": "adafactor",
         "adabelief": "adabelief", "lamb": "lamb", "lion": "lion"}
# directions whose statistics span a whole leaf or a factored matrix: a
# tensor-parallel rank holds a share of it
_WHOLE_LEAF_KINDS = ("novograd", "lamb", "adafactor")


class FinetuneOptimizer:
    """The JAX package's create_optimizer chain on named parameters.

    ``params``: {name: parameter}, the trainable parameters (fp32
    masters).  ``lr_schedule`` / ``wd_schedule``: step -> value callables
    (``array_schedule``) or floats.  ``step()`` reads each parameter's
    ``.grad`` and returns True when it updated the parameters.
    ``data_parallel``: a parallel.mesh.DataParallel over a process group
    (None, or one without a group: one process alone); ``zero_stage`` 1 or
    2 shards the optimizer state over its ranks.  ``model_parallel``: a
    parallel/tp.py:ModelParallel whose share of the parameters ``params``
    are (None: the whole model).
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 lr_schedule, wd_schedule=None, weight_decay: float = 0.05,
                 layer_decay: float = 1.0, depth: int = 12,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None,
                 freeze_layers: Optional[str] = None, opt: str = "adamw",
                 momentum: float = 0.9, update_freq: int = 1,
                 data_parallel=None, zero_stage: int = 0,
                 model_parallel=None):
        self.opt = check_optimizer(opt)
        self.kind = _KIND[self.opt]
        self.tp = (model_parallel if model_parallel is not None
                   and model_parallel.size > 1 else None)
        if self.tp is not None and self.kind in _WHOLE_LEAF_KINDS:
            raise ValueError(f"--opt {self.opt} is not ported under tensor "
                             f"parallelism: its statistics span a whole "
                             f"leaf (ROADMAP.md)")
        self.params = dict(params)
        self.lr = (lr_schedule if callable(lr_schedule)
                   else _constant(lr_schedule))
        if wd_schedule is None:
            wd_schedule = weight_decay
        self.wd = (wd_schedule if callable(wd_schedule)
                   else _constant(wd_schedule))
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.clip_grad = clip_grad
        self.update_freq = max(int(update_freq), 1)
        names = list(self.params)
        self.decay = weight_decay_mask(self.params.items())
        self.scale = (layer_scale_tree(names, layer_decay, depth)
                      if layer_decay < 1.0 else None)
        self.freeze = freeze_mask_tree(names, freeze_layers, depth)
        self.count = 0            # optimizer updates done (optax count)
        self.mini_step = 0        # calls since the last update
        self.leaves: Dict[str, List[str]] = {}
        for n in names:
            self.leaves.setdefault(leaf_key(n), []).append(n)
        self.dp = (data_parallel if data_parallel is not None
                   and data_parallel.active else None)
        if zero_stage not in (0, 1, 2):
            raise ValueError(f"zero_stage must be 0, 1 or 2, got "
                             f"{zero_stage}")
        self.zero_stage = zero_stage if self.dp is not None else 0
        # the leaf -> rank partition of the optimizer state (ZeRO); every
        # leaf is this rank's without it
        self.owner = (self.dp.partition(
            {k: sum(self.params[n].numel() for n in v)
             for k, v in self.leaves.items()})
            if self.zero_stage else None)
        self.owned = [n for k, v in self.leaves.items() for n in v
                      if self.owner is None or self.owner[k] ==
                      self.dp.rank]
        self.state = {slot: {n: self._init_slot(slot, n)
                             for n in self.owned}
                      for slot in _SLOTS[self.kind]}
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.update_freq > 1 else None)
        self.detached = set()     # frozen by detach_frozen
        if self.tp is not None:
            from simple_tad_tpu_torch.parallel.tp import sharded_names
            self.sharded = set(sharded_names(self.params))

    def __getattr__(self, slot):
        # the moments by their optax names (opt.mu, opt.nu, ...)
        state = self.__dict__.get("state")
        if state is not None and slot in state:
            return state[slot]
        raise AttributeError(slot)

    def _slot_shapes(self, n: str) -> Dict[str, Tuple[int, ...]]:
        """The shape of each state slot of parameter ``n``."""
        p = self.params[n]
        shape = tuple(p.shape)
        if self.kind == "novograd":
            return {"mu": shape, "nu": ()}
        if self.kind == "adafactor":
            view = tuple(jax_view(n, p).shape)
            dims = factored_dims(view)
            if dims is None:
                return {"v_row": (1,), "v_col": (1,), "v": shape}
            d1, d0 = dims
            return {"v_row": tuple(np.delete(view, d0)),
                    "v_col": tuple(np.delete(view, d1)), "v": (1,)}
        return {slot: shape for slot in _SLOTS[self.kind]}

    def _init_slot(self, slot: str, n: str) -> torch.Tensor:
        p = self.params[n]
        return torch.zeros(self._slot_shapes(n)[slot], dtype=p.dtype,
                           device=p.device)

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
    def reduce_grads(self) -> None:
        """Average each trainable parameter's ``.grad`` across the ranks
        (bucketed all-reduces), so the norm and the clip see the global
        gradient.  Nothing to do at world 1 or with ``update_freq > 1``,
        whose update averages the accumulated means instead."""
        if self.dp is None or self.acc is not None:
            return
        for n, p in self.params.items():
            if n not in self.detached and p.grad is None:
                p.grad = torch.zeros_like(p)
        self.dp.all_reduce_mean([p.grad for n, p in self.params.items()
                                 if n not in self.detached])

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
            if self.dp is not None:
                self.dp.all_reduce_mean(list(grads.values()))
            for a in self.acc.values():
                a.zero_()
            self.mini_step = 0
        self._update(grads)
        return True

    def global_norm_of(self, tensors: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        """The global norm of {name: tensor} over the whole model: under
        tensor parallelism the cut tensors' sum of squares is summed over
        the model group, the replicated ones counted once."""
        if self.tp is None:
            return global_norm(tensors.values())
        dev = next(iter(self.params.values())).device
        sq = {True: torch.zeros((), device=dev),
              False: torch.zeros((), device=dev)}
        for n, t in tensors.items():
            sq[n in self.sharded] = sq[n in self.sharded] + t.float().pow(
                2).sum()
        return torch.sqrt(self.tp.all_reduce(sq[True]) + sq[False])

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the parameters' gradients (those that have
        one): the step's logged grad_norm."""
        return self.global_norm_of({n: p.grad for n, p in self.params.items()
                                    if p.grad is not None})

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip_grad:
            norm = self.global_norm_of(grads)
            for n, g in grads.items():
                grads[n] = torch.where(norm < self.clip_grad, g,
                                       g / norm * self.clip_grad)
        self.count += 1
        wd = self.wd(self.count - 1)
        neg_lr = -self.lr(self.count - 1)
        owned = set(self.owned)
        # one JAX leaf at a time: the directions of a leaf need all of it
        # (novograd, lamb), and no more is held at once
        for names in self.leaves.values():
            group = {n: grads[n] for n in names if n in owned and n in grads}
            if not group:
                continue
            ups = self._directions(group)
            for n, u in ups.items():
                p = self.params[n]
                if self.decay[n]:
                    u = u + wd * p
                if self.scale is not None:
                    u = u * self.scale[n]
                if self.freeze is not None:
                    u = u * self.freeze[n]
                p.add_(u * neg_lr)
        if self.owner is not None:
            self._broadcast_owned(
                lambda names: [self.params[n] for n in names])

    def _directions(self, grads: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The optax direction of the gradients of one JAX leaf, updating
        the state; ``self.count`` is already the new count."""
        kind, t = self.kind, self.count
        b1, b2, eps = self.b1, self.b2, self.eps
        # fp32 bias corrections, as optax computes decay ** count
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(t))
        st = self.state
        out = {}
        if kind == "novograd":
            return self._novograd(grads)
        if kind == "adafactor":
            return {n: self._adafactor(n, g) for n, g in grads.items()}
        for n, g in grads.items():
            if kind in ("adam", "nadam", "radam", "lamb"):
                mu, nu = st["mu"][n], st["nu"][n]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                if kind == "nadam":
                    bc1n = _f32(np.float32(1) - np.float32(b1)
                                ** np.float32(t + 1))
                    m_hat = b1 * (mu / bc1n) + (1 - b1) * (g / bc1)
                    out[n] = m_hat / (torch.sqrt(nu / bc2) + eps)
                elif kind == "radam":
                    out[n] = self._radam(mu / bc1, nu / bc2)
                else:
                    out[n] = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            elif kind == "adabelief":
                mu, nu = st["mu"][n], st["nu"][n]
                mu.copy_((1 - b1) * g + b1 * mu)
                err = g - mu
                nu.copy_((1 - b2) * (err * err) + b2 * nu + 1e-16)
                out[n] = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            elif kind == "trace":
                tr = st["trace"][n]
                tr.copy_(g + self.momentum * tr)
                out[n] = (g + self.momentum * tr
                          if self.opt in ("sgd", "nesterov") else tr.clone())
            elif kind == "rmsprop":
                nu, tr = st["nu"][n], st["trace"][n]
                nu.copy_((1 - 0.9) * (g * g) + 0.9 * nu)
                tr.copy_(1 / (torch.sqrt(nu) + eps) * g + self.momentum * tr)
                out[n] = tr.clone()
            elif kind == "adadelta":
                e_g, e_x = st["e_g"][n], st["e_x"][n]
                e_g.copy_((1 - 0.9) * (g * g) + 0.9 * e_g)
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
                e_x.copy_((1 - 0.9) * (u * u) + 0.9 * e_x)
                out[n] = u
            elif kind == "lion":
                mu = st["mu"][n]
                out[n] = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.copy_((1 - b2) * g + b2 * mu)
        if kind == "lamb":
            out = self._trust_ratio(out)
        return out

    def _radam(self, mu_hat, nu_hat):
        """optax scale_by_radam's update from the corrected moments."""
        t, b2 = np.float32(self.count), np.float32(self.b2)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = b2 ** t
        ro = np.float32(ro_inf) - np.float32(2) * t * b2t / (
            np.float32(1) - b2t)
        if not ro >= 5.0:
            return mu_hat
        r = np.sqrt((ro - np.float32(4)) * (ro - np.float32(2))
                    * np.float32(ro_inf) / (np.float32(
                        (ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return _f32(r) * mu_hat / (torch.sqrt(nu_hat) + self.eps)

    def _trust_ratio(self, updates: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """optax scale_by_trust_ratio on one JAX leaf's updates: one ratio
        of the norms of the whole leaf."""
        p_norm = global_norm(self.params[n] for n in updates)
        u_norm = global_norm(updates.values())
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return {n: u * ratio for n, u in updates.items()}

    def _novograd(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """optax scale_by_novograd on one JAX leaf's gradients: one second
        moment, the squared norm of the whole leaf's gradient."""
        b1, b2, eps = self.b1, self.b2, self.eps
        group = list(grads)
        sq = global_norm(grads.values()) ** 2
        nu = self.state["nu"][group[0]]
        nu = sq if self.count == 1 else (1 - b2) * sq + b2 * nu
        out = {}
        for n in group:
            self.state["nu"][n].copy_(nu)
            mu = self.state["mu"][n]
            u = grads[n] / (torch.sqrt(nu) + eps)
            mu.copy_(u if self.count == 1 else b1 * mu + u)
            out[n] = mu.clone()
        return out

    def _adafactor(self, n: str, g: torch.Tensor) -> torch.Tensor:
        """optax scale_by_factored_rms at its defaults, on the JAX layout
        of the parameter (``jax_view``)."""
        t = np.float32(self.count - 1)          # optax's pre-update count
        decay = _f32(np.float32(1) - (t + np.float32(1))
                     ** np.float32(-0.8))
        gv = jax_view(n, g)
        dims = factored_dims(tuple(gv.shape))
        st = self.state
        if dims is None:                 # elementwise: the port's layout
            v = st["v"][n]
            v.copy_(decay * v + (1.0 - decay) * (g * g + 1e-30))
            return g * v ** -0.5
        grad_sqr = gv * gv + 1e-30
        d1, d0 = dims
        v_row, v_col = st["v_row"][n], st["v_col"][n]
        v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(dim=d0))
        v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        u = gv * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return _from_jax_view(n, u, g)

    def _broadcast_owned(self, tensors_of) -> None:
        """Each rank's leaves (``tensors_of(names)``) from that rank to
        every other."""
        for r in range(self.dp.world):
            names = [n for k, v in self.leaves.items() for n in v
                     if self.owner[k] == r]
            self.dp.broadcast(tensors_of(names), src=r)

    def state_dict(self) -> dict:
        """The whole state on every rank (a collective under ZeRO: every
        rank calls it); the accumulator is the mean over the ranks."""
        state = {slot: dict(v) for slot, v in self.state.items()}
        if self.owner is not None:
            for slot in state:
                full = {n: state[slot].get(n) for n in self.params}
                for n in self.params:
                    if full[n] is None:
                        full[n] = self._init_slot(slot, n)
                self._broadcast_owned(lambda names: [full[n] for n in names])
                state[slot] = full
        acc = self.acc
        if acc is not None and self.dp is not None:
            acc = {n: a.clone() for n, a in acc.items()}
            self.dp.all_reduce_mean(list(acc.values()))
        return {"opt": self.opt, "count": self.count,
                "mini_step": self.mini_step, "state": state, "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        """Read a ``state_dict`` written at any world size; each rank keeps
        its own share."""
        if state.get("opt", self.opt) != self.opt:
            raise ValueError(f"optimizer state of {state['opt']!r}, not "
                             f"{self.opt!r}")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        slots = state.get("state") or {k: state[k] for k in ("mu", "nu")}
        for slot, mine in self.state.items():
            for n, t in mine.items():
                t.copy_(slots[slot][n])
        if self.acc is not None and state.get("acc") is not None:
            for n, t in self.acc.items():
                t.copy_(state["acc"][n])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    a 0-dim fp32 tensor on the tensors' device."""
    sq = [t.float().pow(2).sum() for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())
