"""The port's frame fine-tuning step (simple_tad_tpu_torch.train) against
the JAX package's make_finetune_train_step on a tiny fp32 ViT (depth 2,
dim 128, 2 heads, 4 frames at 32x32: 8 tokens), both starting from the
same weights (from_jax_params), the JAX side through its Pallas kernels in
interpret mode (packed training attention, fused LayerNorm).  AdamW with
layer decay 0.75, weight decay 0.05, clip 1.0 and a cosine lr schedule.

Tolerances (relative to each leaf's largest magnitude): loss 1e-5, every
gradient leaf 1e-4, parameters and Adam moments after one and two steps
1e-5, EMA 1e-5.  The lr is the fine-tuning job's base lr (5e-4): Adam's
first steps divide each gradient by its own magnitude, so elements whose
gradient is near eps (1e-8) carry the gradient's summation-order error
into the update at about 1e-3 of lr.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_finetune_train_step as jax_step
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import (TrainState,
                                              make_finetune_train_step)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import one_torch_thread  # noqa: F401

TINY = dict(img_size=32, all_frames=4, patch_size=16, tubelet_size=2,
            embed_dim=128, depth=2, num_heads=2, num_classes=2,
            init_scale=1.0, init_values=0.1)
B = 4
LR = dict(base=5e-4, final=1e-5, steps=4)   # the job's base lr


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("SIMPLE_TAD_FORCE_PACKED_ATTN", "1")
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LN", "force")
    with pltpu.force_tpu_interpret_mode():
        yield


def _params(seed=0):
    params = JaxViT(JaxViTConfig(**TINY)).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _batches(n):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 2, B)
        video = rng.standard_normal((B, 4, 32, 32, 3)).astype(np.float32)
        video += labels[:, None, None, None, None] * 0.5
        out.append({"video": video, "label": labels.astype(np.int32),
                    "smoothed": np.zeros((B, 2), np.float32),
                    "ttc": np.zeros(B, np.float32)})
    return out


def _schedules():
    lr = JO.cosine_scheduler(LR["base"], LR["final"], 1, LR["steps"])
    wd = JO.cosine_scheduler(0.05, 0.05, 1, LR["steps"])
    return lr, wd


def _jax_side(params, ema_decay, update_freq):
    lr, wd = _schedules()
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd),
                             weight_decay=0.05, layer_decay=0.75, depth=2,
                             clip_grad=1.0)
    if update_freq > 1:
        tx = optax.MultiSteps(tx, update_freq)
    model = JaxViT(JaxViTConfig(**TINY))
    step = jax_step(model, tx, JL.create_criterion("crossentropy"),
                    ema_decay=ema_decay, donate=False)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                 tx, jax.random.PRNGKey(1),
                                 ema_decay=ema_decay)
    return model, step, state


def _port_side(params, ema_decay, update_freq):
    model = VisionTransformer(ViTConfig(**TINY, param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(tc.from_jax_params(params))
    lr, wd = _schedules()
    opt = O.FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=O.array_schedule(lr),
        wd_schedule=O.array_schedule(wd), weight_decay=0.05,
        layer_decay=0.75, depth=2, clip_grad=1.0, update_freq=update_freq)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0),
                              ema_decay=ema_decay)
    return make_finetune_train_step(L.create_criterion("crossentropy"),
                                    ema_decay=ema_decay), state


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if k == "label"
            else torch.from_numpy(v) for k, v in b.items()}


def _tree_close(got_tree, want_tree, rel, what):
    flat_got = jax.tree_util.tree_leaves_with_path(got_tree)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert len(flat_got) == len(flat_want), what
    for path, got in flat_got:
        want = np.asarray(flat_want[path], np.float32)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=0, atol=rel * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _adam_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState in an optax chain state."""
    if hasattr(opt_state, "inner_opt_state"):
        opt_state = opt_state.inner_opt_state
    for s in opt_state:
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def test_gradients_and_loss_match_jax(pallas):
    params = _params()
    batch = _batches(1)[0]
    model = JaxViT(JaxViTConfig(**TINY))

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["video"]),
                             deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(2),
                                   "droppath": jax.random.PRNGKey(3)})
        return JL.cross_entropy(logits, jnp.asarray(batch["label"]))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params))
    step, state = _port_side(params, None, 1)
    metrics, _ = step(state, _torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    _tree_close(tc.to_jax_params(grads), want_grads, 1e-4, "grad")
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(want_grads)),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["adamw", "update_freq2", "ema"])
def test_train_steps_match_jax(case, pallas):
    ema_decay = 0.9 if case == "ema" else None
    update_freq = 2 if case == "update_freq2" else 1
    params = _params()
    batches = _batches(2)
    _, jstep, jstate = _jax_side(params, ema_decay, update_freq)
    step, state = _port_side(params, ema_decay, update_freq)
    for i, b in enumerate(batches):
        jstate, (jm, _) = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                               b))
        m, logits = step(state, _torch_batch(b))
        assert logits.shape == (B, 2)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]))
        _tree_close(tc.to_jax_params(state.model.state_dict()),
                    jstate.params, 1e-5, f"params after step {i + 1}")
    assert state.step == 2 and state.optimizer.count == 2 // update_freq
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")
    if ema_decay:
        _tree_close(tc.to_jax_params(state.ema), jstate.ema_params, 1e-5,
                    "ema")
    if update_freq == 2:
        # one update only, on the mean of the two micro-batch gradients
        assert int(jstate.opt_state.gradient_step) == 1
