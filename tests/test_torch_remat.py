"""Gradient checkpointing (``remat``, models/layers.py:checkpoint_block) in
the port's five training models: the ViT, InternVideo2, PretrainVideoMAE,
PretrainIV2VideoMAE and the distillation student, at tiny sizes.

* Against the JAX model with ``remat=True`` (its nn.remat of the block
  scans under remat_policy) on its plain attention (attn_impl 'xla', as
  the JAX package's own remat test runs it on the CPU: interpret-mode
  Pallas calls are host callbacks, which jax.checkpoint does not take),
  the same weights and inputs, no random draws:
  loss within 1e-5 relative, every gradient leaf within 1e-4 of its
  largest magnitude (the step tolerances of the port's train-step tests).
* Against the port's own model without remat, with drop path 0.1 and, in
  the ViT, attention dropout 0.1 in both keep forms: the loss, every
  gradient and the generator's state after the step are bit-equal, and
  the recompute runs no forward attention (the plain versions of the
  training forwards are called as often as without remat).
* The control, a recompute that redraws its masks, changes the gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import simple_tad_tpu.models.mae as jax_mae
from simple_tad_tpu.models.internvideo2 import IV2Config as JaxIV2Config
from simple_tad_tpu.models.iv2_distill import \
    DistillInternVideo2 as JaxDistill
from simple_tad_tpu.models.iv2_distill import \
    DistillIV2Config as JaxDistillConfig
from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.models.internvideo2 import InternVideo2 as JaxIV2
from simple_tad_tpu.ops.image import IMAGENET_MEAN, IMAGENET_STD
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu_torch.models import layers
from simple_tad_tpu_torch.models import mae
from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.models.iv2_distill import (DistillInternVideo2,
                                                     DistillIV2Config)
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train.steps import mae_loss
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests import test_torch_distill as td
from tests import test_torch_iv2_mae as tim
from tests import test_torch_iv2_train as tiv
from tests import test_torch_mae as tm
from tests import test_torch_train_step as tts
from tests.test_torch_vit import one_torch_thread  # noqa: F401

KINDS = ["vit", "iv2", "mae", "iv2_mae", "distill"]
ATTN_FORWARDS = ("flash_attention_qkv_fwd_lse", "flash_attention_fwd_lse",
                 "flash_attention_drop_fwd")


@functools.lru_cache(maxsize=None)
def _jax_params(kind):
    """The JAX weights of ``kind`` (numpy leaves; cached, read only)."""
    if kind == "vit":
        return tts._params()
    if kind == "iv2":
        return tiv._params()
    if kind == "mae":
        return tm._jax_params(dict(tm.TINY, init_values=0.1), seed=1)
    if kind == "iv2_mae":
        return tim._jax_params(tim.TINY, seed=1)
    return td._student_params()


def _port_model(kind, params, **cfg):
    f32 = torch.float32
    if kind == "vit":
        model = VisionTransformer(ViTConfig(**{**tts.TINY, "param_dtype": f32,
                                               **cfg}), device="cpu")
    elif kind == "iv2":
        model = InternVideo2(IV2Config(**{**tiv.TINY, "drop_path_rate": 0.0,
                                          "param_dtype": f32, **cfg}),
                             device="cpu")
    elif kind == "mae":
        model = mae.PretrainVideoMAE(mae.MAEConfig(**{
            **tm.TINY, "init_values": 0.1, "param_dtype": f32, **cfg}),
            device="cpu")
    elif kind == "iv2_mae":
        model = mae.PretrainIV2VideoMAE(mae.IV2MAEConfig(**{
            **tim.TINY, "param_dtype": f32, **cfg}), device="cpu")
    else:
        model = DistillInternVideo2(DistillIV2Config(**{
            **td.STUDENT, "param_dtype": f32, **cfg}), device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model.train()


def _batch(kind):
    rng = np.random.default_rng(3)
    if kind in ("vit", "iv2"):
        shape = (4, 4, 32, 32, 3) if kind == "vit" else (4, 2, 28, 28, 3)
        return {"video": rng.standard_normal(shape).astype(np.float32),
                "label": np.array([1, 0, 1, 1], np.int32)}
    if kind in ("mae", "iv2_mae"):
        t = tm if kind == "mae" else tim
        mask, nm = t._masks(7)
        frames, size = (4, 32) if kind == "mae" else (2, 28)
        return {"video": rng.standard_normal(
            (t.B, frames, size, size, 3)).astype(np.float32),
            "mask": mask, "num_masked": nm}
    mask = np.zeros((td.B, td.N_PATCH + 1), bool)
    for b in range(td.B):
        mask[b, 1 + rng.permutation(td.N_PATCH)[:td.NUM_MASKED]] = True
    return {"video": rng.standard_normal((td.B, 2, 28, 28, 3)).astype(
        np.float32), "mask": mask, "num_masked": td.NUM_MASKED}


def _port_loss(kind, model, batch, generator):
    x = torch.from_numpy(batch["video"])
    if kind in ("vit", "iv2"):
        logits = model(x, generator=generator)
        return L.create_criterion("crossentropy")(
            logits, torch.from_numpy(batch["label"]).long(), None, None)
    mask = torch.from_numpy(batch["mask"])
    if kind in ("mae", "iv2_mae"):
        return mae_loss(model, {"video": x, "mask": mask},
                        batch["num_masked"], generator)
    aligned, final = model(x, mask, batch["num_masked"], generator=generator)
    # the outputs are l2-normalized: score them against fixed directions
    return ((aligned * torch.from_numpy(_target(aligned.shape))).sum()
            + (final * torch.from_numpy(_target(final.shape))).sum())


def _target(shape):
    return np.random.default_rng(5).standard_normal(shape).astype(np.float32)


def _jax_loss_and_grads(kind, params, batch):
    x = jnp.asarray(batch["video"])
    rngs = {"dropout": jax.random.PRNGKey(2),
            "droppath": jax.random.PRNGKey(3)}
    if kind in ("vit", "iv2"):
        jm = (JaxViT(JaxViTConfig(**tts.TINY, attn_impl="xla", remat=True))
              if kind == "vit" else
              JaxIV2(JaxIV2Config(**{**tiv.TINY, "drop_path_rate": 0.0,
                                     "attn_impl": "xla", "remat": True})))

        def loss(p):
            logits = jm.apply({"params": p}, x, deterministic=False,
                              rngs=rngs)
            return JL.cross_entropy(logits, jnp.asarray(batch["label"]))
    elif kind in ("mae", "iv2_mae"):
        nm, mask = batch["num_masked"], jnp.asarray(batch["mask"])
        jm = (jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(
            **tm.TINY, init_values=0.1, attn_impl="xla", remat=True))
            if kind == "mae"
            else tim._jax_model(tim.TINY, attn_impl="xla", remat=True))
        cfg = jm.cfg
        targets = jax_mae.mae_targets_fused(
            x, mask, nm, mean=jnp.asarray(IMAGENET_MEAN),
            std=jnp.asarray(IMAGENET_STD), patch_size=cfg.patch_size,
            tubelet_size=cfg.tubelet_size)

        def loss(p):
            pred = jm.apply({"params": p}, x, mask, nm, deterministic=False,
                            rngs=rngs)
            return jnp.mean(jnp.square(pred - targets))
    else:
        jm = JaxDistill(JaxDistillConfig(**{**td.STUDENT, "attn_impl": "xla",
                                            "remat": True}))

        def loss(p):
            aligned, final = jm.apply(
                {"params": p}, x, jnp.asarray(batch["mask"]),
                batch["num_masked"], deterministic=False, rngs=rngs)
            return (jnp.sum(aligned * _target(aligned.shape))
                    + jnp.sum(final * _target(final.shape)))
    return jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize("kind", KINDS)
def test_remat_matches_jax_remat(kind):
    params = _jax_params(kind)
    batch = _batch(kind)
    want_loss, want_grads = _jax_loss_and_grads(kind, params, batch)
    model = _port_model(kind, params, remat=True)
    loss = _port_loss(kind, model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _grads_close(tc.to_jax_params({n: p.grad for n, p in
                                   model.named_parameters()}),
                 want_grads, 1e-4, f"{kind} grad")


def _grads_close(got_tree, want_tree, rel, what):
    """Each gradient leaf within ``rel`` of its own largest magnitude, as
    the step tests hold them; a leaf whose gradient is zero in exact
    arithmetic (its largest magnitude under 1e-6 of the tree's: the
    pooling head's key bias, the last block's qk-norm scales under the
    student's loss) holds rounding noise only and is held to ``rel`` of
    the tree's largest magnitude."""
    tree_max = max(float(np.abs(np.asarray(a)).max())
                   for a in jax.tree_util.tree_leaves(want_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(got) == len(want), what
    for path, g in got:
        w = np.asarray(want[path], np.float32)
        scale = float(np.abs(w).max())
        if scale < 1e-6 * tree_max:
            scale = tree_max
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=rel * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _step(kind, params, batch, monkeypatch, **cfg):
    """One forward and backward -> (loss, {name: grad}, generator state,
    the training attention forwards run)."""
    calls = []

    def counted(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run
    with monkeypatch.context() as m:
        for name in ATTN_FORWARDS:
            m.setattr(fa, name, counted(name, getattr(fa, name)))
        model = _port_model(kind, params, **cfg)
        gen = torch.Generator().manual_seed(11)
        loss = _port_loss(kind, model, batch, gen)
        loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            gen.get_state(), calls)


DRAWS = [("vit", {"drop_path_rate": 0.1}),
         ("vit", {"drop_path_rate": 0.1, "attn_drop_rate": 0.1,
                  "attn_dropout_form": "rng"}),
         ("vit", {"drop_path_rate": 0.1, "attn_drop_rate": 0.1,
                  "attn_dropout_form": "mask"}),
         ("iv2", {"drop_path_rate": 0.1}),
         ("mae", {"drop_path_rate": 0.1}),
         ("iv2_mae", {"drop_path_rate": 0.1}),
         ("distill", {"drop_path_rate": 0.1})]


@pytest.mark.parametrize("kind,cfg", DRAWS,
                         ids=["vit", "vit-attn-rng", "vit-attn-mask", "iv2",
                              "mae", "iv2_mae", "distill"])
def test_remat_is_bit_equal_to_the_plain_step(kind, cfg, monkeypatch):
    params = _jax_params(kind)
    batch = _batch(kind)
    loss, grads, state, calls = _step(kind, params, batch, monkeypatch,
                                      **cfg)
    rloss, rgrads, rstate, rcalls = _step(kind, params, batch, monkeypatch,
                                          remat=True, **cfg)
    assert calls and rcalls == calls
    assert torch.equal(rloss, loss)
    for n, g in grads.items():
        assert torch.equal(rgrads[n], g), n
    assert torch.equal(rstate, state)
    # the control: a recompute that redraws its masks
    monkeypatch.setattr(layers, "checkpoint_block",
                        lambda block, x, generator=None: _CHECKPOINT(
                            block, x, generator, replay_draws=False))
    _, cgrads, cstate, _ = _step(kind, params, batch, monkeypatch,
                                 remat=True, **cfg)
    assert not all(torch.equal(cgrads[n], g) for n, g in grads.items())
    assert not torch.equal(cstate, state)


_CHECKPOINT = layers.checkpoint_block
