"""ViT fine-tuning with attention dropout in the port (ViTConfig
attn_drop_rate with attn_dropout_form 'mask' or 'rng', the train step, the
finetune CLI's --attn_drop_rate) against the JAX package, on a tiny fp32
ViT (depth 2, dim 128, 2 heads of 64, 4 frames at 64x64: 32 tokens),
attention dropout 0.3, both starting from the same weights
(from_jax_params), the JAX side through its Pallas kernels in interpret
mode (attn_impl 'pallas': the mask kernels under _flash_core_drop).

The two frameworks' random bits cannot match, so the JAX side is given the
port's keep masks in call order (its make_dropout_mask monkeypatched, as
tests/test_torch_iv2_train.py feeds both sides the same drop-path masks):
in the mask form the masks the port drew, in the RNG form the Philox
masks of the seeds it drew (dropout_keep_plain).  Logits, loss and
gradients run the JAX model unscanned (scan_blocks False), where each
layer calls make_dropout_mask once.  The train step compares with the JAX
package's make_finetune_train_step, whose optimizer reads the scanned
tree: under nn.scan one traced call serves every layer, so there both
sides take one mask (or one seed) for every layer.

Tolerances (relative to each leaf's largest magnitude), those
tests/test_torch_train_step.py holds the step without dropout to: logits
1e-5, loss 1e-5, every gradient leaf 1e-4, parameters and Adam moments
after one step 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import simple_tad_tpu.ops.attention as jattn
from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_finetune_train_step as jax_step
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.ops import attention as attn
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import (TrainState,
                                              make_finetune_train_step)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_train_step import (_adam_moments, _torch_batch,
                                         _tree_close)
from tests.test_torch_vit import one_torch_thread  # noqa: F401

TINY = dict(img_size=64, all_frames=4, patch_size=16, tubelet_size=2,
            embed_dim=128, depth=2, num_heads=2, num_classes=2,
            init_scale=1.0, init_values=0.1, attn_drop_rate=0.3)
B, N, H = 4, 32, 2
FORMS = ["mask", "rng"]


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LN", "force")
    with pltpu.force_tpu_interpret_mode():
        yield


def _params(seed=0):
    params = JaxViT(JaxViTConfig(**TINY)).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _batch():
    rng = np.random.default_rng(1)
    labels = np.array([1, 0, 1, 1])
    video = rng.standard_normal((B, 4, 64, 64, 3)).astype(np.float32)
    video += labels[:, None, None, None, None] * 0.5
    return {"video": video, "label": labels.astype(np.int32),
            "smoothed": np.zeros((B, 2), np.float32),
            "ttc": np.zeros(B, np.float32)}


def _port_model(params, form):
    model = VisionTransformer(ViTConfig(**TINY, attn_dropout_form=form,
                                        param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(tc.from_jax_params(params))
    return model


def _record_masks(monkeypatch, form, fixed=None):
    """Record the keep mask of each of the port's attention dropout calls,
    in call order; with ``fixed`` every call draws that mask (mask form) or
    that seed (RNG form) instead."""
    masks = []
    if form == "mask":
        make = attn.make_dropout_mask

        def draw(generator, rate, b, h, n, device=None):
            m = (torch.from_numpy(fixed) if fixed is not None
                 else make(generator, rate, b, h, n, device))
            masks.append(m.numpy())
            return m
        monkeypatch.setattr(attn, "make_dropout_mask", draw)
    else:
        seed_of = attn.draw_dropout_seed

        def draw(generator, device=None):
            seed = fixed if fixed is not None else seed_of(generator, device)
            masks.append(fa.dropout_keep_plain(
                seed, B, H, N, TINY["attn_drop_rate"]).numpy())
            return seed
        monkeypatch.setattr(attn, "draw_dropout_seed", draw)
    return masks


def _feed_jax(monkeypatch, masks):
    """The JAX package's make_dropout_mask returns ``masks`` in order."""
    it = iter(masks)
    monkeypatch.setattr(jattn, "make_dropout_mask",
                        lambda rng, rate, b, h, n: jnp.asarray(next(it)))
    return it


def _unscanned(params):
    out = dict(params)
    blocks = out.pop("blocks")
    for i in range(TINY["depth"]):
        out[f"blocks_{i}"] = jax.tree_util.tree_map(lambda a: a[i], blocks)
    return out


def _rescanned(tree):
    out = dict(tree)
    layers = [out.pop(f"blocks_{i}") for i in range(TINY["depth"])]
    out["blocks"] = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers)
    return out


@pytest.mark.parametrize("form", FORMS)
def test_logits_loss_and_gradients_match_jax(form, pallas, monkeypatch):
    params = _params()
    batch = _batch()
    masks = _record_masks(monkeypatch, form)
    model = _port_model(params, form).train()
    gen = torch.Generator().manual_seed(0)
    logits = model(torch.from_numpy(batch["video"]), generator=gen)
    loss = L.cross_entropy(logits, torch.from_numpy(batch["label"]).long())
    loss.backward()
    assert len(masks) == TINY["depth"]
    assert all(m.shape == (B, H, N, N) for m in masks)
    assert not np.array_equal(masks[0], masks[1])
    assert 0.6 < np.mean(masks) < 0.8
    grads = tc.to_jax_params({n: p.grad for n, p in model.named_parameters()})

    left = _feed_jax(monkeypatch, masks)
    jmodel = JaxViT(JaxViTConfig(**TINY, attn_impl="pallas",
                                 scan_blocks=False))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(batch["video"]),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(2),
                                 "droppath": jax.random.PRNGKey(3)})
        return JL.cross_entropy(out, jnp.asarray(batch["label"])), out

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, _unscanned(params)))
    assert next(left, None) is None
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=0,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _tree_close(grads, _rescanned(jgrads), 1e-4, "grad")
    # a control: the same weights without dropout fail the logits bound
    with torch.no_grad():
        clean = model.eval()(torch.from_numpy(batch["video"]))
    assert not np.allclose(clean.numpy(), jlogits, rtol=0,
                           atol=1e-5 * np.abs(jlogits).max())


@pytest.mark.parametrize("form", FORMS)
def test_train_step_matches_jax(form, pallas, monkeypatch):
    """One step of make_finetune_train_step (layer-decay AdamW, weight
    decay 0.05, clip 1.0) with one keep mask (or seed) for every layer."""
    params = _params()
    batch = _batch()
    if form == "mask":
        fixed = (np.random.default_rng(4).random((B, H, N, N))
                 >= TINY["attn_drop_rate"]).astype(np.int8)
    else:
        fixed = torch.tensor([31337, -271828], dtype=torch.int32)
    masks = _record_masks(monkeypatch, form, fixed)
    model = _port_model(params, form)
    lr = JO.cosine_scheduler(5e-4, 1e-5, 1, 4)
    wd = JO.cosine_scheduler(0.05, 0.05, 1, 4)
    opt = O.FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=O.array_schedule(lr),
        wd_schedule=O.array_schedule(wd), weight_decay=0.05,
        layer_decay=0.75, depth=2, clip_grad=1.0)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    step = make_finetune_train_step(L.create_criterion("crossentropy"))
    m, logits = step(state, _torch_batch(batch))
    assert len(masks) == TINY["depth"]
    assert np.array_equal(masks[0], masks[1])

    _feed_jax(monkeypatch, masks * 4)
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd),
                             weight_decay=0.05, layer_decay=0.75, depth=2,
                             clip_grad=1.0)
    jmodel = JaxViT(JaxViTConfig(**TINY, attn_impl="pallas"))
    jstep = jax_step(jmodel, tx, JL.create_criterion("crossentropy"),
                     donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    jstate, (jm, _) = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                           batch))
    assert logits.shape == (B, 2)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _tree_close(tc.to_jax_params(state.model.state_dict()), jstate.params,
                1e-5, "params after the step")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")


def test_eval_mode_takes_no_dropout():
    """In eval mode (and at rate 0) the model draws nothing: the generator
    does not move and the logits are those of the model without dropout."""
    params = _params()
    video = torch.from_numpy(_batch()["video"])
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    with torch.no_grad():
        got = _port_model(params, "rng").eval()(video, generator=g)
        plain = VisionTransformer(ViTConfig(**{**TINY, "attn_drop_rate": 0.0},
                                            param_dtype=torch.float32),
                                  device="cpu")
        plain.load_state_dict(tc.from_jax_params(params))
        want = plain.train()(video, generator=g)
    assert torch.equal(g.get_state(), state)
    assert torch.equal(got, want)


def test_attn_dropout_form_is_checked():
    with pytest.raises(ValueError, match="attn_dropout_form"):
        VisionTransformer(ViTConfig(**TINY, attn_dropout_form="bits"),
                          device="cpu")


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_dota_full
    root = str(tmp_path_factory.mktemp("dota_full"))
    return make_synthetic_dota_full(root, n_clips=2, frames_per_clip=24,
                                    h=48, w=64)


@pytest.mark.parametrize("form", FORMS)
def test_finetune_cli_with_attn_dropout(form, full_root, tmp_path):
    """The fine-tuning CLI with --attn_drop_rate 0.1 on the synthetic DoTA
    fixture, on the CPU: one epoch finishes with a finite loss."""
    from simple_tad_tpu_torch.cli.finetune import main
    from tests.test_torch_train_cli import _args
    out = str(tmp_path / form)
    calls = []
    fwd = fa.flash_attention_drop_fwd_plain

    def spy(*args, **kw):
        calls.append(1)
        return fwd(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_attention_drop_fwd_plain", spy)
        state = main(_args(full_root, out, "--attn_drop_rate", "0.1",
                           "--attn_dropout_form", form))
    assert state.step > 0 and calls
    assert state.model.cfg.attn_drop_rate == 0.1
    assert state.model.cfg.attn_dropout_form == form
    with open(f"{out}/log.txt") as f:
        import json
        record = json.loads(f.readline())
    assert np.isfinite(record["train_loss"])
