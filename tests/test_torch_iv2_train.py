"""The port's InternVideo2 fine-tuning (simple_tad_tpu_torch.models.
internvideo2 in training, to_jax_params, the optimizer trees, the finetune
CLI) against the JAX package, on a tiny fp32 IV2 (depth 2, dim 128, 2
heads of 64, 2 frames of 28x28: N = 9 tokens with the CLS token), both
starting from the same weights (from_jax_params), the JAX side through its
Pallas kernels in interpret mode (attn_impl 'pallas': the training
attention _flash_fwd_impl / _flash_bwd_impl under its custom VJP).
Stochastic depth is off in the step comparisons (drop_path_rate 0): the two
frameworks' random bits cannot match, so test_drop_path_matches_jax feeds
both the same masks instead.

AdamW as the IV2-S job runs it (lr 1e-3 and min lr 1e-6 scaled by the
batch over 256, as the CLI scales them; weight decay 0.05; the CLI's layer
decay 0.75), clip 1.0, a cosine lr schedule.

Tolerances (relative to each leaf's largest magnitude), those
tests/test_torch_train_step.py holds the ViT to: loss 1e-5, every gradient
leaf 1e-4, parameters and Adam moments after one and two steps 1e-5, EMA
1e-5; logits with injected stochastic-depth masks 1e-5 (fp32, XLA's
attention against the plain one); the parameter round trip, the masks and
the layer scales exact.  The gradients carry fp32 summation-order noise
of up to ~2e-5 of a leaf's largest magnitude (the JAX package's own Pallas
and XLA attention paths differ by 5e-6 on these inputs), and Adam's first
steps divide each gradient by its own magnitude, so an element whose
gradient sits near eps (1e-8) turns that noise into a visible part of the
lr: the step comparisons run at the job's lr scaled to this batch, as the
CLI scales it.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models import layers as jax_layers
from simple_tad_tpu.models.internvideo2 import IV2Config as JaxIV2Config
from simple_tad_tpu.models.internvideo2 import InternVideo2 as JaxIV2
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_finetune_train_step as jax_step
from simple_tad_tpu_torch.models import internvideo2, layers
from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import (TrainState,
                                              make_finetune_train_step)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_train_optim import (_as_tree, _assert_trees_equal,
                                          _expand)
from tests.test_torch_train_step import _adam_moments, _torch_batch
from tests.test_torch_train_step import _tree_close as _leaves_close
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

TINY = dict(img_size=28, patch_size=14, embed_dim=128, depth=2, num_heads=2,
            mlp_ratio=4.0, num_frames=2, attn_pool_num_heads=2,
            clip_embed_dim=32, init_scale=1.0, num_classes=2)
B = 4
# the IV2-S job's lr 1e-3 and min lr 1e-6, scaled by batch / 256 as the CLI
# scales them, over a 4-step cosine; weight decay 0.05
LR = dict(base=1e-3 * B / 256, final=1e-6 * B / 256, steps=4)


@pytest.fixture
def pallas():
    with pltpu.force_tpu_interpret_mode():
        yield


def _jax_model(**cfg):
    return JaxIV2(JaxIV2Config(**{**TINY, "drop_path_rate": 0.0,
                                  "attn_impl": "pallas", **cfg}))


def _params(seed=0, **cfg):
    """JAX init, every leaf moved by seeded noise (LayerScale gammas and
    norms by 0.1, so the trunk moves the loss)."""
    x = jnp.zeros((1, 2, 28, 28, 3))
    params = _jax_model(attn_impl="auto", **cfg).init(
        jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = jax.tree_util.keystr(path)
        big = "scale" in name or "gamma" in name
        return a + (0.1 if big else 0.02) * rng.standard_normal(
            a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params)


def _port_model(params, **cfg):
    model = InternVideo2(IV2Config(**{**TINY, "drop_path_rate": 0.0,
                                      "param_dtype": torch.float32, **cfg}),
                         device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    return model


def _batches(n):
    """Seeded clips, three of four labelled positive: with balanced labels
    the classifier's gradient (p - y) cancels over the batch, and the
    fc_norm bias's gradient, a sum of four such rows, is then ill-
    conditioned beyond fp32's reach (the JAX package's Pallas and XLA
    attention paths already disagreed by 7e-6 of its Adam moment)."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        labels = rng.permutation([1, 1, 1, 0])
        video = rng.standard_normal((B, 2, 28, 28, 3)).astype(np.float32)
        video += labels[:, None, None, None, None] * 0.5
        out.append({"video": video, "label": labels.astype(np.int32),
                    "smoothed": np.zeros((B, 2), np.float32),
                    "ttc": np.zeros(B, np.float32)})
    return out


def _tree_close(got_tree, want_tree, rel, what):
    """``_leaves_close`` (each leaf within ``rel`` of its own largest
    magnitude), except the pooling head's key biases (``k_bias`` and
    ``norm_k``'s bias): their gradient is zero in exact arithmetic (a bias
    added to every key shifts each softmax row by a constant), so both
    sides hold only rounding noise (~1e-10), which Adam turns into updates
    of up to ~1e-2 of the lr.  Those leaves are held to ``rel`` of the
    whole tree's largest magnitude."""
    def split(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        pool = dict(tree["clip_projector"])
        norm_k = dict(pool["norm_k"])
        keys = (pool.pop("k_bias"), norm_k.pop("bias"))
        pool["norm_k"] = norm_k
        return {**tree, "clip_projector": pool}, keys

    got, got_keys = split(got_tree)
    want, want_keys = split(want_tree)
    _leaves_close(got, want, rel, what)
    scale = max(float(np.abs(a).max())
                for a in jax.tree_util.tree_leaves(want_tree))
    for name, g, w in zip(("k_bias", "norm_k bias"), got_keys, want_keys):
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=f"{what} clip_projector {name}")


def _optimizers(params, model, update_freq):
    lr = JO.cosine_scheduler(LR["base"], LR["final"], 1, LR["steps"])
    wd = JO.cosine_scheduler(0.05, 0.05, 1, LR["steps"])
    kw = dict(weight_decay=0.05, layer_decay=0.75, depth=2, clip_grad=1.0)
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd), **kw)
    if update_freq > 1:
        tx = optax.MultiSteps(tx, update_freq)
    opt = O.FinetuneOptimizer(
        dict(model.named_parameters()), lr_schedule=O.array_schedule(lr),
        wd_schedule=O.array_schedule(wd), update_freq=update_freq, **kw)
    return tx, opt


def test_gradients_and_loss_match_jax(pallas):
    params = _params()
    batch = _batches(1)[0]
    jm = _jax_model()

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(batch["video"]),
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2),
                                "droppath": jax.random.PRNGKey(3)})
        return JL.cross_entropy(logits, jnp.asarray(batch["label"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _port_model(params)
    _, opt = _optimizers(params, model, 1)
    step = make_finetune_train_step(L.create_criterion("crossentropy"))
    metrics, _ = step(TrainState.create(model, opt, torch.Generator()),
                      _torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _tree_close(tc.to_jax_params(grads), want_grads, 1e-4, "grad")
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(want_grads)),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["adamw", "update_freq2", "ema"])
def test_train_steps_match_jax(case, pallas):
    ema_decay = 0.9 if case == "ema" else None
    update_freq = 2 if case == "update_freq2" else 1
    params = _params()
    model = _port_model(params)
    tx, opt = _optimizers(params, model, update_freq)
    jstep = jax_step(_jax_model(), tx, JL.create_criterion("crossentropy"),
                     ema_decay=ema_decay, donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1),
                                  ema_decay=ema_decay)
    step = make_finetune_train_step(L.create_criterion("crossentropy"),
                                    ema_decay=ema_decay)
    state = TrainState.create(model, opt, torch.Generator(),
                              ema_decay=ema_decay)
    for i, b in enumerate(_batches(2)):
        jstate, (jm, _) = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                               b))
        m, logits = step(state, _torch_batch(b))
        assert logits.shape == (B, 2)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _tree_close(tc.to_jax_params(state.model.state_dict()),
                    jstate.params, 1e-5, f"params after step {i + 1}")
    assert state.step == 2 and state.optimizer.count == 2 // update_freq
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(state.optimizer.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(state.optimizer.nu), nu, 1e-5, "nu")
    if ema_decay:
        _tree_close(tc.to_jax_params(state.ema), jstate.ema_params, 1e-5,
                    "ema")


def test_drop_path_matches_jax(monkeypatch):
    """Stochastic depth at rates linspace(0, 0.4, 3), on both residual
    branches after LayerScale: the port's train-mode forward with injected
    per-sample masks against the JAX model (blocks unscanned) whose
    jax.random.bernoulli returns the same masks, so the JAX formula
    (layers.drop_path: x * mask / keep) runs on them."""
    cfg = dict(depth=3, drop_path_rate=0.4)
    params = _params(**cfg)
    rng = np.random.default_rng(5)
    # one (B,) mask per call, in call order (layer i: attention branch,
    # then MLP branch); layer 0 has rate 0, which keeps every sample
    masks = [np.ones(B, bool)] * 2 + [rng.random(B) < 0.5 for _ in range(4)]
    assert any(not m.all() for m in masks)
    video = _batches(1)[0]["video"]

    jax_masks = iter(masks)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: (
        jnp.asarray(next(jax_masks)).reshape(shape)))
    unscanned = dict(params)
    blocks = unscanned.pop("blocks")
    for i in range(3):
        unscanned[f"blocks_{i}"] = jax.tree_util.tree_map(lambda a: a[i],
                                                          blocks)
    jm = JaxIV2(JaxIV2Config(**dict(TINY, **cfg), scan_blocks=False))
    want = jm.apply({"params": unscanned}, jnp.asarray(video),
                    deterministic=False,
                    rngs={"droppath": jax.random.PRNGKey(0)})
    assert next(jax_masks, None) is None

    port_masks = iter(masks)

    def injected(x, rate, training, generator=None):
        return layers.drop_path(x, rate, training,
                                mask=torch.from_numpy(next(port_masks)))

    monkeypatch.setattr(internvideo2, "drop_path", injected)
    model = _port_model(params, **cfg).train()
    assert [b.drop_path_rate for b in model.blocks] == pytest.approx(
        [0.0, 0.2, 0.4])
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
    assert next(port_masks, None) is None
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # and the formula alone, on the same mask
    x = rng.standard_normal((B, 9, 128)).astype(np.float32)
    jax_masks = iter([masks[2]])
    np.testing.assert_array_equal(
        layers.drop_path(torch.from_numpy(x), 0.3, True,
                         mask=torch.from_numpy(masks[2])).numpy(),
        np.asarray(jax_layers.drop_path(jnp.asarray(x), 0.3, False,
                                        jax.random.PRNGKey(0))))


@pytest.mark.parametrize("sep_pos_embed", [False, True])
def test_to_jax_params_inverts_from_jax_params(sep_pos_embed):
    params = jax.tree_util.tree_map(np.asarray, _params(
        sep_pos_embed=sep_pos_embed))
    back = tc.to_jax_params(tc.from_jax_params(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    _assert_trees_equal(back, params)


def _iv2_trees():
    """The JAX IV2 tree (separate position tables) and the port model's
    named parameters."""
    params = _params(sep_pos_embed=True, depth=3)
    model = _port_model(params, sep_pos_embed=True, depth=3)
    named = dict(model.named_parameters())
    for name in ("blocks.0.ls1.gamma", "blocks.0.attn.q_norm.weight",
                 "clip_projector.cross_attn.q_bias", "patch_embed.proj.weight",
                 "cls_token", "pos_embed_spatial", "pos_embed_temporal",
                 "pos_embed_cls"):
        assert name in named, name
    return params, named


def test_weight_decay_mask_matches_jax_on_iv2():
    params, named = _iv2_trees()
    got = _as_tree(O.weight_decay_mask(named.items()), named)
    _assert_trees_equal(got, _expand(JO.weight_decay_mask(params), params))


def test_layer_scale_tree_matches_jax_on_iv2():
    params, named = _iv2_trees()
    got = _as_tree(O.layer_scale_tree(named, 0.75, 3), named)
    _assert_trees_equal(got, _expand(JO.layer_scale_tree(params, 0.75, 3),
                                     params))


@pytest.mark.parametrize("spec", ["first N blocks;1", "probe;1;0",
                                  "probe;2;1"])
def test_freeze_mask_tree_matches_jax_on_iv2(spec):
    params, named = _iv2_trees()
    got = _as_tree(O.freeze_mask_tree(named, spec, 3), named)
    _assert_trees_equal(got, _expand(JO.freeze_mask_tree(params, spec, 3),
                                     params))


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_dota_full
    root = str(tmp_path_factory.mktemp("dota_full_iv2"))
    return make_synthetic_dota_full(root, n_clips=2, frames_per_clip=24,
                                    h=48, w=64)


def test_finetune_cli_iv2_one_epoch_and_auto_resume(full_root, tmp_path):
    """IV2-S at full width (12 layers, 384 wide) on 28x28 frames with the
    DoTA job's --num_frames 8 --view_fps 5: one epoch, checkpoints, then a
    second run auto-resumes.  --tubelet_size 2 (the ViT's flag) is given and
    must not reach the model: InternVideo2's tubelet is 1."""
    from simple_tad_tpu_torch.cli.finetune import main
    out = str(tmp_path / "run")
    args = ["--data_set", "DoTA", "--data_path", full_root,
            "--model", "internvideo2_small_patch14_224", "--input_size", "28",
            "--num_frames", "8", "--view_fps", "5", "--tubelet_size", "2",
            "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "0",
            "--output_dir", out, "--dtype", "float32", "--num_workers", "2",
            "--device", "cpu"]
    state = main(args)
    model = state.model
    assert isinstance(model, InternVideo2)
    assert model.cfg.tubelet_size == 1 and model.cfg.num_frames == 8
    assert model.patch_embed.proj.weight.shape[2] == 1
    assert model.cfg.drop_path_rate == 0.1          # the CLI's --drop_path
    assert state.step > 0 and state.optimizer.count == state.step
    params = model.state_dict()
    assert all(v.dtype == torch.float32 for v in params.values())
    resumed = main(args)
    assert resumed.step == state.step            # restored, no new steps
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, params[k]), k


def test_finetune_checkpoint_loads_into_fp32_training_iv2(tmp_path):
    """--finetune: a reference InternVideo2 .pth fills the fp32 masters by
    name (load_checkpoint_auto), its learnable position table included."""
    from simple_tad_tpu_torch.models import create_model
    kw = dict(device="cpu", img_size=28, depth=2, num_frames=2)
    src = create_model("internvideo2_small_patch14_224",
                       generator=torch.Generator().manual_seed(1), **kw)
    path = str(tmp_path / "init.pth")
    torch.save({"model": src.state_dict()}, path)
    model = create_model("internvideo2_small_patch14_224",
                         param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0), **kw)
    assert set(tc.load_checkpoint_auto(path, model)) == set(
        model.state_dict())
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert torch.equal(p, src.state_dict()[n].float()), n


def test_iv2_remat_raises():
    with pytest.raises(NotImplementedError, match="remat"):
        InternVideo2(dataclasses.replace(IV2Config(**TINY), remat=True),
                     device="cpu")
