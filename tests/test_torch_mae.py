"""The port's MAE / DAPT pre-training model, targets, train step and
augmentations (simple_tad_tpu_torch.models.mae, train.steps, ops.augment)
against the JAX package and the executed-reference goldens, on CPU.

Tolerances: ``mask_partition`` exactly (the same stable order); the
targets within 1e-5 of both JAX orders (fp32 per-patch means and variances
summed in another order; targets are O(1)), and the port's gather-first
order bit-equal to its gather-last one; the goldens at
tests/test_golden_parity.py's atol and rtol 1e-4; predictions on the same
weights at fp32 within 1e-4 (ROADMAP.md's slice gate); one and two MAE
steps at tests/test_torch_train_step.py's bounds (loss 1e-5, every gradient
leaf 1e-4, parameters and Adam moments 1e-5, each relative to the leaf's
largest magnitude); the augmentations at tests/test_torch_train_augment.py's
bounds, 2e-3 grey levels with at most 0.1% of values beyond (bilinear and
cubic taps summed in another fp32 order, and warps whose source lands on
the other side of a floor), read after the normalisation as 2e-3 / (255 *
0.224) = 3.5e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models import mae as jax_mae
from simple_tad_tpu.ops import augment as JA
from simple_tad_tpu.ops.image import IMAGENET_MEAN, IMAGENET_STD
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_mae_train_step as jax_mae_step
from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
from simple_tad_tpu_torch.models import create_model
from simple_tad_tpu_torch.models import mae
from simple_tad_tpu_torch.ops import augment as A
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import TrainState, make_mae_train_step
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests import golden_utils as gu
from tests.test_torch_train_step import (_adam_moments, _tree_close,
                                         pallas)  # noqa: F401
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# 4 frames of 32 x 32 at tubelet 2: 8 tokens, 6 masked at ratio 0.75; head
# dim 64 in the encoder (2 heads) and the decoder (1 head)
TINY = dict(img_size=32, patch_size=16, all_frames=4, tubelet_size=2,
            encoder_embed_dim=128, encoder_depth=2, encoder_num_heads=2,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=1,
            decoder_num_classes=1536)
B = 3
NORM_ATOL = 2e-3 / (255 * 0.224)


def _masks(seed, batch=B, window=(2, 2, 2), ratio=0.75):
    gen = TubeMaskingGenerator(window, ratio)
    return gen.batch(batch, np.random.default_rng(seed)), gen.total_masks


def _jax_params(cfg, seed=0):
    model = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**cfg))
    mask, nm = _masks(0, 1)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4, 32, 32, 3)), jnp.asarray(mask),
                        nm)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _port(params, cfg, **extra):
    model = mae.PretrainVideoMAE(mae.MAEConfig(**cfg, **extra), device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    return model


def test_mask_partition_is_stable_and_matches_jax():
    mask, nm = _masks(1, batch=5, window=(4, 3, 3))
    vis, msk = mae.mask_partition(torch.from_numpy(mask), nm)
    jvis, jmsk = jax_mae.mask_partition(jnp.asarray(mask), nm)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jmsk))
    for b in range(5):        # the reference's x[~mask] and x[mask] orders
        np.testing.assert_array_equal(vis[b].numpy(), np.nonzero(~mask[b])[0])
        np.testing.assert_array_equal(msk[b].numpy(), np.nonzero(mask[b])[0])


@pytest.mark.parametrize("normalize_target", [True, False])
def test_targets_match_both_jax_orders(normalize_target):
    rng = np.random.default_rng(2)
    video = rng.standard_normal((B, 4, 32, 32, 3)).astype(np.float32)
    mask, nm = _masks(3)
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    kw = dict(patch_size=16, tubelet_size=2,
              normalize_target=normalize_target)
    got = mae.mae_targets(torch.from_numpy(video), torch.from_numpy(mask), nm,
                          mean=torch.from_numpy(mean),
                          std=torch.from_numpy(std), **kw)
    fused = jax_mae.mae_targets_fused(jnp.asarray(video), jnp.asarray(mask),
                                      nm, mean=jnp.asarray(mean),
                                      std=jnp.asarray(std), **kw)
    unnorm = video * std + mean
    plain = jax_mae.mae_targets(jnp.asarray(unnorm), jnp.asarray(mask), nm,
                                **kw)
    got_unnorm = mae.mae_targets(torch.from_numpy(unnorm),
                                 torch.from_numpy(mask), nm, **kw)
    assert got.shape == (B, nm, 1536) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_unnorm.numpy(), np.asarray(plain),
                               atol=1e-5, rtol=0)
    # gather first (the helper) and gather last give the same bits
    every = np.ones((B, 8), bool)
    all_tokens = mae.mae_targets(torch.from_numpy(video),
                                 torch.from_numpy(every), 8,
                                 mean=torch.from_numpy(mean),
                                 std=torch.from_numpy(std), **kw)
    _, idx = mae.mask_partition(torch.from_numpy(mask), nm)
    last = torch.gather(all_tokens, 1, idx[:, :, None].expand(-1, -1, 1536))
    assert torch.equal(got, last)


@pytest.mark.parametrize("name,model_name", [
    ("mae_s.npz", "pretrain_videomae_small_patch16_224"),
    ("mvd_mae_s.npz", "pretrain_videomae_mvd_small_patch16_224")])
def test_executed_reference_goldens(name, model_name, tmp_path):
    path = os.path.join(GOLDENS, name)
    if not os.path.exists(path):
        pytest.skip(f"golden fixture {name} missing")
    want, manifest, meta = gu.load_golden(path)
    sd = gu.build_state_dict(manifest)
    ckpt = str(tmp_path / "golden.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    model = create_model(model_name, device="cpu",
                         decoder_depth=meta.get("decoder_depth", 8))
    loaded = tc.load_checkpoint_auto(ckpt, model)
    assert set(loaded) == set(model.state_dict())     # every weight loaded
    x = gu.input_video(meta["input_seed"], meta["batch"], 16, 224)
    mask = gu.tube_mask(meta["mask_seed"], meta["batch"], 8 * 196,
                        meta["n_masked"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 2, 3, 4, 1)).contiguous(),
                    torch.from_numpy(mask), meta["n_masked"])
    np.testing.assert_allclose(got[:, :meta["slice_tokens"]].numpy(), want,
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["1d", "3d"])
def test_predictions_match_jax(kind):
    cfg = dict(TINY, pos_embed_kind=kind, init_values=0.1)
    params = _jax_params(cfg)
    model = _port(params, cfg).eval()
    video = np.random.default_rng(4).standard_normal(
        (B, 4, 32, 32, 3)).astype(np.float32)
    mask, nm = _masks(5)
    want = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(video), jnp.asarray(mask), nm)
    with torch.inference_mode():
        got = model(torch.from_numpy(video), torch.from_numpy(mask), nm)
    assert got.shape == (B, nm, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    _tree_close(tc.to_jax_params(model.state_dict()), params, 0.0,
                "round trip")


def test_mae_steps_match_jax(pallas):
    """One step's loss and every gradient leaf, then the parameters and
    Adam moments after one and two steps, of the port's MAE step against
    make_mae_train_step (the CLI's AdamW: betas 0.9 / 0.95, weight decay
    0.05 on a cosine schedule), from the same weights, the JAX side through
    its Pallas kernels in interpret mode."""
    cfg = dict(TINY, init_values=0.1)
    params = _jax_params(cfg, seed=1)
    rng = np.random.default_rng(6)
    batches = []
    for i in range(2):
        mask, nm = _masks(7 + i)
        batches.append({"video": rng.standard_normal(
            (B, 4, 32, 32, 3)).astype(np.float32), "mask": mask})
    lr = JO.cosine_scheduler(1.5e-4, 1e-5, 1, 4)
    wd = JO.cosine_scheduler(0.05, 0.05, 1, 4)
    kw = dict(weight_decay=0.05, betas=(0.9, 0.95))
    jm = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**cfg))
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd), **kw)
    jstep = jax_mae_step(jm, tx, num_masked=nm, donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    model = _port(params, cfg, param_dtype=torch.float32)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(lr),
                              wd_schedule=O.array_schedule(wd), **kw)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    step = make_mae_train_step(num_masked=nm)

    def jax_loss(p, b):
        targets = jax_mae.mae_targets_fused(
            jnp.asarray(b["video"]), jnp.asarray(b["mask"]), nm,
            mean=jnp.asarray(IMAGENET_MEAN), std=jnp.asarray(IMAGENET_STD))
        pred = jm.apply({"params": p}, jnp.asarray(b["video"]),
                        jnp.asarray(b["mask"]), nm)
        return jnp.mean(jnp.square(pred - targets))

    for i, b in enumerate(batches):
        if i == 0:
            want_loss, want_grads = jax.value_and_grad(jax_loss)(
                jstate.params, b)
        jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                                       rtol=1e-5)
            _tree_close(tc.to_jax_params({n: p.grad for n, p in
                                          model.named_parameters()}),
                        want_grads, 1e-4, "grad")
        _tree_close(tc.to_jax_params(model.state_dict()), jstate.params,
                    1e-5, f"params after step {i + 1}")
    assert state.step == 2 and opt.count == 2
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")


# ------------------------------------------------------------ augmentation --

def _u8(b=4, t=2, h=40, w=64, seed=0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 200, w, dtype=np.float32)[None, None, None, :,
                                                    None]
    noise = rng.normal(0, 25, (b, t, h, w, 3)).astype(np.float32)
    return np.clip(base + noise + 20, 0, 255).round().astype(np.uint8)


def _close(got, want, atol, share=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bad = np.abs(got - want) > atol
    assert bad.mean() <= share, (bad.mean(), np.abs(got - want).max())


def _crop_draws(key, B, n_pairs):
    """ops/augment.py:group_multi_scale_crop's draws, repeated."""
    kpair, koff = jax.random.split(key)
    return {"pair": torch.from_numpy(np.array(jax.random.randint(
                kpair, (B,), 0, n_pairs)).astype(np.int64)),
            "offset": torch.from_numpy(np.array(jax.random.randint(
                koff, (B,), 0, 13)).astype(np.int64))}


def _pad_draws(key, B, H, W):
    """ops/augment.py:pad_wide_and_resize's draws, repeated."""
    kmode, ktop, kbot, kalpha, kcolor = jax.random.split(key, 5)
    slot = np.asarray(jax.random.randint(kmode, (B,), 0, 12))
    mode = np.select([slot < 5, slot < 7, slot < 8, slot < 10],
                     [0, 1, 2, 3], 4)
    h_to_sq = W - H
    return {
        "mode": torch.from_numpy(mode),
        "pad_top": torch.from_numpy(np.array(jnp.round(
            jax.random.uniform(ktop, (B,)) * 0.5 * h_to_sq))),
        "pad_bot": torch.from_numpy(np.array(jnp.round(
            jax.random.uniform(kbot, (B,)) * 0.5 * h_to_sq))),
        "alpha": torch.from_numpy(np.array(
            jax.random.uniform(kalpha, (B,)) * 0.7)),
        "color": torch.from_numpy(np.array(jax.random.randint(
            kcolor, (B, 3), 0, 256)).astype(np.float32))}


def _ra_draws(key, B, L=3):
    """ops/augment.py:rand_augment_drive's per-clip draws, repeated."""
    draws = {k: np.zeros((B, L), dt) for k, dt in
             (("op", np.int64), ("mag", np.float32), ("apply", bool),
              ("sign", bool))}
    for b, k in enumerate(jax.random.split(key, B)):
        for i in range(L):
            k, kop, kmag, kapply, kparam = jax.random.split(k, 5)
            draws["op"][b, i] = int(jax.random.randint(kop, (), 0, 10))
            draws["mag"][b, i] = float(jnp.clip(
                6.0 + 0.5 * jax.random.normal(kmag), 0.0, 10.0))
            draws["apply"][b, i] = bool(jax.random.bernoulli(kapply, 0.5))
            draws["sign"][b, i] = bool(jax.random.bernoulli(kparam))
    return {k: torch.from_numpy(v) for k, v in draws.items()}


@pytest.mark.parametrize("scales", [A.ORIG_SCALES, A.ALIGN_SCALES])
def test_group_multi_scale_crop_matches_jax(scales):
    video = _u8(b=16, h=40, w=64).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = _crop_draws(key, 16, len(A.crop_pairs(40, 64, 32, scales)))
    want = JA.group_multi_scale_crop(jnp.asarray(video), key, 32,
                                     scales=scales)
    got = A.apply_multi_scale_crop(torch.from_numpy(video), params, 32,
                                   scales)
    assert got.shape == (16, 2, 32, 32, 3)
    _close(got, want, 2e-3)


def test_pretrain_augment_orig_matches_jax():
    u8 = _u8(seed=1)
    key = jax.random.PRNGKey(4)
    want = JA.pretrain_augment_orig(jnp.asarray(u8), key, crop_size=32)
    got = A.apply_pretrain_orig(torch.from_numpy(u8),
                                {"crop": _crop_draws(key, 4, len(
                                    A.crop_pairs(40, 64, 32)))},
                                crop_size=32)
    _close(got, want, NORM_ATOL)


def test_pretrain_augment_align_matches_jax():
    u8 = _u8(b=8, seed=2)
    key = jax.random.PRNGKey(5)
    k1, k2, k3, kgate = jax.random.split(key, 4)
    params = {
        "pad": _pad_draws(k1, 8, 40, 64), "ra": _ra_draws(k2, 8),
        "gate": torch.from_numpy(np.array(jax.random.uniform(kgate, (8,)))),
        "crop": _crop_draws(k3, 8, len(A.crop_pairs(32, 32, 32,
                                                    A.ALIGN_SCALES)))}
    assert 0 < int((params["gate"] > 0.3).sum()) < 8
    want = JA.pretrain_augment_align(jnp.asarray(u8), key, crop_size=32)
    got = A.apply_pretrain_align(torch.from_numpy(u8), params, crop_size=32)
    assert got.shape == (8, 2, 32, 32, 3)
    _close(got, want, NORM_ATOL, share=1e-3)


def test_pretrain_augment_draws_are_seeded():
    """The draw/apply entry points: seeded, reproducible, the shapes and
    dtype asked for."""
    u8 = torch.from_numpy(_u8(b=6, seed=3))
    for fn in (A.pretrain_augment_orig, A.pretrain_augment_align):
        a = fn(u8, torch.Generator().manual_seed(0), crop_size=32,
               dtype=torch.bfloat16)
        b = fn(u8, torch.Generator().manual_seed(0), crop_size=32,
               dtype=torch.bfloat16)
        assert a.shape == (6, 2, 32, 32, 3) and a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.isfinite(a.float()).all()


def test_from_ckpt_warm_start_matches_jax_merge(tmp_path):
    """The pre-training CLI's --from_ckpt: a reference-named .pth laid over
    the initialised PretrainVideoMAE (load_mae_checkpoint) equals the JAX
    package's torch_to_mae_params merged over its init (merge_params), leaf
    for leaf; a position table in the file is ignored, and a file that
    lacks a key the JAX converter reads raises."""
    from simple_tad_tpu.utils import torch_convert as jax_tc
    src = mae.PretrainVideoMAE(mae.MAEConfig(**TINY), device="cpu")
    src.init_weights(torch.Generator().manual_seed(3))
    sd = dict(src.state_dict())
    sd["encoder.pos_embed"] = torch.zeros(1, 8, 128)
    path = str(tmp_path / "k700.pth")
    torch.save({"model": sd}, path)
    model = mae.PretrainVideoMAE(mae.MAEConfig(**TINY), device="cpu")
    model.init_weights(torch.Generator().manual_seed(4))
    loaded = tc.load_checkpoint_auto(path, model)
    assert set(loaded) == set(model.state_dict())
    jax_params = _jax_params(TINY)
    want = jax_tc.merge_params(jax_params, jax_tc.torch_to_mae_params(
        {k: v.numpy() for k, v in sd.items()}, encoder_depth=2,
        decoder_depth=2))
    _tree_close(tc.to_jax_params(model.state_dict()), want, 0.0, "merged")
    del sd["mask_token"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="mask_token"):
        tc.load_mae_checkpoint(path, model)
