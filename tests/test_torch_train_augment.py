"""The port's training augmentation (simple_tad_tpu_torch.ops.augment) and
stochastic depth against the JAX package's, with the same drawn
parameters: the JAX draws are repeated here from the JAX keys and handed
to the port's ``apply_*`` functions.

Tolerances: 2e-3 grey levels absolute for the resampling and warp ops
(fp32 sums of four taps or bilinear weights in another order); 1e-3 for
the blends and 0 for the integer ops (invert, equalize, erasing); pixels
that land on the other side of a floor or truncation (warps, equalize
after a float op) may differ by more in at most 0.1% of values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models import layers as jax_layers
from simple_tad_tpu.ops import augment as JA
from simple_tad_tpu_torch.models import layers
from simple_tad_tpu_torch.ops import augment as A


def _video(b=4, t=2, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 200, w, dtype=np.float32)[None, None, None, :,
                                                    None]
    noise = rng.normal(0, 25, (b, t, h, w, 3)).astype(np.float32)
    return np.clip(base + noise + 20, 0, 255).round().astype(np.float32)


def _close(got, want, atol, share=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bad = np.abs(got - want) > atol
    assert bad.mean() <= share, (bad.mean(), np.abs(got - want).max())


def test_pad_wide_and_resize_matches_jax():
    video = _video(b=24, h=24, w=40)
    key = jax.random.PRNGKey(3)
    B, _, H, W, _ = video.shape
    # JAX's draws (ops/augment.py:pad_wide_and_resize), repeated
    kmode, ktop, kbot, kalpha, kcolor = jax.random.split(key, 5)
    slot = np.asarray(jax.random.randint(kmode, (B,), 0, 12))
    mode = np.select([slot < 5, slot < 7, slot < 8, slot < 10],
                     [0, 1, 2, 3], 4)
    assert set(mode.tolist()) == {0, 1, 2, 3, 4}
    h_to_sq = W - H
    params = {
        "mode": torch.from_numpy(mode),
        "pad_top": torch.from_numpy(np.array(jnp.round(
            jax.random.uniform(ktop, (B,)) * 0.5 * h_to_sq))),
        "pad_bot": torch.from_numpy(np.array(jnp.round(
            jax.random.uniform(kbot, (B,)) * 0.5 * h_to_sq))),
        "alpha": torch.from_numpy(np.array(
            jax.random.uniform(kalpha, (B,)) * 0.7)),
        "color": torch.from_numpy(np.array(jax.random.randint(
            kcolor, (B, 3), 0, 256)).astype(np.float32)),
    }
    want = JA.pad_wide_and_resize(jnp.asarray(video), key, 32)
    got = A.apply_pad_wide(torch.from_numpy(video), params, 32)
    assert got.shape == (B, 2, 32, 32, 3)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("op", range(A.NUM_RA_OPS))
def test_rand_augment_op_matches_jax(op):
    video = _video(b=2, seed=op)
    mags = [4.5, 7.25]
    keys = [jax.random.PRNGKey(10 * op), jax.random.PRNGKey(10 * op + 1)]
    signs = [bool(jax.random.bernoulli(k)) for k in keys]
    want = np.stack([np.asarray(JA._RA_OPS[op](jnp.asarray(video[i]),
                                               mags[i], keys[i]))
                     for i in range(2)])
    got = A.RA_OPS[op](torch.from_numpy(video),
                       torch.tensor(mags, dtype=torch.float32),
                       torch.tensor(signs))
    atol = 0.0 if op in (1, 2) else (2e-3 if op in (3, 8, 9) else 1e-3)
    share = 1e-3 if op in (3, 8, 9) else 0.0
    _close(got, want, atol, share)


def test_rand_augment_drive_matches_jax():
    video = _video(b=6, seed=7)
    key = jax.random.PRNGKey(11)
    L = 3
    # JAX's per-clip draws (ops/augment.py:rand_augment_drive), repeated
    draws = {k: np.zeros((6, L), dt) for k, dt in
             (("op", np.int64), ("mag", np.float32), ("apply", bool),
              ("sign", bool))}
    for b, k in enumerate(jax.random.split(key, 6)):
        for i in range(L):
            k, kop, kmag, kapply, kparam = jax.random.split(k, 5)
            draws["op"][b, i] = int(jax.random.randint(kop, (), 0, 10))
            draws["mag"][b, i] = float(jnp.clip(
                6.0 + 0.5 * jax.random.normal(kmag), 0.0, 10.0))
            draws["apply"][b, i] = bool(jax.random.bernoulli(kapply, 0.5))
            draws["sign"][b, i] = bool(jax.random.bernoulli(kparam))
    want = JA.rand_augment_drive(jnp.asarray(video), key, magnitude=6.0,
                                 num_layers=L)
    got = A.apply_rand_augment(torch.from_numpy(video),
                               {k: torch.from_numpy(v)
                                for k, v in draws.items()})
    _close(got, want, 2e-3, share=1e-3)


def test_random_erasing_matches_jax():
    video = (_video(b=16, h=16, w=16) / 255.0 - 0.45) / 0.225
    key = jax.random.PRNGKey(5)
    B, T, H, W, C = video.shape
    karea, kaspect, ktop, kleft, kdo, knoise = jax.random.split(key, 6)
    area = jax.random.uniform(karea, (B,), minval=0.02,
                              maxval=1 / 3) * (H * W)
    ar = jnp.exp(jax.random.uniform(kaspect, (B,), minval=jnp.log(0.01),
                                    maxval=jnp.log(1 / 0.01)))
    h = jnp.clip(jnp.round(jnp.sqrt(area * ar)), 1, H - 1).astype(jnp.int32)
    w = jnp.clip(jnp.round(jnp.sqrt(area / ar)), 1, W - 1).astype(jnp.int32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in {
        "h": h, "w": w,
        "top": (jax.random.uniform(ktop, (B,)) * (H - h)).astype(jnp.int32),
        "left": (jax.random.uniform(kleft, (B,)) * (W - w)).astype(jnp.int32),
        "erase": jax.random.bernoulli(kdo, 0.5, (B,)),
        "noise": jax.random.normal(knoise, video.shape)}.items()}
    want = JA.random_erasing(jnp.asarray(video), key, probability=0.5)
    got = A.apply_random_erasing(torch.from_numpy(video), params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_augment_shape_range_and_erase_share():
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (64, 2, 24, 40, 3), dtype=np.uint8))
    g = torch.Generator().manual_seed(0)
    out = A.train_augment(u8, g, crop_size=16, reprob=0.25,
                          dtype=torch.bfloat16)
    assert out.shape == (64, 2, 16, 16, 3) and out.dtype == torch.bfloat16
    x = out.float()
    assert torch.isfinite(x).all()
    # away from erased pixels the values are normalized [0, 255] pixels
    lo = (0 - 0.485) / 0.229 - 0.05
    hi = (1 - 0.406) / 0.225 + 0.05
    plain = A.train_augment(u8, torch.Generator().manual_seed(0),
                            crop_size=16, reprob=0.0)
    assert plain.min() >= lo and plain.max() <= hi
    erased = (x != plain.to(torch.bfloat16).float()).flatten(1).any(1)
    assert 0.1 <= erased.float().mean() <= 0.45
    again = A.train_augment(u8, torch.Generator().manual_seed(0),
                            crop_size=16, reprob=0.25, dtype=torch.bfloat16)
    assert torch.equal(again, out)             # seeded: reproducible


def test_drop_path_with_injected_mask_matches_jax():
    """layers.drop_path with the JAX draw's keep mask."""
    x = np.random.default_rng(3).standard_normal((8, 5, 16)).astype(
        np.float32)
    rng = jax.random.PRNGKey(4)
    rate = 0.3
    keep = np.array(jax.random.bernoulli(rng, 1 - rate, (8, 1, 1)))[:, 0, 0]
    want = jax_layers.drop_path(jnp.asarray(x), rate, False, rng)
    got = layers.drop_path(torch.from_numpy(x), rate, True,
                           mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(layers.drop_path(torch.from_numpy(x), rate, False),
                       torch.from_numpy(x))
    module = layers.DropPath(rate)
    module.eval()
    assert torch.equal(module(torch.from_numpy(x)), torch.from_numpy(x))
