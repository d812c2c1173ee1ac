"""The port's class fine-tuning augmentations (simple_tad_tpu_torch.ops.
augment: the full RandAugment's four extra ops, random_resized_crop,
random_hflip, mixup_cutmix and the whole train_augment_cls) against the
JAX package's, with the same drawn parameters: the JAX draws are repeated
here from the JAX keys and handed to the port's ``apply_*`` functions.

Tolerances, those of tests/test_torch_train_augment.py: 2e-3 grey levels
absolute for the resampling and warp ops (fp32 sums of bilinear weights in
another order), pixels across a floor (warps) differing by more in at most
0.1% of values; 0 for posterize, solarize and the flip; mixup / cutmix
video within 1e-5 and its soft targets within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.ops import augment as JA
from simple_tad_tpu_torch.ops import augment as A
from tests.test_torch_train_augment import _close, _video


@pytest.mark.parametrize("op", range(A.NUM_RA_OPS, len(A.RA_FULL_OPS)))
def test_rand_augment_full_op_matches_jax(op):
    """The four ops the full RandAugment adds: posterize, solarize,
    translate x and y, each at two magnitudes and both signs."""
    video = _video(b=2, seed=op)
    mags = [4.5, 7.25]
    keys = [jax.random.PRNGKey(10 * op), jax.random.PRNGKey(10 * op + 3)]
    signs = [bool(jax.random.bernoulli(k)) for k in keys]
    want = np.stack([np.asarray(JA._RA_FULL_OPS[op](jnp.asarray(video[i]),
                                                    mags[i], keys[i]))
                     for i in range(2)])
    got = A.RA_FULL_OPS[op](torch.from_numpy(video),
                            torch.tensor(mags, dtype=torch.float32),
                            torch.tensor(signs))
    warp = op >= A.NUM_RA_OPS + 2
    _close(got, want, 2e-3 if warp else 0.0, 1e-3 if warp else 0.0)


def test_rand_augment_full_matches_jax():
    video = _video(b=8, seed=9)
    key = jax.random.PRNGKey(13)
    L, n_ops = 4, len(A.RA_FULL_OPS)
    # JAX's per-clip draws (ops/augment.py:rand_augment_full), repeated
    draws = {k: np.zeros((8, L), dt) for k, dt in
             (("op", np.int64), ("mag", np.float32), ("apply", bool),
              ("sign", bool))}
    for b, k in enumerate(jax.random.split(key, 8)):
        for i in range(L):
            k, kop, kmag, kapply, kparam = jax.random.split(k, 5)
            draws["op"][b, i] = int(jax.random.randint(kop, (), 0, n_ops))
            draws["mag"][b, i] = float(jnp.clip(
                7.0 + 0.5 * jax.random.normal(kmag), 0.0, 10.0))
            draws["apply"][b, i] = bool(jax.random.bernoulli(kapply, 0.5))
            draws["sign"][b, i] = bool(jax.random.bernoulli(kparam))
    assert draws["apply"].any() and (draws["op"] >= A.NUM_RA_OPS).any()
    want = JA.rand_augment_full(jnp.asarray(video), key)
    got = A.apply_rand_augment_full(torch.from_numpy(video),
                                    {k: torch.from_numpy(v)
                                     for k, v in draws.items()})
    _close(got, want, 2e-3, share=1e-3)


def test_random_resized_crop_matches_jax():
    video = _video(b=16, h=24, w=40, seed=4)
    key = jax.random.PRNGKey(6)
    B, _, H, W, _ = video.shape
    karea, kratio, kx, ky = jax.random.split(key, 4)
    params = {k: torch.from_numpy(np.array(v)) for k, v in {
        "area": jax.random.uniform(karea, (B,), minval=0.08, maxval=1.0),
        "log_ratio": jax.random.uniform(kratio, (B,),
                                        minval=jnp.log(3 / 4),
                                        maxval=jnp.log(4 / 3)),
        "x": jax.random.uniform(kx, (B,)),
        "y": jax.random.uniform(ky, (B,))}.items()}
    want = JA.random_resized_crop(jnp.asarray(video), key, 16)
    got = A.apply_random_resized_crop(torch.from_numpy(video), params, 16)
    assert got.shape == (B, 2, 16, 16, 3)
    _close(got, want, 2e-3)


def test_random_hflip_matches_jax():
    video = _video(b=12, seed=5)
    key = jax.random.PRNGKey(8)
    flip = np.array(jax.random.bernoulli(key, 0.5, (12,)))
    assert flip.any() and not flip.all()
    want = JA.random_hflip(jnp.asarray(video), key)
    got = A.apply_random_hflip(torch.from_numpy(video),
                               {"flip": torch.from_numpy(flip)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mixup_draws(key, H, W, prob):
    kuse, kswitch, klam1, klam2, kx, ky = jax.random.split(key, 6)
    return {k: torch.from_numpy(np.array(v)) for k, v in {
        "use": jax.random.bernoulli(kuse, prob),
        "use_cutmix": jax.random.bernoulli(kswitch, 0.5),
        "lam_mix": jax.random.beta(klam1, 0.8, 0.8),
        "lam_cut": jax.random.beta(klam2, 1.0, 1.0),
        "cy": jax.random.randint(ky, (), 0, H),
        "cx": jax.random.randint(kx, (), 0, W)}.items()}


@pytest.mark.parametrize("seed,prob", [(0, 1.0), (1, 1.0), (2, 1.0),
                                       (3, 1.0), (4, 0.0)])
def test_mixup_cutmix_matches_jax(seed, prob):
    """Soft targets within 1e-6 and the mixed video within 1e-5, for
    seeds that take mixup and cutmix (each one's branch is asserted over
    the set) and with mixing off."""
    video = (_video(b=6, h=16, w=20, seed=seed) / 255.0 - 0.45) / 0.225
    labels = np.array([0, 3, 1, 4, 2, 3])
    key = jax.random.PRNGKey(20 + seed)
    params = _mixup_draws(key, 16, 20, prob)
    want_v, want_t = JA.mixup_cutmix(jnp.asarray(video), jnp.asarray(labels),
                                     key, num_classes=5, prob=prob)
    got_v, got_t = A.apply_mixup_cutmix(torch.from_numpy(video),
                                        torch.from_numpy(labels), params,
                                        num_classes=5)
    assert got_t.dtype == torch.float32 and got_t.shape == (6, 5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_t.sum(-1).numpy(), 1.0, atol=1e-6)


def test_mixup_seeds_take_both_branches():
    cut = [bool(_mixup_draws(jax.random.PRNGKey(20 + s), 16, 20,
                             1.0)["use_cutmix"]) for s in range(4)]
    assert any(cut) and not all(cut), cut


def test_train_augment_cls_shapes_and_reproducible():
    """Shapes and dtypes, seeded reproducibility, targets summing to one,
    one-hot targets with mixing off, and the mixing draws as 0-dim
    tensors (chip_smoke.py phase 16 runs the pipeline on the card under
    torch.cuda's sync debug mode, which raises on a host read)."""
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (16, 2, 24, 40, 3), dtype=np.uint8))
    labels = torch.arange(16) % 5
    kw = dict(crop_size=16, num_classes=5, reprob=0.25, dtype=torch.bfloat16)
    x, t = A.train_augment_cls(u8, labels, torch.Generator().manual_seed(1),
                               **kw)
    assert x.shape == (16, 2, 16, 16, 3) and x.dtype == torch.bfloat16
    assert t.shape == (16, 5) and t.dtype == torch.float32
    assert torch.isfinite(x.float()).all()
    np.testing.assert_allclose(t.sum(-1).numpy(), 1.0, atol=1e-6)
    x2, t2 = A.train_augment_cls(u8, labels,
                                 torch.Generator().manual_seed(1), **kw)
    assert torch.equal(x, x2) and torch.equal(t, t2)
    # mixing off: one-hot targets without smoothing, as the JAX CLI
    _, t3 = A.train_augment_cls(u8, labels, torch.Generator().manual_seed(1),
                                **{**kw, "mixup": 0.0, "cutmix": 0.0})
    assert torch.equal(t3, torch.nn.functional.one_hot(labels, 5).float())
    params = A.draw_mixup_cutmix(x, torch.Generator().manual_seed(2))
    assert all(torch.is_tensor(v) and v.ndim == 0 for v in params.values())
