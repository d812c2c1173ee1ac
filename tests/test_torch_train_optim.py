"""The port's criteria, schedules and optimizer trees
(simple_tad_tpu_torch.train.losses, .optim) against the JAX package's, on
seeded inputs.  Tolerances: losses 1e-6 relative (fp32, the same
formulas); schedules exact (the same numpy code); masks and layer scales
exact, leaf by leaf through to_jax_params.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.utils import torch_convert as tc

TINY = dict(img_size=32, all_frames=4, embed_dim=128, depth=3, num_heads=2,
            num_classes=2, init_values=0.1)
CRITERIA = ["crossentropy", "focal", "focal6x100", "focal2_6", "focal2_2",
            "2bce", "smoothap", "exponential1"]


def _batch(seed=0, n=32):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, 2)).astype(np.float32) * 2
    labels = rng.integers(0, 2, n).astype(np.int32)
    ttc = np.where(rng.random(n) < 0.5, rng.uniform(-2, 1, n),
                   -100.0).astype(np.float32)
    smoothed = rng.random((n, 2)).astype(np.float32)
    return logits, labels, smoothed / smoothed.sum(-1, keepdims=True), ttc


@pytest.mark.parametrize("name", CRITERIA + ["crossentropy_smoothing"])
def test_criterion_matches_jax(name):
    smoothing = 0.1 if name.endswith("_smoothing") else 0.0
    name = name.replace("_smoothing", "")
    logits, labels, smoothed, ttc = _batch()
    want = JL.create_criterion(name, smoothing)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(smoothed),
        jnp.asarray(ttc))
    got = L.create_criterion(name, smoothing)(
        torch.from_numpy(logits), torch.from_numpy(labels).long(),
        torch.from_numpy(smoothed), torch.from_numpy(ttc))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-7)


def test_soft_target_cross_entropy_and_unknown_criterion():
    logits, _, smoothed, _ = _batch(1)
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(smoothed))
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(smoothed))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        L.create_criterion("nope")


@pytest.mark.parametrize("args", [
    (1e-3, 1e-6, 10, 50, 2, 0.0, -1), (5e-4, 1e-6, 3, 7, 0, 0.0, -1),
    (1e-3, 1e-5, 4, 10, 1, 1e-6, 15), (0.05, 0.05, 2, 5, 0, 0.0, -1)])
def test_cosine_scheduler_matches_jax(args):
    np.testing.assert_array_equal(O.cosine_scheduler(*args),
                                  JO.cosine_scheduler(*args))
    sched = JO.cosine_scheduler(*args)
    fn, jfn = O.array_schedule(sched), JO.array_schedule(sched)
    for step in (0, 1, len(sched) - 1, len(sched) + 5):
        assert fn(step) == float(jfn(step))
    assert O.scale_lr_by_batch(5e-4, 56) == JO.scale_lr_by_batch(5e-4, 56)


def _trees():
    """JAX params of a tiny ViT, and the port model's parameters."""
    params = JaxViT(JaxViTConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    model = VisionTransformer(ViTConfig(**TINY, param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(tc.from_jax_params(params))
    return params, dict(model.named_parameters())


def _as_tree(values, named):
    """{name: scalar} -> the JAX tree of per-leaf arrays (broadcast over
    each leaf, blocks stacked on the depth axis)."""
    return tc.to_jax_params({n: torch.full_like(p, float(values[n]))
                             for n, p in named.items()})


def _expand(jax_tree, params):
    return jax.tree_util.tree_map(
        lambda m, p: np.broadcast_to(np.asarray(m, np.float32), p.shape),
        jax_tree, params)


def _assert_trees_equal(got, want):
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


def test_weight_decay_mask_matches_jax():
    params, named = _trees()
    got = _as_tree(O.weight_decay_mask(named.items()), named)
    _assert_trees_equal(got, _expand(JO.weight_decay_mask(params), params))


@pytest.mark.parametrize("decay", [0.6, 0.75])
def test_layer_scale_tree_matches_jax(decay):
    params, named = _trees()
    got = _as_tree(O.layer_scale_tree(named, decay, 3), named)
    _assert_trees_equal(got, _expand(JO.layer_scale_tree(params, decay, 3),
                                     params))


@pytest.mark.parametrize("spec", ["first N blocks;2", "probe;1;0"])
def test_freeze_mask_tree_matches_jax(spec):
    params, named = _trees()
    got = _as_tree(O.freeze_mask_tree(named, spec, 3), named)
    _assert_trees_equal(got, _expand(JO.freeze_mask_tree(params, spec, 3),
                                     params))


def test_unported_optimizers_raise():
    """Every name of the optimizer menu is ported now (held to optax in
    tests/test_torch_optim_menu.py): each builds, in any case; a name off
    the menu still raises."""
    _, named = _trees()
    for name in O.OPTIMIZER_MENU + ("AdamW", "LAMB"):
        assert O.FinetuneOptimizer(named, lr_schedule=1e-3,
                                   opt=name).opt == name.lower()
    with pytest.raises(ValueError, match="unknown optimizer"):
        O.FinetuneOptimizer(named, lr_schedule=1e-3, opt="nope")