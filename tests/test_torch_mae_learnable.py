"""PretrainVideoMAE with its learnable encoder position table
(``use_learnable_pos_emb=True``; the JAX package's ``encoder_pos_embed``)
against the JAX model and MAE step on carried-across weights, on CPU, and
its ``.pth`` round trip.

Tolerances (fp32): predictions within 1e-4 (ROADMAP.md's slice gate);
the step's loss within 1e-5 relative, every gradient leaf (the table's
among them) within 1e-4 of the leaf's largest magnitude, the parameters
and Adam moments after the step within 1e-5, as tests/test_torch_mae.py
holds the fixed-table model; the round trip bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models import mae as jax_mae
from simple_tad_tpu.ops.image import IMAGENET_MEAN, IMAGENET_STD
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_mae_train_step as jax_mae_step
from simple_tad_tpu_torch.models import mae
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import TrainState, make_mae_train_step
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_mae import TINY, B, _jax_params, _masks, _port
from tests.test_torch_train_step import (_adam_moments, _tree_close,
                                         pallas)  # noqa: F401
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

LEARNABLE = dict(TINY, use_learnable_pos_emb=True, init_values=0.1)


def test_table_is_a_parameter_not_a_buffer():
    model = mae.PretrainVideoMAE(mae.MAEConfig(**LEARNABLE), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert names["encoder_pos_embed"].shape == (1, 8, 128)
    assert "encoder.pos_embed" not in model.state_dict()
    table = names["encoder_pos_embed"]
    assert 0.005 < float(table.std()) < 0.04          # trunc-normal 0.02
    assert float(table.abs().max()) <= 0.04


def test_predictions_match_jax():
    params = _jax_params(LEARNABLE)
    assert params["encoder_pos_embed"].shape == (1, 8, 128)
    model = _port(params, LEARNABLE).eval()
    video = np.random.default_rng(4).standard_normal(
        (B, 4, 32, 32, 3)).astype(np.float32)
    mask, nm = _masks(5)
    want = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**LEARNABLE)).apply(
        {"params": params}, jnp.asarray(video), jnp.asarray(mask), nm)
    with torch.inference_mode():
        got = model(torch.from_numpy(video), torch.from_numpy(mask), nm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    _tree_close(tc.to_jax_params(model.state_dict()), params, 0.0,
                "round trip")


def test_mae_step_matches_jax(pallas):
    """One step's loss and every gradient leaf (the table's among them),
    then the parameters and Adam moments, against make_mae_train_step with
    the CLI's AdamW (betas 0.9 / 0.95, weight decay 0.05, which both
    packages apply to the table)."""
    params = _jax_params(LEARNABLE, seed=1)
    rng = np.random.default_rng(6)
    mask, nm = _masks(7)
    batch = {"video": rng.standard_normal((B, 4, 32, 32, 3)).astype(
        np.float32), "mask": mask}
    lr = JO.cosine_scheduler(1.5e-4, 1e-5, 1, 4)
    wd = JO.cosine_scheduler(0.05, 0.05, 1, 4)
    kw = dict(weight_decay=0.05, betas=(0.9, 0.95))
    jm = jax_mae.PretrainVideoMAE(jax_mae.MAEConfig(**LEARNABLE))
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd), **kw)
    jstep = jax_mae_step(jm, tx, num_masked=nm, donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    model = _port(params, LEARNABLE, param_dtype=torch.float32)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(lr),
                              wd_schedule=O.array_schedule(wd), **kw)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))

    def jax_loss(p):
        targets = jax_mae.mae_targets_fused(
            jnp.asarray(batch["video"]), jnp.asarray(mask), nm,
            mean=jnp.asarray(IMAGENET_MEAN), std=jnp.asarray(IMAGENET_STD))
        pred = jm.apply({"params": p}, jnp.asarray(batch["video"]),
                        jnp.asarray(mask), nm)
        return jnp.mean(jnp.square(pred - targets))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jstate.params)
    jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    m = make_mae_train_step(num_masked=nm)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    grads = tc.to_jax_params({n: p.grad for n, p in
                              model.named_parameters()})
    assert float(np.abs(grads["encoder_pos_embed"]).max()) > 0
    _tree_close(grads, want_grads, 1e-4, "grad")
    _tree_close(tc.to_jax_params(model.state_dict()), jstate.params, 1e-5,
                "params after the step")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")


@pytest.mark.parametrize("key", ["encoder.pos_embed", "encoder_pos_embed"])
def test_pth_round_trip(tmp_path, key):
    """A .pth with the table under the reference's name (or the port's)
    loads into a learnable model (load_mae_checkpoint) and gives the same
    predictions as the model it came from; a fixed-table model ignores
    it."""
    src = mae.PretrainVideoMAE(mae.MAEConfig(**LEARNABLE), device="cpu")
    src.init_weights(torch.Generator().manual_seed(3)).eval()
    sd = dict(src.state_dict())
    sd[key] = sd.pop("encoder_pos_embed")
    path = str(tmp_path / "mae.pth")
    torch.save({"model": sd}, path)
    dst = mae.PretrainVideoMAE(mae.MAEConfig(**LEARNABLE), device="cpu")
    dst.init_weights(torch.Generator().manual_seed(4)).eval()
    loaded = tc.load_checkpoint_auto(path, dst)
    assert "encoder_pos_embed" in loaded
    assert set(loaded) == set(dst.state_dict())
    for name, t in src.state_dict().items():
        assert torch.equal(t, dst.state_dict()[name]), name
    video = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 4, 32, 32, 3)).astype(np.float32))
    mask, nm = _masks(9)
    with torch.inference_mode():
        assert torch.equal(src(video, torch.from_numpy(mask), nm),
                           dst(video, torch.from_numpy(mask), nm))
    fixed = mae.PretrainVideoMAE(mae.MAEConfig(**TINY), device="cpu")
    assert "encoder_pos_embed" not in tc.load_checkpoint_auto(path, fixed)
