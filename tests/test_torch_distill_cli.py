"""The port's distillation CLI (simple_tad_tpu_torch.cli.distill) end to end
on the CPU: one epoch of each objective on the synthetic fixtures, with
the full-width trunks the JAX package's own CLI tests use, cut to 28 x 28
(InternVideo2, 4 frames) or 32 x 32 (ViT, 16 frames), fp32, drop path 0:
``masked_feature`` with the ``attention`` mask (IV2-S student and teacher
on make_synthetic_k700), ``feature`` with the Linear aligner (ViT-S
student, ViT-B teacher on make_synthetic_dota) and ``logit_kd`` (ViT-S
both, on make_synthetic_dota).  The first step's loss is held to the JAX
CLI's step maker (make_masked_distill_step, make_feature_distill_step,
make_distill_step) on the same batch, weights and (for the attention
mask) Gumbel noise, within 1e-5 relative.  Each run writes
checkpoint-0.pth, which loads back into the student; the test deletes it.
AdamW takes the JAX CLI's betas and eps, or ``--opt_betas`` / ``--opt_eps``.
"""

import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.cli import distill as jax_distill
from simple_tad_tpu.models import create_model as jax_create_model
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu_torch.train import distill as D
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)


@pytest.fixture(scope="module")
def k700_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_k700
    return make_synthetic_k700(str(tmp_path_factory.mktemp("k700")),
                               n_videos=4, frames_per_video=40, fps=30.0,
                               h=48, w=64)


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_dota
    return make_synthetic_dota(str(tmp_path_factory.mktemp("dota")),
                               split="train_split.txt", prefix="train",
                               n_clips=2, frames_per_clip=24, h=48, w=64)


def _record(monkeypatch, maker_name):
    """Wrap train.distill's ``maker_name`` so that the first step's
    weights, batch, metrics and (attention mask) Gumbel noise are kept."""
    rec = {}
    real = getattr(D, maker_name)

    def maker(teacher, **kw):
        step = real(teacher, **kw)
        rec.update(teacher=teacher, kw=kw)

        def recorded(state, batch):
            if "batch" not in rec:
                rec["params"] = {k: v.detach().clone() for k, v in
                                 state.model.state_dict().items()}
                rec["batch"] = {k: v.clone() for k, v in batch.items()}
                if maker_name == "make_masked_distill_step":
                    g = state.generator.get_state()
                    rec["gumbel"] = D.gumbel_noise(
                        (batch["video"].shape[0],
                         state.model.cfg.num_patches), state.generator,
                        "cpu")
                    state.generator.set_state(g)
            metrics = step(state, batch)
            rec.setdefault("metrics", metrics)
            return metrics
        return recorded

    monkeypatch.setattr(D, maker_name, maker)
    return rec


def _run(args, out):
    from simple_tad_tpu_torch.cli.distill import main
    state = main(args + ["--epochs", "1", "--warmup_epochs", "0",
                         "--output_dir", out, "--dtype", "float32",
                         "--num_workers", "2", "--device", "cpu"])
    assert state.step > 0
    return state


def _checkpoint_loads_back(out, model):
    """checkpoint-0.pth holds the student's weights and loads into a fresh
    copy of it; then it is deleted (it is 100-400 MB)."""
    paths = glob.glob(os.path.join(out, "checkpoint-*.pth"))
    assert [os.path.basename(p) for p in paths] == ["checkpoint-0.pth"]
    try:
        saved = torch.load(paths[0], weights_only=False)["model"]
        own = model.state_dict()
        assert set(saved) == set(own)
        for k, v in own.items():
            assert torch.equal(saved[k], v), k
    finally:
        for p in paths:
            os.remove(p)


def _jax_loss(step, params, batch, t_params):
    state = JaxTrainState.create(params, optax.sgd(0.0),
                                 jax.random.PRNGKey(0))
    _, (metrics, _) = step(state, batch, t_params)
    return float(metrics["loss"])


def test_masked_feature_attention_one_epoch(k700_root, tmp_path,
                                            monkeypatch):
    rec = _record(monkeypatch, "make_masked_distill_step")
    out = str(tmp_path / "md")
    state = _run(["--objective", "masked_feature", "--mask_type",
                  "attention", "--mask_ratio", "0.75", "--data_set", "K700",
                  "--data_path", k700_root,
                  "--model", "distill_internvideo2_small_patch14_224",
                  "--teacher_model", "internvideo2_small_patch14_224",
                  "--clip_return_layer", "2",
                  "--clip_teacher_return_interval", "2",
                  "--clip_teacher_final_dim", "768", "--drop_path", "0",
                  "--input_size", "28", "--num_frames", "4",
                  "--view_fps", "10", "--batch_size", "2"], out)
    assert rec["kw"]["teacher_taps"] == (9, 11)
    assert rec["kw"]["num_masked"] == 12
    opt = state.optimizer               # the JAX CLI's AdamW settings
    assert (opt.b1, opt.b2, opt.eps) == (0.9, 0.999, 1e-8)
    _checkpoint_loads_back(out, state.model)

    common = dict(num_classes=2, all_frames=4, img_size=28,
                  dtype=jnp.float32, attn_impl="xla")
    teacher = jax_create_model("internvideo2_small_patch14_224", **common)
    student = jax_create_model(
        "distill_internvideo2_small_patch14_224", **common,
        drop_path_rate=0.0, clip_teacher_embed_dim=384,
        clip_teacher_final_dim=768, clip_return_layer=2)
    step = jax_distill.make_masked_distill_step(
        student, teacher, optax.sgd(0.0), num_masked=12,
        teacher_taps=(9, 11), mask_type="attention")
    noise = jnp.asarray(rec["gumbel"].numpy())
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=None: noise)
    want = _jax_loss(step, tc.to_jax_params(rec["params"]),
                     {"video": jnp.asarray(rec["batch"]["video"].numpy()),
                      "mask": jnp.asarray(rec["batch"]["mask"].numpy())},
                     tc.to_jax_params(rec["teacher"].state_dict()))
    np.testing.assert_allclose(float(rec["metrics"]["loss"]), want,
                               rtol=1e-5)


def _vit_args(root, objective, student, teacher):
    return ["--objective", objective, "--data_set", "DoTA", "--data_path",
            root, "--model", student, "--teacher_model", teacher,
            "--input_size", "32", "--num_frames", "16", "--batch_size", "2"]


def test_feature_with_aligner_one_epoch(dota_root, tmp_path, monkeypatch):
    rec = _record(monkeypatch, "make_feature_distill_step")
    out = str(tmp_path / "fd")
    state = _run(_vit_args(dota_root, "feature", "vit_small_patch16_224",
                           "vit_base_patch16_224"), out)
    assert isinstance(state.model, D.FeatureStudent)
    assert state.model.aligner.weight.shape == (768, 384)
    _checkpoint_loads_back(out, state.model)

    common = dict(num_classes=2, all_frames=16, img_size=32,
                  dtype=jnp.float32, attn_impl="xla")
    import flax.linen as jnn
    aligner = jnn.Dense(768, dtype=jnp.float32)
    step = jax_distill.make_feature_distill_step(
        jax_create_model("vit_small_patch16_224", **common),
        jax_create_model("vit_base_patch16_224", **common), aligner,
        optax.sgd(0.0))
    p = rec["params"]
    params = {"student": tc.to_jax_params(
        {k[len("student."):]: v for k, v in p.items()
         if k.startswith("student.")}),
        "aligner": {"kernel": p["aligner.weight"].numpy().T,
                    "bias": p["aligner.bias"].numpy()}}
    want = _jax_loss(step, params,
                     {"video": jnp.asarray(rec["batch"]["video"].numpy())},
                     tc.to_jax_params(rec["teacher"].state_dict()))
    np.testing.assert_allclose(float(rec["metrics"]["loss"]), want,
                               rtol=1e-5)


def test_logit_kd_one_epoch(dota_root, tmp_path, monkeypatch):
    rec = _record(monkeypatch, "make_distill_step")
    out = str(tmp_path / "kd")
    state = _run(_vit_args(dota_root, "logit_kd", "vit_small_patch16_224",
                           "vit_small_patch16_224")
                 + ["--opt_betas", "0.9", "0.98", "--opt_eps", "1e-6"], out)
    opt = state.optimizer               # the reference recipe's, as asked
    assert (opt.b1, opt.b2, opt.eps) == (0.9, 0.98, 1e-6)
    _checkpoint_loads_back(out, state.model)
    common = dict(num_classes=2, all_frames=16, img_size=32,
                  dtype=jnp.float32, attn_impl="xla")
    vit_s = jax_create_model("vit_small_patch16_224", **common)
    step = jax_distill.make_distill_step(vit_s, vit_s, optax.sgd(0.0),
                                         alpha=0.5, temperature=2.0)
    want = _jax_loss(step, tc.to_jax_params(rec["params"]),
                     {"video": jnp.asarray(rec["batch"]["video"].numpy()),
                      "label": jnp.asarray(rec["batch"]["label"].numpy())},
                     tc.to_jax_params(rec["teacher"].state_dict()))
    np.testing.assert_allclose(float(rec["metrics"]["loss"]), want,
                               rtol=1e-5)


def test_masked_feature_rejects_mismatched_setups(k700_root, dota_root,
                                                  tmp_path):
    from simple_tad_tpu_torch.cli.distill import main
    base = ["--objective", "masked_feature", "--input_size", "28",
            "--num_frames", "4", "--dtype", "float32", "--device", "cpu",
            "--teacher_model", "internvideo2_small_patch14_224"]
    with pytest.raises(ValueError, match="distill_"):
        main(base + ["--data_set", "K700", "--data_path", k700_root,
                     "--model", "internvideo2_small_patch14_224"])
    with pytest.raises(ValueError, match="clip_teacher_final_dim"):
        main(base + ["--data_set", "K700", "--data_path", k700_root,
                     "--model", "distill_internvideo2_small_patch14_224",
                     "--clip_teacher_final_dim", "512"])
    with pytest.raises(ValueError, match="Kinetics"):
        main(base + ["--data_set", "DoTA", "--data_path", dota_root,
                     "--model", "distill_internvideo2_small_patch14_224"])
