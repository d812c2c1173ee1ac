"""The port's training diagnostics (simple_tad_tpu_torch/utils/diagnostics.py)
against the JAX package's: grad_norm_summary on the same gradients
(seeded, converted to the JAX tree with to_jax_params) within 1e-6
relative, for the ViT, InternVideo2 and the distillation student; the
npz the accumulator writes (keys, shapes, the summed values); the
summary in the train step's metrics and from the finetune CLI's
``--grad_norm_heads``; device_memory_stats and profile_trace on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.utils import diagnostics as jax_diag
from simple_tad_tpu_torch.utils import diagnostics as D
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)


def _named_grads(kind, seed=0):
    """Seeded gradients named as the port's parameters, and the heads."""
    if kind == "vit":
        from simple_tad_tpu_torch.models.vit import (ViTConfig,
                                                     VisionTransformer)
        model = VisionTransformer(ViTConfig(
            img_size=32, all_frames=4, embed_dim=128, depth=3, num_heads=4,
            num_classes=2, param_dtype=torch.float32), device="cpu")
        heads = 4
    elif kind == "iv2":
        from simple_tad_tpu_torch.models.internvideo2 import (IV2Config,
                                                              InternVideo2)
        model = InternVideo2(IV2Config(
            img_size=28, patch_size=14, embed_dim=96, depth=2, num_heads=3,
            num_frames=2, attn_pool_num_heads=2, clip_embed_dim=32,
            num_classes=2, param_dtype=torch.float32), device="cpu")
        heads = 3
    else:
        from simple_tad_tpu_torch.models.iv2_distill import (
            DistillInternVideo2, DistillIV2Config)
        model = DistillInternVideo2(DistillIV2Config(
            img_size=28, patch_size=14, num_frames=2, embed_dim=128, depth=3,
            num_heads=2, attn_pool_num_heads=2, clip_embed_dim=32,
            clip_teacher_embed_dim=64, clip_teacher_final_dim=32,
            clip_return_layer=2, param_dtype=torch.float32), device="cpu")
        heads = 2
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)) for n, p in model.named_parameters()}, heads


@pytest.mark.parametrize("kind", ["vit", "iv2", "distill"])
def test_grad_norm_summary_matches_jax(kind):
    grads, heads = _named_grads(kind)
    want = jax_diag.grad_norm_summary(
        jax.tree_util.tree_map(jnp.asarray, tc.to_jax_params(grads)), heads)
    got = D.grad_norm_summary(grads, heads)
    assert sorted(got) == sorted(want)
    keys = {"vit": ["fc1", "fc2", "patch_embed", "proj", "qkv"],
            "iv2": ["proj", "qkv"],
            "distill": ["patch_embed", "proj", "qkv"]}[kind]
    assert sorted(got) == keys
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert v.shape == np.shape(want[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_accumulator_writes_the_npz(tmp_path):
    grads, heads = _named_grads("vit")
    acc = D.GradNormAccumulator(str(tmp_path), heads)
    sums = {}
    for seed in range(3):
        s = D.grad_norm_summary(_named_grads("vit", seed)[0], heads)
        acc.update(s)
        for k, v in s.items():
            sums[k] = sums.get(k, 0.0) + v.double().numpy()
    path = acc.save_epoch(5)
    assert path == os.path.join(str(tmp_path), "grad_norms",
                                "gradnorm_ep5.npz")
    with np.load(path) as f:
        assert sorted(f.files) == ["count", "fc1", "fc2", "patch_embed",
                                   "proj", "qkv"]
        assert int(f["count"]) == 3
        assert f["qkv"].shape == (3, 4, 3) and f["proj"].shape == (3,)
        assert f["fc1"].shape == f["fc2"].shape == (3,)
        assert f["patch_embed"].shape == ()
        for k, v in sums.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12)
    assert acc.count == 0 and acc.save_epoch(6) is None
    assert D.GradNormAccumulator(None, heads).save_epoch(0) is None


def test_step_metrics_and_cli_write_grad_norms(tmp_path):
    """The train step's metrics['grad_norms'] is the summary of the
    step's gradients; the finetune CLI with --grad_norm_heads writes one
    npz an epoch."""
    from simple_tad_tpu_torch.cli.finetune import main
    from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from simple_tad_tpu_torch.train import losses as L
    from simple_tad_tpu_torch.train import optim as O
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    from tests.fixtures import make_synthetic_dota_full
    model = VisionTransformer(ViTConfig(
        img_size=32, all_frames=4, embed_dim=64, depth=2, num_heads=2,
        num_classes=2, param_dtype=torch.float32), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=0.0)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(1))
    seen = {}
    step = make_finetune_train_step(L.create_criterion("crossentropy"),
                                    grad_norm_heads=2)
    orig = opt.step

    def capture():
        seen.update({n: p.grad.clone() for n, p in opt.params.items()})
        return orig()
    opt.step = capture
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    metrics, _ = step(state, {"video": x, "label": torch.tensor([0, 1])})
    want = D.grad_norm_summary(seen, 2)
    assert sorted(metrics["grad_norms"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(metrics["grad_norms"][k], v), k

    root = make_synthetic_dota_full(str(tmp_path / "data"), n_clips=2,
                                    frames_per_clip=24, h=48, w=64)
    out = str(tmp_path / "run")
    main(["--data_set", "DoTA", "--data_path", root, "--model",
          "vit_small_patch16_224", "--input_size", "32", "--num_frames",
          "16", "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "0",
          "--output_dir", out, "--dtype", "float32", "--num_workers", "2",
          "--device", "cpu", "--grad_norm_heads", "6"])
    with np.load(os.path.join(out, "grad_norms", "gradnorm_ep0.npz")) as f:
        assert int(f["count"]) > 0
        assert f["qkv"].shape == (12, 6, 3)


def test_device_memory_stats_and_profile_trace_on_the_cpu(tmp_path):
    assert D.device_memory_stats() == {"cpu": {}}
    with D.profile_trace(None) as prof:
        assert prof is None
    with D.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
