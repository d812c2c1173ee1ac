"""Port evaluation path (FrameEvaluator, the CLIs, streaming) against the
JAX package on the synthetic DoTA fixture (3 clips x 40 frames), with a
tiny fp32 model.

Tolerances: logits within 1e-4 (ROADMAP.md's slice gate); AUROC, AP and
AUC-MCC within 1e-6; the clip, filename, label and ttc columns identical.
"""

import csv
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_tad_tpu.data.frame_datasets import FrameDataset as JaxFrameDataset
from simple_tad_tpu.data.frame_datasets import read_dota_clips as jax_read
from simple_tad_tpu.eval.engine import FrameEvaluator as JaxFrameEvaluator
from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu_torch.cli.inference import StreamingScorer
from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dota_clips)
from simple_tad_tpu_torch.eval.engine import FrameEvaluator
from simple_tad_tpu_torch.models import create_model
from tests.fixtures import make_synthetic_dota
from tests.test_torch_vit import (TINY, drop_checkpoints,  # noqa: F401
                                   one_torch_thread,
                                   perturbed_jax_params, port_model_from)


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota")
    return make_synthetic_dota(str(root), n_clips=3, frames_per_clip=40,
                               h=72, w=128)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxViTConfig(**TINY)
    params = perturbed_jax_params(jcfg, seed=5)
    return JaxViT(jcfg), params, port_model_from(params, **TINY)


def _dataset(cls, read, root, target_fps=10):
    return cls(read(root, "val_split.txt"), mode="test", view_len=16,
               target_fps=target_fps, orig_fps=10, view_step=1, crop_size=32)


def test_evaluate_matches_jax(dota_root, models, tmp_path):
    jm, params, model = models
    jres = JaxFrameEvaluator(jm, params, batch_size=8, frame_bucket=64,
                             dtype=jnp.float32, resize_on_host=True
                             ).evaluate(_dataset(JaxFrameDataset, jax_read,
                                                 dota_root))
    res = FrameEvaluator(model, device="cpu", batch_size=8,
                         resize_on_host=True).evaluate(
                             _dataset(FrameDataset, read_dota_clips,
                                      dota_root))
    assert res.n_windows == jres.n_windows == 75
    for col in ("clip", "filename", "label", "ttc"):
        assert res.rows[col] == jres.rows[col].tolist(), col
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_allclose(res.rows[col], jres.rows[col].to_numpy(),
                                   atol=1e-4)
    for key in ("auroc", "ap", "mcc_auc"):
        assert abs(getattr(res.metrics, key)
                   - getattr(jres.metrics, key)) <= 1e-6, key


@pytest.mark.parametrize("target_fps", [10, 5])
def test_token_path_matches_pixel_path(dota_root, models, target_fps):
    model = models[2]
    ds = _dataset(FrameDataset, read_dota_clips, dota_root, target_fps)
    view = ds.clip_eval_views()[1]
    pix = FrameEvaluator(model, device="cpu", batch_size=8,
                         precompute_tubelets=False).score_view(ds, view)
    tok = FrameEvaluator(model, device="cpu", batch_size=8,
                         precompute_tubelets=True).score_view(ds, view)
    np.testing.assert_allclose(tok, pix, atol=1e-5)


def test_chunking_invariant(dota_root, models):
    model = models[2]
    ds = _dataset(FrameDataset, read_dota_clips, dota_root)
    view = ds.clip_eval_views()[0]
    a = FrameEvaluator(model, device="cpu", batch_size=25).score_view(ds, view)
    b = FrameEvaluator(model, device="cpu", batch_size=7).score_view(ds, view)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_eval_cli_writes_jax_columns_and_keys(dota_root, tmp_path):
    from simple_tad_tpu.cli.eval_frames import main as jax_main
    from simple_tad_tpu_torch.cli.eval_frames import main
    args = ["--data_set", "DoTA", "--data_path", dota_root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--num_frames", "16", "--batch_size", "8", "--dtype", "float32"]
    main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_main(args + ["--output_dir", str(tmp_path / "jax"),
                     "--attn_impl", "naive"])

    def read(d):
        with open(tmp_path / d / "predictions.csv", newline="") as f:
            rows = list(csv.reader(f))
        with open(tmp_path / d / "stats.txt") as f:
            keys = [line.split(":")[0] for line in f]
        return rows, keys

    rows, keys = read("port")
    jrows, jkeys = read("jax")
    assert rows[0] == jrows[0] == ["clip", "filename", "logits_safe",
                                   "logits_risk", "label", "ttc"]
    assert keys == jkeys
    assert len(rows) == len(jrows) == 76
    for c in (0, 1, 4, 5):      # clip, filename, label, ttc
        assert [r[c] for r in rows] == [r[c] for r in jrows]


def test_eval_cli_rejects_unported_options(dota_root):
    """--dist_eval is not ported (--quant8 is: tests/test_torch_quant_vit.py
    runs it); an unknown --quant8_mode is refused."""
    from simple_tad_tpu_torch.cli.eval_frames import main
    base = ["--data_path", dota_root, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(base + ["--dist_eval"])
    with pytest.raises(ValueError, match="quant8_mode"):
        main(base + ["--input_size", "32", "--quant8",
                     "--quant8_mode", "fp8"])


def test_streaming_step_matches_batched_windows(models):
    model = models[2]
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.integers(0, 256, (21, 32, 32, 3), np.uint8))
    scorer = StreamingScorer(model)
    window, stream = frames[:16], []
    for i in range(16, 21):
        window, risk = scorer.step(window, frames[i])
        stream.append(float(risk))
    idx = torch.stack([torch.arange(s, s + 16) for s in range(1, 6)])
    batched = scorer.score_windows(frames, idx)
    np.testing.assert_allclose(stream, batched.numpy(), atol=1e-6)


def test_inference_cli_stream_and_batched_agree(dota_root, tmp_path):
    from simple_tad_tpu_torch.cli.inference import main
    frames_dir = tmp_path / "frames"
    with zipfile.ZipFile(os.path.join(dota_root, "frames", "clip_001",
                                      "images.zip")) as z:
        z.extractall(frames_dir)
    model = create_model("vit_small_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(3),
                         img_size=32, init_scale=1.0)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"model": model.state_dict()}, ckpt)
    args = ["--ckpt", ckpt, "--frames_folder", str(frames_dir),
            "--input_size", "32", "--dtype", "float32", "--device", "cpu"]
    stream = main(args + ["--output_csv", str(tmp_path / "risk.csv")])
    batched = main(args + ["--batched"])
    assert len(stream) == 24 and len(batched) == 25
    assert [p for p, _ in stream] == [p for p, _ in batched[1:]]
    np.testing.assert_allclose([r for _, r in stream],
                               [r for _, r in batched[1:]], atol=1e-6)
    with open(tmp_path / "risk.csv") as f:
        assert next(csv.reader(f)) == ["frame", "risk"]
