"""Port InternVideo2 serving (FrameEvaluator, both CLIs, streaming) against
the JAX package on the synthetic DoTA fixture (3 clips x 40 frames), with
the tiny fp32 IV2 of tests/test_torch_iv2.py at the DoTA job's view
setting (--view_fps 5: windows of every other frame).

Tolerances: logits within 1e-4 (ROADMAP.md's slice gate) for bf16/fp32
serving; AUROC and AP within 1e-6; the clip, filename, label and ttc
columns identical.  Static int8: logits within 2e-3.  The calibration's
and the token embedding's fp32 sums run in another order than the JAX
package's, which moves a value at a rounding boundary to the other int8
code (ROADMAP.md F2); one flipped code moves a logit by ~1e-3 at this
size.  Read: 1.08e-3 on 2 of 102 windows (max |logit| 0.24), the
calibrated absmax within 2.6e-3 relative; served with the JAX evaluator's
own absmax, 5.3e-4.  Such a logit can carry its window across a bin of
the metrics' fixed threshold grid (the binned AUROC then moved by 4.8e-3
with another intra-op thread count), so the int8 AUROC and AP are held
within 1e-6 to the JAX package's binary_metrics of the port's own
probabilities.
"""

import csv
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.data.frame_datasets import FrameDataset as JaxFrameDataset
from simple_tad_tpu.data.frame_datasets import read_dota_clips as jax_read
from simple_tad_tpu.eval.engine import FrameEvaluator as JaxFrameEvaluator
from simple_tad_tpu.eval.metrics import binary_metrics as jax_binary_metrics
from simple_tad_tpu_torch.cli.inference import StreamingScorer
from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dota_clips)
from simple_tad_tpu_torch.eval.engine import FrameEvaluator
from simple_tad_tpu_torch.models import create_model
from tests.fixtures import make_synthetic_dota
from tests.test_torch_iv2 import (jax_iv2, perturbed_iv2_params,
                                  port_iv2_from)
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota_iv2")
    return make_synthetic_dota(str(root), n_clips=3, frames_per_clip=40,
                               h=72, w=128)


@pytest.fixture(scope="module")
def params():
    return perturbed_iv2_params(seed=8)


def _dataset(cls, read, root):
    return cls(read(root, "val_split.txt"), mode="test", view_len=4,
               target_fps=5, orig_fps=10, view_step=1, crop_size=28)


@pytest.mark.parametrize("quant8", [False, True])
def test_evaluate_matches_jax(quant8, dota_root, params, monkeypatch):
    """bf16/fp32 serving, and static int8 with the fused RMSNorm option
    (the JAX side with its int8 gates forced, kernels in interpret mode)."""
    kw = dict(quant8=True) if quant8 else {}
    if quant8:
        monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")
        monkeypatch.setenv("SIMPLE_TAD_FUSED_RMSQ", "force")
    with pltpu.force_tpu_interpret_mode():
        jres = JaxFrameEvaluator(
            jax_iv2(), params, batch_size=8, frame_bucket=64,
            dtype=jnp.float32, resize_on_host=True, **kw).evaluate(
                _dataset(JaxFrameDataset, jax_read, dota_root))
    ev = FrameEvaluator(port_iv2_from(params), device="cpu", batch_size=8,
                        resize_on_host=True, fused_rmsq=quant8, **kw)
    res = ev.evaluate(_dataset(FrameDataset, read_dota_clips, dota_root))
    assert ev.model.cfg.fused_rmsq == quant8
    assert res.n_windows == jres.n_windows == 102
    for col in ("clip", "filename", "label", "ttc"):
        assert res.rows[col] == jres.rows[col].tolist(), col
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_allclose(res.rows[col], jres.rows[col].to_numpy(),
                                   atol=2e-3 if quant8 else 1e-4)
    want = jres.metrics
    if quant8:
        logits = torch.tensor([res.rows["logits_safe"],
                               res.rows["logits_risk"]]).T
        want = jax_binary_metrics(torch.softmax(logits, dim=-1)[:, 1].numpy(),
                                  np.asarray(res.rows["label"]))
    for key in ("auroc", "ap"):
        assert abs(getattr(res.metrics, key) - getattr(want, key)) <= 1e-6, \
            key


def test_token_path_matches_pixel_path(dota_root, params):
    model = port_iv2_from(params)
    ds = _dataset(FrameDataset, read_dota_clips, dota_root)
    view = ds.clip_eval_views()[1]
    pix = FrameEvaluator(model, device="cpu", batch_size=8,
                         precompute_tubelets=False).score_view(ds, view)
    tok = FrameEvaluator(model, device="cpu", batch_size=8,
                         precompute_tubelets=True).score_view(ds, view)
    np.testing.assert_allclose(tok, pix, atol=1e-5)
    with pytest.raises(ValueError, match="fused_rmsq"):
        FrameEvaluator(model, device="cpu", fused_rmsq=True)


def _iv2_s_args(dota_root):
    return ["--data_set", "DoTA", "--data_path", dota_root,
            "--model", "internvideo2_small_patch14_224", "--input_size",
            "28", "--num_frames", "8", "--view_fps", "5", "--batch_size",
            "16", "--device", "cpu"]


def test_eval_cli_iv2(dota_root, tmp_path):
    """IV2-S at full width (12 layers, 384 wide) on 28x28 frames, the DoTA
    job's --num_frames 8 --view_fps 5: bf16 and static int8 with the fused
    RMSNorm->int8 option."""
    from simple_tad_tpu_torch.cli.eval_frames import main
    for name, extra in (("bf16", []), ("int8", ["--quant8", "--fused_rmsq",
                                                 "--dtype", "float32"])):
        out = tmp_path / name
        res = main(_iv2_s_args(dota_root) + extra + ["--output_dir",
                                                      str(out)])
        with open(out / "predictions.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert res.n_windows == len(rows) - 1 == 78
        logits = np.array([[float(r[2]), float(r[3])] for r in rows[1:]])
        assert np.isfinite(logits).all()


def test_inference_cli_iv2(dota_root, tmp_path):
    """IV2-S checkpoint through the streaming CLI: streaming and batched
    scoring agree window by window (fp32), and --quant8 --fused_rmsq
    serves."""
    from simple_tad_tpu_torch.cli.inference import main
    frames_dir = tmp_path / "frames"
    with zipfile.ZipFile(os.path.join(dota_root, "frames", "clip_001",
                                      "images.zip")) as z:
        z.extractall(frames_dir)
    model = create_model("internvideo2_small_patch14_224", device="cpu",
                         generator=torch.Generator().manual_seed(3),
                         img_size=28, init_scale=1.0, init_values=0.1)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"model": model.state_dict()}, ckpt)
    args = ["--ckpt", ckpt, "--frames_folder", str(frames_dir),
            "--model", "internvideo2_small_patch14_224", "--num_frames", "8",
            "--input_size", "28", "--dtype", "float32", "--device", "cpu"]
    stream = main(args)
    batched = main(args + ["--batched"])
    assert len(stream) == 32 and len(batched) == 33
    np.testing.assert_allclose([r for _, r in stream],
                               [r for _, r in batched[1:]], atol=1e-6)
    q8 = main(args + ["--quant8", "--fused_rmsq"])
    assert len(q8) == 32 and all(0.0 <= r <= 1.0 for _, r in q8)
    with pytest.raises(ValueError, match="fused_rmsq"):
        main(args + ["--fused_rmsq"])


def test_streaming_step_matches_batched_windows(params):
    model = port_iv2_from(params)
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.integers(0, 256, (9, 28, 28, 3), np.uint8))
    scorer = StreamingScorer(model)
    window, stream = frames[:4], []
    for i in range(4, 9):
        window, risk = scorer.step(window, frames[i])
        stream.append(float(risk))
    idx = torch.stack([torch.arange(s, s + 4) for s in range(1, 6)])
    np.testing.assert_allclose(stream, scorer.score_windows(frames,
                                                             idx).numpy(),
                               atol=1e-6)
