"""The three steps of jobs/eval/eval_DoTA.sh on the port, on the synthetic
DoTA fixture with pandas and scikit-learn blocked: the eval CLI
(predictions.csv, stats.txt, plots/{pr,roc,confusion,dist}.jpg), the
data tool's anno-for-predictions (frame_level_anno_val.csv) and
eval/analysis.py:show_metrics (group_metrics.txt); the model cut for the
CPU (ViT-S, seeded, at 32 x 32).  The annotation CSV and the grouped
report are held to the JAX package's anno_for_predictions and
show_metrics of the same predictions: the same rows, byte for byte, and
each group's metrics within 1e-9.  ``pad_to_square`` against the JAX
package's, exactly, in its three modes.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_synthetic_dota
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

PLOTS = ("pr", "roc", "confusion", "dist")


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    return make_synthetic_dota(str(tmp_path_factory.mktemp("dota")),
                               n_clips=3, frames_per_clip=40, h=48, w=64)


def _block(monkeypatch):
    """Make pandas and scikit-learn unimportable (a None entry in
    sys.modules raises ImportError on import)."""
    for name in ("pandas", "sklearn", "sklearn.metrics"):
        monkeypatch.setitem(sys.modules, name, None)


def test_eval_job_three_steps_match_jax(dota_root, tmp_path, monkeypatch):
    from simple_tad_tpu_torch.cli import data_tools, eval_frames
    from simple_tad_tpu_torch.eval import analysis
    out = str(tmp_path / "eval")
    anno_csv = os.path.join(out, "frame_level_anno_val.csv")
    with monkeypatch.context() as m:
        _block(m)
        with pytest.raises(ImportError):
            import pandas  # noqa: F401
        eval_frames.main([
            "--data_set", "DoTA", "--data_path", dota_root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--num_frames", "16", "--batch_size", "96", "--dtype",
            "float32", "--output_dir", out, "--device", "cpu"])
        data_tools.main(["anno-for-predictions", "--data_set", "DoTA",
                         "--data_path", dota_root, "--split",
                         "val_split.txt", "--out", anno_csv])
        report = analysis.show_metrics(out, anno_csv=anno_csv)
    for name in ("predictions.csv", "stats.txt", "params.json",
                 "frame_level_anno_val.csv", "group_metrics.txt"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    for name in PLOTS:
        with open(os.path.join(out, "plots", f"{name}.jpg"), "rb") as f:
            assert f.read(3) == b"\xff\xd8\xff", name       # a JPEG
    with open(os.path.join(out, "group_metrics.txt")) as f:
        assert f.read() == report + "\n"

    # the JAX package's steps two and three on the same predictions
    import pandas as pd
    from simple_tad_tpu.cli.data_tools import anno_for_predictions
    from simple_tad_tpu.eval import analysis as jax_analysis
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    shutil.copy(os.path.join(out, "predictions.csv"), ref)
    ref_anno = os.path.join(ref, "frame_level_anno_val.csv")
    anno_for_predictions("DoTA", dota_root, "val_split.txt", ref_anno)
    with open(anno_csv, "rb") as f, open(ref_anno, "rb") as g:
        assert f.read() == g.read()
    want_report = jax_analysis.show_metrics(ref, anno_csv=ref_anno)
    assert report == want_report
    want = jax_analysis.grouped_metrics(
        pd.read_csv(os.path.join(ref, "predictions.csv")),
        pd.read_csv(ref_anno))
    got = analysis.grouped_metrics(
        analysis.read_table(os.path.join(out, "predictions.csv")),
        analysis.read_table(anno_csv))
    assert list(got) == list(want)
    assert {"TOTAL", "ego", "non-ego", "night", "day"} <= set(got)
    for group, m in want.items():
        for k, v in m.items():
            np.testing.assert_allclose(got[group][k], v, rtol=0, atol=1e-9,
                                       err_msg=f"{group} {k}")
    # without an annotation table: the TOTAL group alone
    bare = analysis.grouped_metrics(analysis.read_table(
        os.path.join(out, "predictions.csv")))
    np.testing.assert_allclose(bare["TOTAL"]["auroc"],
                               want["TOTAL"]["auroc"], rtol=0, atol=1e-9)


def test_eval_cli_without_matplotlib_stops_before_evaluating(
        dota_root, tmp_path, monkeypatch):
    """With --output_dir and no matplotlib, the eval CLI raises before it
    builds the model: no half-written output directory."""
    from simple_tad_tpu_torch import models
    from simple_tad_tpu_torch.cli import eval_frames

    def never(*args, **kwargs):
        raise AssertionError("the model was built")

    out = str(tmp_path / "eval")
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(models, "create_model", never)
    with pytest.raises(ImportError, match="plots"):
        eval_frames.main([
            "--data_set", "DoTA", "--data_path", dota_root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--output_dir", out, "--device", "cpu"])
    assert not os.path.exists(out)


def test_show_metrics_from_a_dataset_matches_csv(dota_root, tmp_path):
    """show_metrics(dataset=...) builds the same annotation table in memory
    as the CSV round trip, and a group with one class gets the
    reference's sentinel AUC."""
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.eval import analysis
    ds = FrameDataset(read_dota_clips(dota_root, "val_split.txt"),
                      mode="test", view_len=16, target_fps=10, orig_fps=10,
                      view_step=1)
    anno = analysis.build_frame_annotations(ds)
    path = str(tmp_path / "anno.csv")
    analysis.write_table(anno, path)
    assert analysis.read_table(path) == anno
    rng = np.random.default_rng(0)
    n = len(anno["clip"])
    preds = {"clip": anno["clip"], "filename": anno["filename"],
             "logits_safe": list(rng.standard_normal(n)),
             "logits_risk": list(rng.standard_normal(n)),
             "label": anno["label"], "ttc": [0.0] * n}
    analysis.write_table(preds, str(tmp_path / "predictions.csv"))
    from_ds = analysis.show_metrics(str(tmp_path), dataset=ds)
    assert from_ds == analysis.show_metrics(str(tmp_path), anno_csv=path)
    groups = analysis.grouped_metrics(preds, anno)
    # clip 0 is the only non-ego clip and holds no anomaly
    assert groups["non-ego"]["auroc"] == -10
    assert groups["non-ego"]["n"] == anno["ego"].count(0)


@pytest.mark.parametrize("mode,fill", [("black", None),
                                       ("color", (10, 200, 30)),
                                       ("replicate", None)])
@pytest.mark.parametrize("shape", [(2, 5, 9, 3), (7, 4, 3), (4, 4, 3)])
def test_pad_to_square_matches_jax(mode, fill, shape):
    from simple_tad_tpu.ops.image import pad_to_square as jax_pad
    from simple_tad_tpu_torch.ops.image import pad_to_square
    rng = np.random.default_rng(1)
    for dtype in (np.uint8, np.float32):
        x = (rng.integers(0, 256, shape) if dtype == np.uint8
             else rng.standard_normal(shape)).astype(dtype)
        want = np.asarray(jax_pad(jnp.asarray(x), mode, fill))
        got = pad_to_square(torch.from_numpy(x), mode, fill).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
