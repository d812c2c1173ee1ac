"""The port's visualization CLI (simple_tad_tpu_torch/cli/visualize.py)
against the JAX package's, after tests/test_interop_vis.py:66-122.

* ``mae-recon``: the core (``reconstruct``) on
  pretrain_videomae_small_patch16_224 at 4 frames of 32 x 32, with a
  seeded ``.pth`` that both packages load, against the JAX
  ``mae_reconstruction``, whose orig / masked / recon arrays are captured
  before the uint8 cast by a spy on its module's ``np.clip`` (and its
  images by one on ``cv2.imwrite``; nothing in the JAX package changes):
  within 1e-4 at fp32.  The frames are fed at the model's size, so the
  resize (ROADMAP.md F0) is out of the comparison.  The port's whole
  command writes the same images, each pixel within 1 grey level (a float
  1e-6 apart may truncate to the next level).  jobs/vis.sh's command line
  runs unchanged on the port with ``--device cpu``.
* ``overlay``, ``zip2gif`` and ``paper-figure`` give the same images as the
  JAX commands: the annotated JPEGs and the GIFs byte for byte, the figure
  pixel for pixel.
"""

import os
import re
import shlex
import zipfile

import cv2
import numpy as np
import pytest
import torch

from simple_tad_tpu.cli import visualize as jax_vis
from simple_tad_tpu_torch.cli import visualize as vis
from tests.fixtures import make_synthetic_dota
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pretrain_videomae_small_patch16_224"


class _NumpySpy:
    """The numpy module, with ``clip`` recording its first argument."""

    def __init__(self):
        self.clipped = []

    def __getattr__(self, name):
        return getattr(np, name)

    def clip(self, a, *args, **kw):
        self.clipped.append(np.array(a, copy=True))
        return np.clip(a, *args, **kw)


@pytest.fixture(scope="module")
def clip_zip(tmp_path_factory):
    """8 frames of 32 x 32 JPEGs (the model's size) in an images.zip."""
    root = tmp_path_factory.mktemp("clip")
    rng = np.random.default_rng(0)
    path = str(root / "images.zip")
    with zipfile.ZipFile(path, "w") as zf:
        for t in range(8):
            img = np.clip(rng.normal(120 + 10 * t, 40, (32, 32, 3)), 0,
                          255).astype(np.uint8)
            zf.writestr(f"{t:04d}.jpg", cv2.imencode(".jpg", img)[1]
                        .tobytes())
    return path


@pytest.fixture(scope="module")
def seeded_pth(tmp_path_factory):
    model = vis.build_mae_model(MODEL, decoder_depth=1, num_frames=4,
                                input_size=32, device="cpu", seed=5)
    path = str(tmp_path_factory.mktemp("ckpt") / "mae_s.pth")
    torch.save({"model": model.state_dict()}, path)
    return path


def _jax_recon(monkeypatch, ckpt, video, out_dir):
    spy = _NumpySpy()
    written = {}
    real_imwrite = cv2.imwrite

    def imwrite(path, img):
        written[os.path.basename(path)] = np.array(img, copy=True)
        return real_imwrite(path, img)

    monkeypatch.setattr(jax_vis, "np", spy)
    monkeypatch.setattr(jax_vis.cv2, "imwrite", imwrite)
    jax_vis.mae_reconstruction(MODEL, ckpt, video, out_dir, mask_ratio=0.9,
                               decoder_depth=1, num_frames=4,
                               sampling_rate=2, input_size=32)
    monkeypatch.undo()
    orig, masked, recon = spy.clipped
    return {"orig": orig, "masked": masked, "recon": recon}, written


def test_mae_recon_core_matches_jax(monkeypatch, tmp_path, clip_zip,
                                    seeded_pth):
    want, _ = _jax_recon(monkeypatch, seeded_pth, clip_zip,
                         str(tmp_path / "jax"))
    with zipfile.ZipFile(clip_zip) as zf:
        frames = np.stack([cv2.cvtColor(cv2.imdecode(
            np.frombuffer(zf.read(f"{t:04d}.jpg"), np.uint8),
            cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB) for t in (0, 2, 4, 6)])
    model = vis.build_mae_model(MODEL, seeded_pth, decoder_depth=1,
                                num_frames=4, input_size=32, device="cpu")
    got = vis.reconstruct(model, frames, mask_ratio=0.9, seed=42)
    assert got["pred"].shape == (6, 1536) and got["mask_idx"].shape == (6,)
    for name in ("orig", "masked", "recon"):
        assert got[name].shape == want[name].shape == (4, 32, 32, 3), name
        np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                   rtol=0, err_msg=name)
    # only the masked patches are predicted: the visible ones are the orig
    visible = np.ones(8, bool)
    visible[got["mask_idx"]] = False
    patches = vis.patchify(got["recon"], 16, 2)
    np.testing.assert_array_equal(patches[visible],
                                  vis.patchify(got["orig"], 16, 2)[visible])
    assert np.abs(patches[~visible] - vis.patchify(
        got["orig"], 16, 2)[~visible]).max() > 1e-2


def test_mae_recon_command_writes_jax_images(monkeypatch, tmp_path,
                                             clip_zip, seeded_pth):
    _, want = _jax_recon(monkeypatch, seeded_pth, clip_zip,
                         str(tmp_path / "jax"))
    out = str(tmp_path / "port")
    vis.main(["mae-recon", "--model", MODEL, "--ckpt", seeded_pth,
              "--video", clip_zip, "--output_dir", out, "--num_frames", "4",
              "--sampling_rate", "2", "--input_size", "32",
              "--decoder_depth", "1", "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == sorted(want) and len(names) == 12
    for name in names:
        got = cv2.imread(os.path.join(out, name))
        ref = cv2.imdecode(cv2.imencode(".jpg", want[name])[1],
                           cv2.IMREAD_COLOR)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name


def test_jobs_vis_sh_line_runs_on_the_port(tmp_path):
    """jobs/vis.sh's command line, its module switched to the port's and
    --device cpu added, with seeded weights (no --ckpt file) on a
    synthetic video: the 16 orig / masked / recon images."""
    with open(os.path.join(ROOT, "jobs", "vis.sh")) as f:
        script = f.read()
    line = re.search(r"python -m (\S+) (mae-recon .*?)(?:\n\n|\Z)",
                     script.replace("\\\n", " "), re.S)
    assert line.group(1) == "simple_tad_tpu.cli.visualize"
    video = str(tmp_path / "demo.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (64, 48))
    for t in range(20):
        wr.write(np.full((48, 64, 3), 40 + 8 * t, np.uint8))
    wr.release()
    out = str(tmp_path / "vis")
    argv = [a.replace('"${MODEL_PATH}"', "").replace("${MODEL_PATH}", "")
            .replace("${VIDEO_PATH}", video).replace("${OUT}", out)
            for a in shlex.split(line.group(2).replace('"', ""))]
    vis.main(argv + ["--device", "cpu"])
    names = sorted(os.listdir(out))
    for kind in ("orig", "masked", "recon"):
        assert sum(n.startswith(kind) for n in names) == 16, kind


def _preds_csv(path, clip, names, seed, shift=0.0, labels=None):
    import csv
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["clip", "filename", "logits_safe", "logits_risk",
                    "label", "ttc"])
        for i, n in enumerate(names):
            w.writerow([clip, n, repr(float(rng.normal())),
                        repr(float(rng.normal() + shift)),
                        labels[i] if labels else 0, 0.0])
    return path


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def test_overlay_and_zip2gif_byte_equal(tmp_path):
    root = make_synthetic_dota(str(tmp_path / "d"), n_clips=1,
                               frames_per_clip=24, h=48, w=64)
    names = [f"{t:06d}.jpg" for t in range(15, 24)]
    csv_path = _preds_csv(str(tmp_path / "p.csv"), "clip_000", names, 0)
    got = {}
    for name, mod in (("port", vis), ("jax", jax_vis)):
        out = str(tmp_path / name)
        gif = str(tmp_path / f"{name}.gif")
        n = mod.overlay_clip(root, csv_path, "clip_000", out, gif=gif)
        plain = str(tmp_path / f"{name}_plain.gif")
        m = mod.zip2gif(os.path.join(root, "frames", "clip_000",
                                     "images.zip"), plain)
        with open(gif, "rb") as f, open(plain, "rb") as g:
            got[name] = (n, m, _files(out), f.read(), g.read())
    assert got["port"][0] == len(names) and got["port"][1] == 24
    assert got["port"] == got["jax"]
    with pytest.raises(ValueError, match="no predictions"):
        vis.overlay_clip(root, csv_path, "clip_999", str(tmp_path / "x"))


def test_paper_figure_pixel_equal(tmp_path):
    root = make_synthetic_dota(str(tmp_path / "d"), n_clips=2,
                               frames_per_clip=24, h=48, w=64)
    names = [f"{t:06d}.jpg" for t in range(24)]
    labels = [int(12 <= t <= 20) for t in range(24)]
    csvs = [_preds_csv(str(tmp_path / f"p{i}.csv"), "clip_001", names,
                       1 + i, shift=i, labels=labels) for i in range(2)]
    argv = ["paper-figure", "--data_path", root, "--clip", "clip_001",
            "--preds", csvs[0], "--name", "w/o DAPT", "--preds", csvs[1],
            "--name", "w/ DAPT"]
    vis.main(argv + ["--out", str(tmp_path / "port.png")])
    jax_vis.main(argv + ["--out", str(tmp_path / "jax.png")])
    got = cv2.imread(str(tmp_path / "port.png"))
    want = cv2.imread(str(tmp_path / "jax.png"))
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
