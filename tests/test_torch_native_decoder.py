"""The port's native C++ zip/JPEG decoder (simple_tad_tpu_torch/data/
native.py over its copy of the decoder source) against the JAX package's
NativeZipDecoder and the python/cv2 path, after tests/test_native_decoder.py.

Tolerances: the port's frames bit-equal to the JAX decoder's (the same
source against the same libjpeg); within 1 grey level of cv2's
(test_native_decoder.py's bound: the same libjpeg family, another IDCT);
``decode_zip_frames`` with ``native=True`` within that bound of it off,
resized frames within 2 (one level before a cubic resize).  The JAX
package's tracked library (native/libstt_decoder.so) must not change.
"""

import os
import shutil
import subprocess
import zipfile

import cv2
import numpy as np
import pytest

from simple_tad_tpu.data import native as jax_native
from simple_tad_tpu_torch.data import native
from simple_tad_tpu_torch.data import zipreader
from tests.fixtures import make_synthetic_dada, make_synthetic_dota

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(ROOT, "native", "libstt_decoder.so")


def _toolchain_missing():
    if shutil.which("g++") is None:
        return "g++ not found"
    for header in ("jpeglib.h", "zlib.h"):
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input=f"#include <{header}>\n",
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return f"{header} not found"
    return None


pytestmark = pytest.mark.skipif(
    _toolchain_missing() is not None,
    reason=f"native decoder toolchain: {_toolchain_missing()}")


def _hash(path):
    return subprocess.run(["git", "hash-object", path], cwd=ROOT,
                          capture_output=True, text=True).stdout.strip()


@pytest.fixture(scope="module", autouse=True)
def jax_lib_unchanged():
    before = _hash(JAX_LIB)
    yield
    assert _hash(JAX_LIB) == before, "native/libstt_decoder.so changed"


def _jpeg_zip(path, method, n=6, seed=0, shapes=None):
    rng = np.random.default_rng(seed)
    imgs = {}
    with zipfile.ZipFile(path, "w", method) as zf:
        for t in range(n):
            h, w = shapes[t] if shapes else (48, 64)
            x = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
            img = np.clip(x + rng.normal(0, 10, (h, w, 3)) + t * 5,
                          0, 255).astype(np.uint8)
            ok, buf = cv2.imencode(".jpg", img)
            assert ok
            zf.writestr(f"{t:06d}.jpg", buf.tobytes())
            imgs[f"{t:06d}.jpg"] = buf.tobytes()
    return path, imgs


@pytest.fixture(scope="module", params=[zipfile.ZIP_DEFLATED,
                                        zipfile.ZIP_STORED],
                ids=["deflated", "stored"])
def jpeg_zip(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("nz")
    return _jpeg_zip(str(root / "images.zip"), request.param)


def test_builds_into_the_ignored_build_directory():
    path = native.build_native()
    assert path.exists() and path == native.library_path()
    rel = os.path.relpath(path, ROOT)
    assert rel.startswith("build" + os.sep), rel
    ignored = subprocess.run(["git", "check-ignore", "-q", rel], cwd=ROOT)
    assert ignored.returncode == 0, f"{rel} is not ignored by git"


def test_entry_listing_and_probe(jpeg_zip):
    path, imgs = jpeg_zip
    dec = native.NativeZipDecoder(path)
    assert sorted(dec.entry_names()) == sorted(imgs)
    assert dec.probe("000000.jpg") == (48, 64)
    dec.close()


def test_frames_bit_equal_to_jax_decoder_and_near_cv2(jpeg_zip):
    if not os.path.exists(JAX_LIB):
        pytest.skip("the JAX package's native library is not built")
    path, imgs = jpeg_zip
    names = sorted(imgs)
    got = native.decode_zip_frames_native(path, names)
    want = jax_native.NativeZipDecoder(path).decode(names)
    assert got.shape == (6, 48, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(names):
        ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(imgs[n], np.uint8),
                                        cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        diff = np.abs(got[i].astype(int) - ref.astype(int))
        assert diff.max() <= 1, (n, diff.max())


@pytest.mark.parametrize("resize", [None, (32, 24)])
def test_zipreader_flag_on_matches_off(jpeg_zip, resize):
    path, imgs = jpeg_zip
    names = sorted(imgs)[:4]
    on = zipreader.decode_zip_frames(path, names, resize=resize, native=True)
    off = zipreader.decode_zip_frames(path, names, resize=resize)
    bound = 1 if resize is None else 2
    for a, b in zip(on, off):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= bound


def test_decode_scaled_flag_on_matches_off(jpeg_zip):
    path, imgs = jpeg_zip
    names = sorted(imgs)[:3]
    cache = zipreader.frame_cache()
    if cache is not None:
        cache.clear()
    on = zipreader.decode_scaled(path, names, 32, 1.2, native=True)
    if cache is not None:
        cache.clear()
    off = zipreader.decode_scaled(path, names, 32, 1.2)
    for a, b in zip(on, off):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def test_missing_entry_raises_key_error(jpeg_zip):
    path, _ = jpeg_zip
    with pytest.raises(KeyError):
        native.decode_zip_frames_native(path, ["nope.jpg"])
    with pytest.raises(KeyError):
        zipreader.decode_zip_frames(path, ["nope.jpg"], native=True)


def test_non_jpeg_and_mixed_sizes_fall_back_counted(tmp_path):
    """DADA's PNG members and a zip of two frame sizes take the cv2 path,
    each call counted once; the frames equal the cv2 path's."""
    root = make_synthetic_dada(str(tmp_path / "dada"), n_clips=1,
                               frames_per_clip=4)
    png = os.path.join(root, "frames", "1", "1", "images.zip")
    names = [f"{t:04d}.png" for t in range(4)]
    before = native.NATIVE_FALLBACKS
    got = zipreader.decode_zip_frames(png, names, native=True)
    assert native.NATIVE_FALLBACKS == before + 1
    for a, b in zip(got, zipreader.decode_zip_frames(png, names)):
        np.testing.assert_array_equal(a, b)

    mixed, imgs = _jpeg_zip(str(tmp_path / "mixed.zip"), zipfile.ZIP_STORED,
                            n=3, shapes=[(48, 64), (32, 40), (48, 64)])
    got = zipreader.decode_zip_frames(mixed, sorted(imgs), native=True)
    assert native.NATIVE_FALLBACKS == before + 2
    assert [g.shape for g in got] == [(48, 64, 3), (32, 40, 3), (48, 64, 3)]


def test_unloadable_library_raises(monkeypatch, tmp_path):
    """--native_decoder without a buildable library raises and names what
    is missing; nothing falls back to cv2."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "none" / native.LIB_NAME)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeDecoderUnavailable, match="g\\+\\+"):
        zipreader.decode_zip_frames("unused.zip", ["a.jpg"], native=True)


@pytest.mark.parametrize("header", ["jpeglib.h", "zlib.h"])
def test_missing_header_is_named(monkeypatch, tmp_path, header):
    """A compile that cannot find a header (-nostdinc hides the system's)
    raises and names the header."""
    src = tmp_path / "decoder.cpp"
    src.write_text(f"#include <{header}>\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-nostdinc",))
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "out" / native.LIB_NAME)
    with pytest.raises(native.NativeDecoderUnavailable,
                       match=f"missing {header}"):
        native.load()


def test_dataset_and_source_take_the_flag(tmp_path):
    """FrameDataset / ZipClipSource with native_decoder decode through the
    native branch (DoTA's JPEGs) within the bound of the cv2 path."""
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.data.pretrain_datasets import ZipClipSource
    root = make_synthetic_dota(str(tmp_path / "dota"), n_clips=1,
                               frames_per_clip=20, h=48, w=64)
    clips = read_dota_clips(root, "val_split.txt")
    before = native.NATIVE_FALLBACKS
    views = {}
    for flag in (True, False):
        ds = FrameDataset(clips, mode="test", view_len=16, target_fps=10,
                          orig_fps=10, crop_size=32, native_decoder=flag)
        views[flag] = ds.decode_clip_frames(ds.clip_eval_views()[0])
    assert np.abs(views[True].astype(int) - views[False].astype(int)
                  ).max() <= 2
    src = {flag: ZipClipSource(clips, short_size=40, native_decoder=flag
                               ).read_window(0, [0, 5, 10])
           for flag in (True, False)}
    assert src[True].shape == src[False].shape
    assert np.abs(src[True].astype(int) - src[False].astype(int)).max() <= 2
    assert native.NATIVE_FALLBACKS == before


def test_eval_cli_decodes_through_the_native_branch(tmp_path, monkeypatch):
    """The eval CLI with --native_decoder scores every window of the
    synthetic DoTA root through the native decoder (each clip's decode
    counted), with the same rows as without it."""
    import csv as csv_mod
    from simple_tad_tpu_torch.cli import eval_frames
    root = make_synthetic_dota(str(tmp_path / "dota"), n_clips=2,
                               frames_per_clip=20, h=48, w=64)
    calls = []
    real = native.decode_zip_frames_native

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)
    monkeypatch.setattr(native, "decode_zip_frames_native", counted)
    rows = {}
    for flag in (True, False):
        out = str(tmp_path / f"eval_{flag}")
        eval_frames.main(
            ["--data_set", "DoTA", "--data_path", root, "--model",
             "vit_small_patch16_224", "--input_size", "32", "--num_frames",
             "16", "--batch_size", "8", "--dtype", "float32", "--device",
             "cpu", "--output_dir", out]
            + (["--native_decoder"] if flag else []))
        with open(os.path.join(out, "predictions.csv")) as f:
            rows[flag] = [(r["clip"], r["filename"], r["label"])
                          for r in csv_mod.DictReader(f)]
        if flag:
            assert len(calls) == 2, calls        # one decode a clip
    assert rows[True] == rows[False] and len(rows[True]) == 2 * 5


def test_clis_pass_the_flag_and_fail_early(tmp_path, monkeypatch):
    """Fine-tuning's, pre-training's and distillation's datasets take the
    flag; each CLI raises before it builds a model where the library
    cannot be built."""
    from simple_tad_tpu_torch.cli import distill, eval_frames, finetune
    from simple_tad_tpu_torch.cli import pretrain
    from simple_tad_tpu_torch.config import FinetuneConfig
    root = make_synthetic_dota(str(tmp_path / "dota"), n_clips=2,
                               frames_per_clip=20, h=48, w=64,
                               split="train_split.txt", prefix="train")
    make_synthetic_dota(root, n_clips=1, frames_per_clip=20, h=48, w=64)
    cfg = FinetuneConfig(data_set="DoTA", data_path=root, num_frames=8,
                         input_size=32)
    for ds in finetune.build_datasets(cfg, True):
        assert ds.native_decoder is True
    assert pretrain._build_source("DoTA", root, cfg,
                                  native_decoder=True).source.native_decoder
    args = distill.build_parser().parse_args(
        ["--data_path", root, "--num_frames", "8", "--native_decoder"])
    loader, _ = distill.build_loader(args)
    assert loader.dataset.native_decoder is True

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "none" / native.LIB_NAME)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    common = ["--data_set", "DoTA", "--data_path", root, "--device", "cpu",
              "--native_decoder"]
    for main, argv in (
            (eval_frames.main, common),
            (finetune.main, common),
            (pretrain.main, common + ["--model",
                                      "pretrain_videomae_small_patch16_224"]),
            (distill.main, ["--data_path", root, "--device", "cpu",
                            "--native_decoder"])):
        with pytest.raises(native.NativeDecoderUnavailable, match="g\\+\\+"):
            main(argv)
