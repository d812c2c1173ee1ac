"""Every command of the port's data tools (simple_tad_tpu_torch/cli/
data_tools.py) against the JAX package's (simple_tad_tpu/cli/
data_tools.py) on the synthetic roots of tests/fixtures.py: the zips,
split files, view lists and CSVs each command writes are byte-equal, the
functions return the same values, and the exit codes agree (a corrupt zip
or an unreadable video exits 1 in both).  This image has no Excel engine,
so convert-xlsx exits in both with a message that names one.  Exact: host
code on the same files.
"""

import os
import zipfile

import cv2
import numpy as np
import pytest

from simple_tad_tpu.cli import data_tools as jax_tools
from simple_tad_tpu_torch.cli import data_tools as tools
from tests.fixtures import make_synthetic_dada, make_synthetic_dota


def _run(main, argv):
    """-> (exit code, the exit message or "")."""
    try:
        main(argv)
    except SystemExit as e:
        return (e.code if isinstance(e.code, int) else 1), str(e.code)
    return 0, ""


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = _bytes(path)
    return out


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dota"))
    make_synthetic_dota(root, n_clips=6, frames_per_clip=20, h=48, w=64)
    return root


def _video(path, frames=12, h=48, w=64):
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    for t in range(frames):
        wr.write(np.full((h, w, 3), 20 + 10 * t, np.uint8))
    wr.release()


def test_frames2zip_byte_equal(tmp_path):
    src = tmp_path / "src"
    rng = np.random.default_rng(0)
    for c in range(2):
        d = src / f"clip_{c}"
        d.mkdir(parents=True)
        for t in range(3):
            cv2.imwrite(str(d / f"{t:04d}.jpg"),
                        rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
    (src / "empty").mkdir()
    outs = {}
    for name, main in (("port", tools.main), ("jax", jax_tools.main)):
        dst = tmp_path / name
        assert _run(main, ["frames2zip", "--src", str(src), "--dst",
                           str(dst)])[0] == 0
        outs[name] = _tree_bytes(str(dst))
    assert sorted(outs["port"]) == ["clip_0/images.zip", "clip_1/images.zip"]
    assert outs["port"] == outs["jax"]


def test_check_zips_same_exit_codes(tmp_path):
    root = make_synthetic_dota(str(tmp_path / "d"), n_clips=2,
                               frames_per_clip=4, h=16, w=16)
    argv = ["check-zips", "--data_path", root]
    assert _run(tools.main, argv)[0] == _run(jax_tools.main, argv)[0] == 0
    assert tools.check_zips(root) == jax_tools.check_zips(root) == []
    bad = os.path.join(root, "frames", "clip_001", "images.zip")
    data = bytearray(_bytes(bad))
    data[100] ^= 0xFF                          # a member's bytes: bad CRC
    with open(bad, "wb") as f:
        f.write(data)
    with open(os.path.join(root, "frames", "clip_000", "images.zip"),
              "wb") as f:
        f.write(b"not a zip")
    assert _run(tools.main, argv)[0] == _run(jax_tools.main, argv)[0] == 1
    assert sorted(tools.check_zips(root)) == sorted(
        jax_tools.check_zips(root))
    assert len(tools.check_zips(root)) == 2


def test_check_videos_same_exit_codes(tmp_path):
    root = tmp_path / "videos"
    root.mkdir()
    _video(str(root / "good.avi"))
    argv = ["check-videos", "--data_path", str(root)]
    assert _run(tools.main, argv)[0] == _run(jax_tools.main, argv)[0] == 0
    (root / "broken.mp4").write_bytes(b"\x00" * 64)
    assert _run(tools.main, argv)[0] == _run(jax_tools.main, argv)[0] == 1
    assert tools.check_videos(str(root)) == jax_tools.check_videos(
        str(root)) == [str(root / "broken.mp4")]


def test_halfsplit_byte_equal(dota_root):
    out = {}
    base = os.path.join(dota_root, "dataset", "val_split")
    for name, mod in (("jax", jax_tools), ("port", tools)):
        halves = mod.halfsplit(dota_root, "val_split.txt", seed=3)
        out[name] = (halves, _bytes(base + "_half1.txt"),
                     _bytes(base + "_half2.txt"))
    assert out["port"] == out["jax"]
    assert len(out["port"][0][0]) + len(out["port"][0][1]) == 6
    argv = ["halfsplit", "--data_path", dota_root, "--seed", "1"]
    assert _run(tools.main, argv)[0] == 0


def test_anno_for_predictions_byte_equal(dota_root, tmp_path):
    port, ref = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert _run(tools.main, ["anno-for-predictions", "--data_path",
                             dota_root, "--out", port])[0] == 0
    jax_tools.anno_for_predictions("DoTA", dota_root, "val_split.txt", ref)
    assert _bytes(port) == _bytes(ref)


@pytest.mark.parametrize("cmd", ["prepare-anno-dada2000",
                                 "prepare-anno-capdata"])
def test_prepare_anno_split_byte_equal(tmp_path, cmd):
    root = make_synthetic_dada(str(tmp_path / "dada"), n_clips=5,
                               frames_per_clip=4)
    full = os.path.join(root, "annotation", "full_anno.csv")
    zfill = 3 if cmd.endswith("dada2000") else 6
    orig = tmp_path / "orig.txt"
    # '<dir> <label> <start> <end> <toa>, <free text>' lines
    orig.write_text("".join(f"{name} 1 0 0 0, a clip\n" for name in (
        f"1/{'1'.zfill(zfill)}", f"1/{'3'.zfill(zfill)}")))
    out = {}
    for name, main in (("port", tools.main), ("jax", jax_tools.main)):
        d = str(tmp_path / name)
        assert _run(main, [cmd, "--full_anno", full, "--orig_split",
                           str(orig), "--out_dir", d])[0] == 0
        out[name] = _tree_bytes(d)
    assert sorted(out["port"]) == ["training.txt", "validation.txt"]
    assert out["port"] == out["jax"]
    assert tools.natsorted(["10/2", "2/2", "1/10", "1/9"]) == \
        jax_tools.natsorted(["10/2", "2/2", "1/10", "1/9"])


def test_convert_xlsx_exits_naming_an_engine(tmp_path):
    src = tmp_path / "anno.xlsx"
    with zipfile.ZipFile(src, "w") as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("xl/workbook.xml", "<workbook/>")
    argv = ["convert-xlsx", "--src", str(src), "--dst",
            str(tmp_path / "out.csv")]
    try:
        import openpyxl  # noqa: F401
        pytest.skip("an Excel engine is installed")
    except ImportError:
        pass
    code, msg = _run(tools.main, argv)
    jax_code, _ = _run(jax_tools.main, argv)
    assert code == jax_code == 1
    assert "openpyxl" in msg


def test_prepare_anno_bdd_byte_equal(tmp_path):
    root = tmp_path / "bdd"
    (root / "videos").mkdir(parents=True)
    for i in range(2):
        _video(str(root / "videos" / f"v{i}.avi"), frames=60)
    out = {}
    for name, main in (("port", tools.main), ("jax", jax_tools.main)):
        d = str(tmp_path / name)
        assert _run(main, ["prepare-anno-bdd", "--data_path", str(root),
                           "--out_dir", d, "--num_frames", "4"])[0] == 0
        out[name] = _tree_bytes(d)
    assert sorted(out["port"]) == ["all_clips.txt",
                                   "all_dataset_samples.txt"]
    assert out["port"] == out["jax"]


def test_prepare_views_byte_equal(dota_root, tmp_path):
    out = {}
    for name, main in (("port", tools.main), ("jax", jax_tools.main)):
        path = str(tmp_path / f"{name}.txt")
        assert _run(main, ["prepare-views", "--data_set", "DoTA",
                           "--data_path", dota_root, "--out", path,
                           "--num_frames", "8", "--sampling_rate", "2"]
                    )[0] == 0
        out[name] = _bytes(path)
    assert out["port"] == out["jax"] and out["port"]
