"""The port's reference-signature dataset builders
(simple_tad_tpu_torch/data/builders.py) against the JAX package's, after
tests/test_builders.py: on the synthetic DoTA and DADA-2000 roots, every
data set (DoTA, DoTA_half, DADA2K, DADA2K_half) and split (train,
validation, test) gives the same mode, stride, windows and ``nb_classes``,
and ``build_pretraining_dataset`` the same windows and frames.  Exact:
the builders are host code on the same files.
"""

import dataclasses
import os

import numpy as np
import pytest

from simple_tad_tpu.config import FinetuneConfig, PretrainConfig
from simple_tad_tpu.data import builders as jax_builders
from simple_tad_tpu_torch.data import builders
from tests.fixtures import make_synthetic_dada, make_synthetic_dota_full


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    dota = make_synthetic_dota_full(
        str(tmp_path_factory.mktemp("bdota")), n_clips=2,
        frames_per_clip=24, h=48, w=64)
    # the half splits the reference's DoTA_half / DADA2K_half read
    ds = os.path.join(dota, "dataset")
    with open(os.path.join(ds, "train_split.txt")) as f, \
            open(os.path.join(ds, "train_split_half1.txt"), "w") as g:
        g.write(f.read().splitlines()[0] + "\n")
    dada = make_synthetic_dada(str(tmp_path_factory.mktemp("bdada")),
                               n_clips=2, frames_per_clip=60)
    split = os.path.join(dada, "DADA2K_my_split")
    with open(os.path.join(split, "training.txt")) as f, \
            open(os.path.join(split, "half_training.txt"), "w") as g:
        g.write(f.read().splitlines()[0] + "\n")
    return {"DoTA": dota, "DADA2K": dada}


def _describe(ds):
    return {"mode": ds.mode, "view_step": ds.view_step,
            "view_len": ds.view_len, "orig_fps": ds.orig_fps,
            "target_fps": ds.target_fps, "crop_size": ds.crop_size,
            "clips": [c.name for c in ds.clips],
            "windows": [(s.clip_idx, s.frame_idx.tolist(), s.label,
                         s.smoothed.tolist(), s.ttc) for s in ds.samples]}


@pytest.mark.parametrize("data_set", ["DoTA", "DoTA_half", "DADA2K",
                                      "DADA2K_half"])
@pytest.mark.parametrize("is_train,test_mode", [(True, False),
                                                (False, False),
                                                (False, True)],
                         ids=["train", "val", "test"])
@pytest.mark.parametrize("sampling_rate_val", [-1, 1])
def test_build_frame_dataset_matches_jax(roots, data_set, is_train,
                                         test_mode, sampling_rate_val):
    root = roots["DoTA" if data_set.startswith("DoTA") else "DADA2K"]
    args = FinetuneConfig(data_set=data_set, data_path=root, num_frames=16,
                          view_fps=10, sampling_rate=3,
                          sampling_rate_val=sampling_rate_val, input_size=32)
    got, n = builders.build_frame_dataset(is_train, test_mode, args)
    want, n_want = jax_builders.build_frame_dataset(is_train, test_mode, args)
    assert n == n_want == 2
    assert len(got) > 0
    assert _describe(got) == _describe(want)
    assert got.native_decoder is False


def test_native_decoder_reaches_the_datasets(roots):
    args = dict(dataclasses.asdict(FinetuneConfig(
        data_set="DoTA", data_path=roots["DoTA"], num_frames=16, view_fps=10,
        input_size=32)), native_decoder=True)
    ns = type("Args", (), args)
    ds, _ = builders.build_frame_dataset(False, True, ns)
    assert ds.native_decoder is True
    pre = builders.build_pretraining_dataset(True, ns)
    assert pre.source.native_decoder is True


@pytest.mark.parametrize("data_set", ["DoTA", "DADA2K"])
def test_build_pretraining_dataset_matches_jax(roots, data_set,
                                               monkeypatch):
    # both sides decode with zipfile + cv2 (the JAX native branch off)
    from simple_tad_tpu.data import native
    monkeypatch.setattr(native, "decode_zip_frames_native",
                        lambda *a, **k: None)
    args = PretrainConfig(data_set=data_set, data_path=roots[data_set],
                          num_frames=16, view_fps=10, sampling_rate=4)
    got = builders.build_pretraining_dataset(True, args)
    want = jax_builders.build_pretraining_dataset(True, args)
    assert len(got) == len(want) > 0
    for (c1, s1), (c2, s2) in zip(got.samples, want.samples):
        assert c1 == c2
        np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(got.get_window(0), want.get_window(0))


def test_unknown_data_set_raises(roots):
    args = FinetuneConfig(data_set="UCF", data_path=roots["DoTA"])
    with pytest.raises(NotImplementedError):
        builders.build_frame_dataset(True, False, args)
    with pytest.raises(NotImplementedError):
        builders.build_pretraining_dataset(True, PretrainConfig(
            data_set="UCF", data_path=roots["DoTA"]))
