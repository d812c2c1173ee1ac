"""The port's copies of the JAX package's numpy-only host modules give the
same outputs as their originals on seeded inputs.

simple_tad_tpu/__init__.py imports flax eagerly, so the port cannot import
these modules from the JAX package; it carries copies, and this file holds
each copy to its original.
"""

import dataclasses

import numpy as np
import pytest

import simple_tad_tpu.config as jax_config
import simple_tad_tpu.data.frame_datasets as jax_fd
import simple_tad_tpu.data.labels as jax_labels
import simple_tad_tpu.data.masking as jax_masking
import simple_tad_tpu.data.pretrain_datasets as jax_pre
import simple_tad_tpu.data.sequencing as jax_seq
import simple_tad_tpu.data.video_cls_datasets as jax_cls
import simple_tad_tpu.data.zipreader as jax_zip
import simple_tad_tpu.eval.metrics as jax_metrics
import simple_tad_tpu.train.engine as jax_engine
import simple_tad_tpu.utils.logging as jax_logging
import simple_tad_tpu_torch.config as port_config
import simple_tad_tpu_torch.data.frame_datasets as port_fd
import simple_tad_tpu_torch.data.labels as port_labels
import simple_tad_tpu_torch.data.masking as port_masking
import simple_tad_tpu_torch.data.pretrain_datasets as port_pre
import simple_tad_tpu_torch.data.sequencing as port_seq
import simple_tad_tpu_torch.data.video_cls_datasets as port_cls
import simple_tad_tpu_torch.data.zipreader as port_zip
import simple_tad_tpu_torch.eval.metrics as port_metrics
import simple_tad_tpu_torch.train.engine as port_engine
import simple_tad_tpu_torch.utils.logging as port_logging
from tests.fixtures import make_synthetic_dada, make_synthetic_dota


def _equal(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def _metrics(m):
    rng = np.random.default_rng(0)
    labels = (rng.random(500) < 0.3).astype(np.int64)
    probs = np.clip(labels * 0.3 + rng.random(500) * 0.7, 0, 1)
    return m.binary_metrics(probs, labels)


def _sequencing(m):
    rng = np.random.default_rng(1)
    unsafe = rng.random(120) < 0.1
    return [m.RegularSequencer(10, 16, step=s).get_sequences(n, fps)
            for s in (1, 3) for n, fps in ((40, 10), (120, 30), (10, 10))] + [
        m.RegularSequencerWithStart(10, 16, 2).get_sequences(61, 30),
        m.UnsafeOverlapSequencer(10, 16, 2, (3, 1)).get_sequences(unsafe, 10)]


def _labels(m):
    rng = np.random.default_rng(2)
    binary = (rng.random(200) < 0.05).astype(np.int64)
    tv = m.compute_time_vector(binary, fps=10, TT=2.0, TA=1.0)
    return [tv, m.smooth_labels(binary, tv, 2.0, 1.0)]


def _config(m):
    argv = ["--model", "vit_small_patch16_224", "--batch_size", "8",
            "--input_size", "32", "--no_dist_eval", "--clip_grad", "1.5",
            "--opt_betas", "0.9", "0.98", "--resize_on_host"]
    pre = ["--model", "pretrain_videomae_base_patch16_224", "--batch_size",
           "240", "--data_set", "BDD100K", "--data_set2", "DoTA",
           "--batch_size2", "160", "--mask_ratio", "0.75",
           "--transforms_finetune_align", "--opt_betas", "0.9", "0.95",
           "--stop_at_epoch", "12", "--no_normlize_target"]
    return [dataclasses.asdict(m.FinetuneConfig.from_args(argv)),
            dataclasses.asdict(m.FinetuneConfig.from_args([])),
            dataclasses.asdict(m.PretrainConfig.from_args(pre)),
            dataclasses.asdict(m.PretrainConfig.from_args([]))]


def _masking(m):
    out = []
    for kind, size, ratio in (("tube", (8, 14, 14), 0.75),
                              ("tube", (8, 14, 14), 0.9),
                              ("random", (8, 16, 16), 0.8)):
        gen = m.make_mask_generator(kind, size, ratio)
        out += [gen.total_masks, gen(np.random.default_rng(1)),
                gen.batch(4, np.random.default_rng(2))]
    return out


def _logging(m):
    sv = m.SmoothedValue(window_size=3)
    for v in (3.0, 1.0, 4.0, 1.5):
        sv.update(v)
    ml = m.MetricLogger()
    ml.update(loss=2.0, acc=0.5)
    ml.update(loss=1.0, acc=1.0)
    return [sv.median, sv.avg, sv.global_avg, sv.max, sv.value, str(sv),
            ml.epoch_stats(), str(ml)]


def _frame_views(m, root, **kw):
    clips = m.read_dota_clips(root, "val_split.txt")
    ds = m.FrameDataset(clips, mode="test", view_len=16, target_fps=5,
                        orig_fps=10, view_step=1, crop_size=32, **kw)
    views = ds.clip_eval_views()
    return [clips, ds.samples, views,
            ds.decode_clip_frames(views[1], resize_on_host=True)]


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    return make_synthetic_dota(str(tmp_path_factory.mktemp("dota")),
                               n_clips=2, frames_per_clip=40, h=48, w=64)


@pytest.mark.parametrize("make,jax_mod,port_mod", [
    (_metrics, jax_metrics, port_metrics),
    (_sequencing, jax_seq, port_seq),
    (_labels, jax_labels, port_labels),
    (_config, jax_config, port_config),
    (_logging, jax_logging, port_logging),
    (_masking, jax_masking, port_masking),
], ids=["metrics", "sequencing", "labels", "config", "logging", "masking"])
def test_host_copy_matches_original(make, jax_mod, port_mod):
    _equal(make(port_mod), make(jax_mod))


def _jax_native_off(monkeypatch):
    from simple_tad_tpu.data import native
    monkeypatch.setattr(native, "decode_zip_frames_native",
                        lambda *a, **k: None)


def _jax_native_on(monkeypatch):
    """The JAX package's native branch on (its opt-in variable), over its
    tracked library; skipped where that library is absent."""
    from simple_tad_tpu.data import native
    if not native.available():
        pytest.skip("the JAX package's native decoder library is absent")
    monkeypatch.setenv("SIMPLE_TAD_NATIVE_DECODER", "1")


def test_frame_dataset_views_match_original(dota_root, monkeypatch):
    # both sides decode with python zipfile + cv2: the native branch off
    # in the original (its variable) and in the port (its argument)
    _jax_native_off(monkeypatch)
    _equal(_frame_views(port_fd, dota_root, native_decoder=False),
           _frame_views(jax_fd, dota_root))


def test_frame_dataset_views_match_original_native(dota_root, monkeypatch):
    # both sides on the native C++ decoder
    _jax_native_on(monkeypatch)
    _equal(_frame_views(port_fd, dota_root, native_decoder=True),
           _frame_views(jax_fd, dota_root))


def test_zip_decode_matches_original(dota_root, monkeypatch):
    _jax_native_off(monkeypatch)
    zp = f"{dota_root}/frames/clip_000/images.zip"
    names = [f"{t:06d}.jpg" for t in range(0, 30, 7)]
    for resize in (None, (32, 24)):
        _equal(port_zip.decode_zip_frames(zp, names, resize=resize,
                                          native=False),
               jax_zip.decode_zip_frames(zp, names, resize=resize))
    _equal(port_zip.decode_scaled(zp, names, 32, 1.2),
           jax_zip.decode_scaled(zp, names, 32, 1.2))


def test_zip_decode_matches_original_native(dota_root, monkeypatch):
    _jax_native_on(monkeypatch)
    zp = f"{dota_root}/frames/clip_000/images.zip"
    names = [f"{t:06d}.jpg" for t in range(0, 30, 7)]
    for resize in (None, (32, 24)):
        _equal(port_zip.decode_zip_frames(zp, names, resize=resize,
                                          native=True),
               jax_zip.decode_zip_frames(zp, names, resize=resize))


@pytest.mark.parametrize("balanced_ratio", [None, 0.5])
def test_train_loader_matches_original(dota_root, monkeypatch,
                                       balanced_ratio):
    """The same batch order and contents for a seed (one decode thread:
    with several, both loaders yield batches in the order threads finish)."""
    _jax_native_off(monkeypatch)

    def batches(engine, fd):
        clips = fd.read_dota_clips(dota_root, "val_split.txt")
        ds = fd.FrameDataset(clips, mode="train", view_len=16, target_fps=5,
                             orig_fps=10, view_step=2, crop_size=32)
        loader = engine.TrainLoader(ds, 3, seed=7, num_threads=1,
                                    nb_samples_per_epoch=12, num_sample=2,
                                    balanced_ratio=balanced_ratio)
        return [loader.steps_per_epoch()] + list(loader.epoch(1))

    _equal(batches(port_engine, port_fd), batches(jax_engine, jax_fd))


def _pretrain_data(fd, pre, root, tmp):
    """Windows, one epoch of loader batches (one decode thread: with
    several, batches come in the order threads finish), the cycling zips,
    the Kinetics samplers and the view-list round trip."""
    clips = fd.read_dota_clips(root, "all_split.txt")
    ds = pre.PretrainWindowDataset(pre.ZipClipSource(clips, short_size=40),
                                   view_len=16, target_fps=10, orig_fps=10,
                                   view_step=4)
    loader = pre.PretrainLoader(ds, 2, window_size=(8, 2, 2), mask_ratio=0.75,
                                seed=3, num_threads=1)
    path = str(tmp / f"views_{pre.__name__.split('.')[0]}.txt")
    pre.save_view_list(ds.samples, path)

    def count(n):
        return lambda epoch: iter(range(epoch * 100, epoch * 100 + n))
    rng = np.random.default_rng(4)
    return [ds.samples, ds.get_window(1), loader.num_masked,
            loader.steps_per_epoch(), list(loader.epoch(1)),
            pre.load_view_list(path),
            list(pre.CyclicZip(count(5), count(2)).epoch(1)),
            list(pre.CyclicZipN(count(4), count(3), count(1)).epoch(2)),
            pre.tsn_train_indices(100, 16, 4, rng),
            pre.tsn_train_indices(30, 16, 4, rng, temporal_jitter=True),
            pre.sample_frame_window_indices(300, 30.0, 16, 10.0, rng)]


def test_pretrain_datasets_match_original(dota_root, monkeypatch, tmp_path):
    _jax_native_off(monkeypatch)
    _equal(_pretrain_data(port_fd, port_pre, dota_root, tmp_path),
           _pretrain_data(jax_fd, jax_pre, dota_root, tmp_path))


def test_read_dada_clips_matches_original(tmp_path):
    """The port's csv-module reader of DADA-2000's full_anno.csv against
    the original's pandas one: the same clips, labels, ego, night and TTC
    vectors, for every split (clips of both types, one with an accident,
    one at night)."""
    root = make_synthetic_dada(str(tmp_path / "dada"), n_clips=4,
                               frames_per_clip=60)
    for split in ("training.txt", "validation.txt", "all.txt"):
        path = f"DADA2K_my_split/{split}"
        _equal(port_fd.read_dada_clips(root, path, ttc_TT=1.5),
               jax_fd.read_dada_clips(root, path, ttc_TT=1.5))


@pytest.mark.parametrize("ties", [0, 1, 2], ids=["distinct", "round2",
                                                  "thirds"])
def test_exact_metrics_match_original(ties, monkeypatch):
    """binary_metrics(exact=True): the port's numpy AUROC (Mann-Whitney,
    ties at half weight) and AP (the step sum over distinct thresholds)
    against the original's scikit-learn ones, with scikit-learn blocked for
    the port: AP equal, AUROC within 1e-12 (the two sum in another order),
    the rest equal."""
    import sys
    rng = np.random.default_rng(3 + ties)
    labels = (rng.random(2000) < 0.3).astype(np.int64)
    probs = np.clip(labels * 0.2 + rng.random(2000) * 0.8, 0, 1)
    if ties == 1:
        probs = np.round(probs, 2)
    elif ties == 2:
        probs = np.round(probs * 3) / 3
    want = jax_metrics.binary_metrics(probs, labels, exact=True)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "sklearn", None)
        m.setitem(sys.modules, "sklearn.metrics", None)
        got = port_metrics.binary_metrics(probs, labels, exact=True)
    np.testing.assert_allclose(got.auroc, want.auroc, rtol=1e-12)
    assert got.ap == want.ap
    _equal(dataclasses.replace(got, auroc=want.auroc), want)
    with pytest.raises(ValueError, match="one class"):
        port_metrics.roc_auc_score(np.zeros(4), np.arange(4.0))


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    """Videos whose pixel value encodes the frame index (40 and 23 frames,
    64 x 48), a raw-frame folder of 24 frames, and each family's
    annotations over them."""
    import cv2
    root = tmp_path_factory.mktemp("cls")
    paths = []
    for i, n in enumerate((40, 23)):
        path = root / f"v{i}.avi"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (64, 48))
        for t in range(n):
            wr.write(np.full((48, 64, 3), (5 * t + 17 * i) % 256, np.uint8))
        wr.release()
        paths.append(str(path))
    frames = root / "rf0"
    frames.mkdir()
    for t in range(24):
        cv2.imwrite(str(frames / f"img_{t + 1:05}.jpg"),
                    np.full((40, 56, 3), 10 * t, np.uint8))
    annos = {
        "kinetics": "".join(f"{p},{i}\n" for i, p in enumerate(paths)),
        "anet": f"{paths[0]} 4.0 0.5 3.5 0\n{paths[1]} -1 -1 -1 1\n",
        "hmdb": "".join(f"{p} {i}\n" for i, p in enumerate(paths)),
        "rawframe": f"{frames} 24 1\n"}
    out = {}
    for name, text in annos.items():
        (root / f"{name}.txt").write_text(text)
        out[name] = str(root / f"{name}.txt")
    return out


def _cls_views(m, annos):
    """Every getter of every reader: train clips (seeded, TSN and sparse
    sampling), validation clips, every test view; build_cls_dataset's
    class for each --data_set name."""
    out = []
    for data_set, anno in (("Kinetics", "kinetics"), ("ANet", "anet"),
                           ("HMDB51", "hmdb"),
                           ("HMDB51_rawframe", "rawframe")):
        for sparse in (False, True):
            kw = dict(clip_len=4, frame_sample_rate=3, crop_size=32,
                      short_side_size=40, sparse_sampling=sparse)
            train = m.build_cls_dataset(data_set, annos[anno], "",
                                        mode="train", **kw)
            rng = np.random.default_rng(5)
            out.append([type(train).__name__, len(train)]
                       + [train.get_train_clip(i, rng)
                          for i in range(len(train))])
            val = m.build_cls_dataset(data_set, annos[anno], "",
                                      mode="validation", **kw)
            out.append([val.get_val_clip(i) for i in range(len(val))])
            test = m.build_cls_dataset(data_set, annos[anno], "",
                                       mode="test", test_num_segment=2,
                                       test_num_crop=3, **kw)
            out.append([test.test_views]
                       + [test.get_test_view(i) for i in range(len(test))])
    return out


def test_video_cls_datasets_match_original(cls_root):
    """The copied action-recognition readers (Kinetics / SSV2 CSV, the
    ANet interval reader with and without an interval, HMDB51 videos and
    raw frames), train / validation / test getters and the --data_set
    dispatch give the original's outputs."""
    _equal(_cls_views(port_cls, cls_root), _cls_views(jax_cls, cls_root))
    for name, anno in (("hacs", "anet"), ("HMDB", "hmdb"),
                       ("hmdb_rawframe", "rawframe"), ("SSV2", "kinetics")):
        assert (type(port_cls.build_cls_dataset(name, cls_root[anno],
                                                "")).__name__
                == type(jax_cls.build_cls_dataset(name, cls_root[anno],
                                                  "")).__name__)


def test_merge_test_views_matches_original():
    rng = np.random.default_rng(8)
    vids = [f"v{i % 7}" for i in range(40)]
    labels = [int(v[1:]) % 5 for v in vids]
    logits = [rng.normal(0, 2, 9) + 3 * np.eye(9)[y] * (i % 3 > 0)
              for i, y in enumerate(labels)]
    _equal(port_cls.merge_test_views(logits, vids, labels),
           jax_cls.merge_test_views(logits, vids, labels))
