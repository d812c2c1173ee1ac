"""Action-recognition classification datasets (Kinetics / SSV2 style).

Copy of simple_tad_tpu/data/video_cls_datasets.py (the port cannot import
the JAX package), held to the original by tests/test_torch_host_copies.py,
with one change: cv2 is imported inside the functions that decode or
resize, so the port imports no cv2 at module level.

Behavioral reference: VideoClsDataset (kinetics.py:27-291) and
SSVideoClsDataset (ssv2.py:13+): CSV annotations (path, label), TSN
temporal sampling for training, center-crop validation, and the
multi-(segment x crop) test protocol whose views are softmax-averaged per
video (engine_for_finetuning.py:182-283).

Decode goes through cv2.VideoCapture; spatial augmentation runs on the
device (ops/augment.py: random_resized_crop + flip + full RandAugment +
normalize + erasing), so the getters return raw uint8.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_cls_annotations(anno_path: str, delimiter: str = ","
                         ) -> Tuple[List[str], List[int]]:
    paths, labels = [], []
    with open(anno_path) as f:
        for row in csv.reader(f, delimiter=delimiter):
            if not row:
                continue
            paths.append(row[0])
            labels.append(int(row[-1]))
    return paths, labels


class VideoClsDataset:
    """mode: train | validation | test.

    Test views enumerate (segment, crop) pairs per video
    (kinetics.py:86-95): test_num_segment temporal chunks x test_num_crop
    spatial crops along the long side.
    """

    def __init__(self, anno_path: str, data_path: str, mode: str = "train",
                 clip_len: int = 16, frame_sample_rate: int = 4,
                 crop_size: int = 224, short_side_size: int = 256,
                 num_segment: int = 1, test_num_segment: int = 5,
                 test_num_crop: int = 3, sparse_sampling: bool = False,
                 delimiter: str = ","):
        self.anno_path = anno_path
        self.data_path = data_path
        self.mode = mode
        self.clip_len = clip_len
        self.frame_sample_rate = frame_sample_rate
        self.crop_size = crop_size
        self.short_side_size = short_side_size
        self.num_segment = num_segment
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        self.sparse_sampling = sparse_sampling   # SSV2-style TSN segments

        self.samples, self.label_array = read_cls_annotations(anno_path,
                                                              delimiter)
        if mode == "test":
            self.test_views = [
                (idx, ck, cp)
                for ck in range(test_num_segment)
                for cp in range(test_num_crop)
                for idx in range(len(self.samples))]

    def __len__(self):
        if self.mode == "test":
            return len(self.test_views)
        return len(self.samples)

    def _video_path(self, sample: str) -> str:
        if os.path.isabs(sample):
            return sample
        return os.path.join(self.data_path, sample)

    def _read_frames(self, path: str, indices: Sequence[int]) -> np.ndarray:
        import cv2
        cap = cv2.VideoCapture(path)
        out = {}
        pos = -10
        for i in sorted(set(int(i) for i in indices)):
            if i != pos + 1:
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            pos = i
            if not ok:
                cap.release()
                raise IOError(f"cannot read frame {i} of {path}")
            out[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        cap.release()
        return np.stack([out[int(i)] for i in indices])

    def _num_frames(self, path: str) -> int:
        import cv2
        cap = cv2.VideoCapture(path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        return n

    def _resize_short_side(self, frames: np.ndarray, size: int
                           ) -> np.ndarray:
        import cv2
        h, w = frames.shape[1:3]
        if h < w:
            nh, nw = size, int(round(w * size / h))
        else:
            nh, nw = int(round(h * size / w)), size
        return np.stack([cv2.resize(f, (nw, nh),
                                    interpolation=cv2.INTER_LINEAR)
                         for f in frames])

    def _train_indices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if self.sparse_sampling:
            # SSV2 TSN: split into clip_len segments, one random frame each
            edges = np.linspace(0, n, self.clip_len + 1)
            return np.array([
                int(rng.integers(int(edges[i]),
                                 max(int(edges[i + 1]), int(edges[i]) + 1)))
                for i in range(self.clip_len)]).clip(0, n - 1)
        span = self.clip_len * self.frame_sample_rate
        start = int(rng.integers(0, max(n - span, 1)))
        idx = start + np.arange(self.clip_len) * self.frame_sample_rate
        return np.clip(idx, 0, n - 1)

    def _eval_indices(self, n: int, segment: int = 0,
                      n_segments: int = 1) -> np.ndarray:
        if self.sparse_sampling:
            edges = np.linspace(0, max(n - 1, 0), self.clip_len)
            return edges.round().astype(int).clip(0, max(n - 1, 0))
        span = self.clip_len * self.frame_sample_rate
        if n_segments == 1:
            start = max((n - span) // 2, 0)
        else:
            start = int(np.linspace(0, max(n - span, 0),
                                    n_segments)[segment])
        idx = start + np.arange(self.clip_len) * self.frame_sample_rate
        return np.clip(idx, 0, n - 1)

    def get_train_clip(self, index: int, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, int]:
        path = self._video_path(self.samples[index])
        n = self._num_frames(path)
        frames = self._read_frames(path, self._train_indices(n, rng))
        frames = self._resize_short_side(frames, self.short_side_size)
        return frames, self.label_array[index]

    def get_val_clip(self, index: int) -> Tuple[np.ndarray, int]:
        """Resize short side + center crop (kinetics.py:67-74)."""
        path = self._video_path(self.samples[index])
        n = self._num_frames(path)
        frames = self._read_frames(path, self._eval_indices(n))
        frames = self._resize_short_side(frames, self.short_side_size)
        h, w = frames.shape[1:3]
        y0 = (h - self.crop_size) // 2
        x0 = (w - self.crop_size) // 2
        return (frames[:, y0:y0 + self.crop_size, x0:x0 + self.crop_size],
                self.label_array[index])

    def get_test_view(self, view_idx: int
                      ) -> Tuple[np.ndarray, int, str, int, int]:
        """-> (clip, label, video_id, segment, crop)."""
        index, ck, cp = self.test_views[view_idx]
        path = self._video_path(self.samples[index])
        n = self._num_frames(path)
        frames = self._read_frames(
            path, self._eval_indices(n, ck, self.test_num_segment))
        frames = self._resize_short_side(frames, self.short_side_size)
        h, w = frames.shape[1:3]
        c = self.crop_size
        if w >= h:   # crops along the long (width) side
            xs = np.linspace(0, w - c, self.test_num_crop).astype(int)
            x0, y0 = xs[cp], (h - c) // 2
        else:
            ys = np.linspace(0, h - c, self.test_num_crop).astype(int)
            x0, y0 = (w - c) // 2, ys[cp]
        return (frames[:, y0:y0 + c, x0:x0 + c],
                self.label_array[index], self.samples[index], ck, cp)


class ANetVideoDataset(VideoClsDataset):
    """ActivityNet / HACS temporal-interval classification
    (other_models/InternVideo2_single_modality/datasets/anet.py:27-315):
    5-column whitespace annotations (path, total_time, start_time,
    end_time, label); frames are TSN-sampled INSIDE the annotated
    [start_time, end_time] span of the video (random offset per segment
    in training, chunk-indexed deterministic offsets at test)."""

    def __init__(self, anno_path: str, data_path: str, **kw):
        kw.setdefault("delimiter", " ")
        super().__init__(anno_path, data_path, **kw)
        self.times: List[Tuple[float, float, float]] = []
        with open(anno_path) as f:
            for row in csv.reader(f, delimiter=kw["delimiter"]):
                if not row:
                    continue
                self.times.append((float(row[1]), float(row[2]),
                                   float(row[3])))

    def _span(self, path: str, index: int) -> Tuple[int, int]:
        """(start_frame, span_frames) of the annotated interval
        (anet.py:302-306)."""
        n = self._num_frames(path)
        tt, st, et = self.times[index]
        if tt != -1 and st != -1 and et != -1:
            fps = n / tt
            return int(fps * st), max(int(fps * (et - st)), 1)
        return 0, n

    def _seq_frames(self, dur: int, start: int, clip_idx: int,
                    n_chunks: int = 1,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """_get_seq_frames (anet.py:249-271): clip_len segments over the
        span; clip_idx=-1 random-in-segment (endpoints inclusive), else
        offset (clip_idx+1)/(n_chunks+1) into each segment."""
        seg = max(0.0, float(dur - 1) / self.clip_len)
        idx = []
        for i in range(self.clip_len):
            lo = int(np.round(seg * i))
            if clip_idx == -1:
                hi = int(np.round(seg * (i + 1)))
                j = int(rng.integers(lo, hi + 1))
            else:
                j = lo + int(seg / (n_chunks + 1) * (clip_idx + 1))
            idx.append(min(j, dur - 1))
        return np.asarray(idx) + start

    def get_train_clip(self, index: int, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, int]:
        path = self._video_path(self.samples[index])
        start, dur = self._span(path, index)
        frames = self._read_frames(
            path, self._seq_frames(dur, start, -1, rng=rng))
        frames = self._resize_short_side(frames, self.short_side_size)
        return frames, self.label_array[index]

    def get_val_clip(self, index: int) -> Tuple[np.ndarray, int]:
        path = self._video_path(self.samples[index])
        start, dur = self._span(path, index)
        frames = self._read_frames(path, self._seq_frames(dur, start, 0))
        frames = self._resize_short_side(frames, self.short_side_size)
        h, w = frames.shape[1:3]
        y0 = (h - self.crop_size) // 2
        x0 = (w - self.crop_size) // 2
        return (frames[:, y0:y0 + self.crop_size, x0:x0 + self.crop_size],
                self.label_array[index])

    def get_test_view(self, view_idx: int
                      ) -> Tuple[np.ndarray, int, str, int, int]:
        index, ck, cp = self.test_views[view_idx]
        path = self._video_path(self.samples[index])
        start, dur = self._span(path, index)
        frames = self._read_frames(
            path, self._seq_frames(dur, start, ck, self.test_num_segment))
        frames = self._resize_short_side(frames, self.short_side_size)
        h, w = frames.shape[1:3]
        c = self.crop_size
        if w >= h:
            xs = np.linspace(0, w - c, self.test_num_crop).astype(int)
            x0, y0 = xs[cp], (h - c) // 2
        else:
            ys = np.linspace(0, h - c, self.test_num_crop).astype(int)
            x0, y0 = (w - c) // 2, ys[cp]
        return (frames[:, y0:y0 + c, x0:x0 + c],
                self.label_array[index], self.samples[index], ck, cp)


class HMDBVideoDataset(VideoClsDataset):
    """HMDB51 video classification (datasets/hmdb.py:337-612
    HMDBVideoClsDataset): 2-column whitespace annotations, TSN sampling
    with floor-division segments — train i*avg + rand(avg), validation
    segment centers tick/2 + tick*i, test chunk ck offset
    ck*tick/test_num_segment + tick*i (hmdb.py:576-604, :260-268)."""

    def __init__(self, anno_path: str, data_path: str, **kw):
        kw.setdefault("delimiter", " ")
        super().__init__(anno_path, data_path, **kw)

    def _train_indices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        k = self.clip_len
        avg = n // k
        if avg > 0:
            idx = np.arange(k) * avg + rng.integers(0, avg, k)
        elif n > k:
            idx = np.sort(rng.integers(0, n, k))
        else:
            idx = np.zeros(k, int)
        return np.clip(idx, 0, max(n - 1, 0))

    def _eval_indices(self, n: int, segment: int = 0,
                      n_segments: int = 1) -> np.ndarray:
        k = self.clip_len
        tick = n / float(k)
        if n_segments == 1:   # validation: segment centers
            idx = np.array([int(tick / 2.0 + tick * i) for i in range(k)])
        else:                 # test chunk
            idx = np.array([int(segment * tick / n_segments + tick * i)
                            for i in range(k)])
        return np.clip(idx, 0, max(n - 1, 0))


class HMDBRawFrameDataset(HMDBVideoDataset):
    """HMDB51 raw-frame folders (datasets/hmdb.py:26-334
    HMDBRawFrameClsDataset): 3-column whitespace annotations (folder,
    total_frames, label) with total_frames stored as max-1 (:67); frames
    are 1-indexed ``img_{:05}.jpg`` files (:272)."""

    filename_tmpl = "img_{:05}.jpg"

    def __init__(self, anno_path: str, data_path: str, **kw):
        super().__init__(anno_path, data_path, **kw)
        self._totals = {}
        with open(anno_path) as f:
            for row in csv.reader(f, delimiter=" "):
                if not row:
                    continue
                self._totals[self._video_path(row[0])] = int(row[1]) - 1

    def _num_frames(self, path: str) -> int:
        return self._totals[path]

    def _read_frames(self, path: str, indices: Sequence[int]) -> np.ndarray:
        import cv2
        frames = []
        for i in indices:
            fname = os.path.join(path, self.filename_tmpl.format(int(i) + 1))
            img = cv2.imread(fname, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"cannot read {fname}")
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(frames)


def build_cls_dataset(data_set: str, anno_path: str, data_path: str,
                      **kw):
    """--data_set dispatch (run_linear_probing.py:188-193 choices):
    Kinetics/SSV2-style CSV sources -> VideoClsDataset (sparse_sampling
    selects the SSV2 TSN variant); ANet/HACS -> interval reader;
    HMDB51 -> video TSN reader (use_decord) or raw-frame folders."""
    key = data_set.lower()
    if key in ("anet", "hacs", "anet_interval", "hacs_interval"):
        return ANetVideoDataset(anno_path, data_path, **kw)
    if key in ("hmdb51", "hmdb"):
        return HMDBVideoDataset(anno_path, data_path, **kw)
    if key in ("hmdb51_rawframe", "hmdb_rawframe"):
        return HMDBRawFrameDataset(anno_path, data_path, **kw)
    return VideoClsDataset(anno_path, data_path, **kw)


def merge_test_views(view_logits: Sequence[np.ndarray],
                     video_ids: Sequence[str],
                     labels: Sequence[int]) -> Tuple[float, float]:
    """Softmax-average all views of each video, report top-1/top-5 x100
    (engine_for_finetuning.py merge :235-283)."""
    feats = {}
    lab = {}
    for logit, vid, y in zip(view_logits, video_ids, labels):
        z = np.asarray(logit, np.float64)
        z = np.exp(z - z.max())
        z /= z.sum()
        feats.setdefault(vid, []).append(z)
        lab[vid] = y
    top1 = top5 = 0
    for vid, probs in feats.items():
        avg = np.mean(probs, axis=0)
        order = np.argsort(avg)[::-1]
        top1 += int(order[0] == lab[vid])
        top5 += int(lab[vid] in order[:5])
    n = len(feats)
    return 100.0 * top1 / n, 100.0 * top5 / n
