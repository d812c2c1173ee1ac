"""Masked-video-modeling (MAE/DAPT) pre-training datasets and loaders.

Copy of simple_tad_tpu/data/pretrain_datasets.py (the port cannot import
the JAX package), held to the original by tests/test_torch_host_copies.py,
with one change: cv2 is imported inside the functions that decode or
resize, so the port imports no cv2 at module level.  References:
VideoMAE_DoTA (dota.py:463-755), VideoMAE_DADA2K (dada.py:452+),
VideoMAE_BDD100K (bdd100k.py:26+), build_pretraining_dataset
(datasets_frame.py:71-199) and CyclicDataLoader
(run_mae_double_pretraining.py:25-41).

Split of the work: the host enumerates windows (RegularSequencer), decodes
at half resolution with short side 320 (dota.py:635-663), draws the tube
masks and assembles batches in threads; the device runs the whole
augmentation (ops/augment.py:pretrain_augment_orig / _align).  Video-file
sources (BDD100K .mov, Kinetics .mp4) decode through cv2.VideoCapture;
frame-accurate seeks are positioned reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from simple_tad_tpu_torch.data.frame_datasets import ClipInfo
from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
from simple_tad_tpu_torch.data.prefetch import ordered_batches
from simple_tad_tpu_torch.data.sequencing import (
    RegularSequencer, RegularSequencerWithStart)
from simple_tad_tpu_torch.data.zipreader import decode_zip_frames


def _half_then_short_side(img: np.ndarray, short_size: int = 320
                          ) -> np.ndarray:
    """dota.py:648-660: 0.5x cubic downscale then short-side -> 320
    bilinear."""
    import cv2
    img = cv2.resize(img, dsize=(0, 0), fx=0.5, fy=0.5,
                     interpolation=cv2.INTER_CUBIC)
    h, w = img.shape[:2]
    if h < w:
        nh, nw = short_size, int(w * short_size / h)
    else:
        nh, nw = int(h * short_size / w), short_size
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


class ZipClipSource:
    """Frame source over ClipInfo zips (DoTA/DADA)."""

    def __init__(self, clips: Sequence[ClipInfo], short_size: int = 320):
        self.clips = list(clips)
        self.short_size = short_size

    def __len__(self):
        return len(self.clips)

    def num_frames(self, clip_idx: int) -> int:
        return len(self.clips[clip_idx].frame_names)

    def read_window(self, clip_idx: int, frame_idx: Sequence[int]
                    ) -> np.ndarray:
        clip = self.clips[clip_idx]
        names = [clip.frame_names[i] for i in frame_idx]
        frames = decode_zip_frames(clip.zip_path, names)
        return np.stack([_half_then_short_side(f, self.short_size)
                         for f in frames])


def _short_side(img: np.ndarray, short_size: int = 320) -> np.ndarray:
    """Aspect-preserving short-side resize WITHOUT the 0.5x pre-downscale
    (kinetics.py:764-775 — Kinetics videos are not 2x-oversized like the
    DoTA/DADA frame dumps, so no half step).  Never upsamples beyond the
    source (min(h, w, short_size), kinetics.py:706)."""
    import cv2
    h, w = img.shape[:2]
    short = min(h, w, short_size)
    if h < w:
        nh, nw = short, int(w * short / h)
    else:
        nh, nw = int(h * short / w), short
    if (nh, nw) == (h, w):
        return img
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


class VideoFileSource:
    """Frame source over raw video files (BDD100K .mov, Kinetics .mp4)
    via cv2.VideoCapture (decord replacement, SURVEY.md §2c).

    ``half_first`` keeps the DoTA-style 0.5x cubic pre-downscale
    (dota.py:648-660); Kinetics sources pass False for the plain
    short-side-320 policy (kinetics.py:764-775)."""

    def __init__(self, paths: Sequence[str], short_size: int = 320,
                 frame_counts: Optional[Sequence[int]] = None,
                 half_first: bool = True):
        import cv2
        self.paths = list(paths)
        self.short_size = short_size
        self.half_first = half_first
        if frame_counts is None:
            frame_counts = []
            for p in self.paths:
                cap = cv2.VideoCapture(p)
                frame_counts.append(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
                cap.release()
        self.frame_counts = list(frame_counts)
        self._fps_cache: Dict[int, float] = {}

    def __len__(self):
        return len(self.paths)

    def num_frames(self, clip_idx: int) -> int:
        return self.frame_counts[clip_idx]

    def fps(self, clip_idx: int) -> float:
        import cv2
        if clip_idx not in self._fps_cache:
            cap = cv2.VideoCapture(self.paths[clip_idx])
            self._fps_cache[clip_idx] = cap.get(cv2.CAP_PROP_FPS)
            cap.release()
        return self._fps_cache[clip_idx]

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self.half_first:
            return _half_then_short_side(frame, self.short_size)
        return _short_side(frame, self.short_size)

    def read_window(self, clip_idx: int, frame_idx: Sequence[int]
                    ) -> np.ndarray:
        import cv2
        cap = cv2.VideoCapture(self.paths[clip_idx])
        out = {}
        need = sorted(set(int(i) for i in frame_idx))
        pos = -10
        for i in need:
            if i != pos + 1:
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            pos = i
            if not ok:
                raise IOError(
                    f"failed to read frame {i} of {self.paths[clip_idx]}")
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            out[i] = self._resize(frame)
        cap.release()
        return np.stack([out[int(i)] for i in frame_idx])


# bdd100k.py:20-22: extensions the reference scans for, plus the one video
# it hard-removes from every split (corrupt in the released set)
BDD_VIDEO_EXT = (".mov", ".mp4", ".avi", ".mkv")
BDD_IGNORE_VIDEOS = ("val/c4742900-81aa45ae.mov",)


def read_bdd_clips(data_path: str, clips_list: Optional[str] = None
                   ) -> List[str]:
    """Relative BDD100K video names under ``data_path``/videos.

    With ``clips_list`` (a txt of relative names, one per line) this is
    VideoMAE_BDD100K_prepared._make_dataset_snellius (bdd100k.py:171-177)
    — the list is taken VERBATIM (no ignore filter, matching the
    reference) because a paired view_list's clip indices were computed
    against the unfiltered list; filtering here would silently shift
    every subsequent view onto the wrong clip (ADVICE r3).  A known-bad
    name in the list raises instead.  Without a list, the videos tree is
    scanned like the split files the reference feeds
    _make_dataset_snellius (bdd100k.py:151-161), dropping the corrupt
    ``ignore_videos`` entries (bdd100k.py:21-22,157-159).
    """
    if clips_list:
        with open(clips_list) as f:
            names = [line.rstrip() for line in f if line.strip()]
        bad = sorted(set(names) & set(BDD_IGNORE_VIDEOS))
        assert not bad, (
            f"clips_list contains known-corrupt video(s) {bad}; remove "
            "them from the list AND regenerate the paired view_list "
            "(indices must stay aligned)")
    else:
        root = os.path.join(data_path, "videos")
        names = []
        for dirpath, _dirnames, filenames in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            for fn in filenames:
                if fn.lower().endswith(BDD_VIDEO_EXT):
                    names.append(fn if rel == "." else os.path.join(rel, fn))
        names.sort()
        names = [n for n in names if n not in BDD_IGNORE_VIDEOS]
    assert names, f"no BDD100K videos found under {data_path}"
    return names


def load_view_list(path: str):
    """Read a precomputed (clip_idx, frame_indices) view list.

    Two formats, matching the reference's *_prepared datasets:
      .txt — lines ``clip_idx, [f0, f1, ...]`` (bdd100k.py:179-188)
      .pkl — pickled list of (clip_idx, frame_indices) (dada.py:686-691)
    Skipping the per-clip duration scan at startup is the whole point:
    for thousands of videos that scan costs minutes per run.
    """
    samples = []
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            for ci, seq in pickle.load(f):
                samples.append((int(ci), np.asarray(seq, np.int64)))
        return samples
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ci, rest = line.split(",", 1)
            seq = [int(x) for x in rest.strip().strip("[]").split(",")]
            samples.append((int(ci), np.asarray(seq, np.int64)))
    return samples


def save_view_list(samples, path: str) -> None:
    """Write samples in the .txt view-list format (see load_view_list)."""
    with open(path, "w") as f:
        for ci, seq in samples:
            f.write(f"{int(ci)}, [{', '.join(str(int(x)) for x in seq)}]\n")


class PretrainWindowDataset:
    """Window enumeration over a frame source (RegularSequencer,
    dota.py:611-633).  Pass ``view_list`` to load precomputed views
    instead of scanning clip durations (the *_prepared variants,
    bdd100k.py:164-188, dada.py:666-691).

    ``with_start=True`` switches to RegularSequencerWithStart, which BDD100K
    pretraining uses (bdd100k.py:32,38-49 — the sequencer built in __init__
    is the one _prepare_views consumes there).  VideoMAE_DoTA also builds a
    WithStart sequencer (dota.py:555) but its _prepare_views shadows it with
    a fresh plain RegularSequencer (dota.py:619), so DoTA/DADA keep the
    default False."""

    def __init__(self, source, *, view_len: int = 16, target_fps: int = 10,
                 orig_fps: int = 10, view_step: int = 4,
                 view_list: Optional[str] = None, with_start: bool = False):
        self.source = source
        if view_list:
            self.samples = load_view_list(view_list)
            return
        seq_cls = RegularSequencerWithStart if with_start else RegularSequencer
        seq = seq_cls(seq_frequency=target_fps, seq_length=view_len,
                      step=view_step)
        self.samples = []
        for ci in range(len(source)):
            seqs = seq.get_sequences(source.num_frames(ci), orig_fps)
            if seqs is None:
                continue
            self.samples.extend((ci, np.asarray(s)) for s in seqs)

    def __len__(self):
        return len(self.samples)

    def get_window(self, index: int) -> np.ndarray:
        ci, fidx = self.samples[index]
        return self.source.read_window(ci, fidx)


class PretrainLoader:
    """Threaded batches of {video_u8 (B,T,H,W,C), mask (B,N)}.

    Window masks come from TubeMaskingGenerator.batch; frame spatial sizes
    can vary per source clip, so windows are center-padded/cropped to the
    batch's first window shape (sources normalize short side to 320, so
    shapes only differ in the long side by a few px across aspect ratios).
    With ``world`` > 1, ``batch_size`` is the global batch and each batch
    holds, and decodes, only this ``rank``'s rows of it and of its masks
    (parallel/mesh.py:rank_rows; the crop to the smallest window is then
    taken over the rank's rows).  The decode threads hand the batches over
    in the epoch's order (data/prefetch.py), where the JAX package's come
    in the order the threads finish.
    """

    def __init__(self, dataset: PretrainWindowDataset, batch_size: int, *,
                 window_size, mask_ratio: float, seed: int = 0,
                 nb_samples_per_epoch: int = 0, num_threads: int = 4,
                 prefetch: int = 4, mask_type: str = "tube", rank: int = 0,
                 world: int = 1):
        from simple_tad_tpu_torch.data.masking import make_mask_generator
        from simple_tad_tpu_torch.parallel.mesh import rank_rows
        self.dataset = dataset
        self.rows = rank_rows(batch_size, rank, world)
        self.batch_size = batch_size
        self.maskgen = make_mask_generator(mask_type, window_size,
                                           mask_ratio)
        self.seed = seed
        self.cap = nb_samples_per_epoch
        self.num_threads = num_threads
        self.prefetch = prefetch

    @property
    def num_masked(self) -> int:
        return self.maskgen.total_masks

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.cap:
            n = min(n, self.cap)
        return n // self.batch_size

    @staticmethod
    def _fit(frames: np.ndarray, h: int, w: int) -> np.ndarray:
        """Center crop/pad (T, H, W, C) to (T, h, w, C)."""
        T, H, W, C = frames.shape
        if H == h and W == w:
            return frames
        out = np.zeros((T, h, w, C), frames.dtype)
        sh, dh = max(0, (H - h) // 2), max(0, (h - H) // 2)
        sw, dw = max(0, (W - w) // 2), max(0, (w - W) // 2)
        ch, cw = min(h, H), min(w, W)
        out[:, dh:dh + ch, dw:dw + cw] = frames[:, sh:sh + ch, sw:sw + cw]
        return out

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch_idx)   # re-randomize K700 windows
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(len(self.dataset))
        if self.cap:
            order = order[:self.cap]
        n_batches = len(order) // self.batch_size
        rows = order[:n_batches * self.batch_size].reshape(
            n_batches, self.batch_size)
        mask_rng = np.random.default_rng(self.seed * 7919 + epoch_idx)

        def make(row):
            wins = [self.dataset.get_window(int(i)) for i in row[self.rows]]
            h = min(w.shape[1] for w in wins)
            wmin = min(w.shape[2] for w in wins)
            return np.stack([self._fit(w, h, wmin) for w in wins])

        for video in ordered_batches(rows, make, self.num_threads,
                                     self.prefetch):
            mask = self.maskgen.batch(self.batch_size, mask_rng)
            yield {"video_u8": video, "mask": mask[self.rows]}


class CyclicZip:
    """Zip two epoch iterators, cycling the shorter one
    (CyclicDataLoader, run_mae_double_pretraining.py:25-41): the epoch ends
    when the longer iterator ends."""

    def __init__(self, make_long, make_short):
        self.make_long = make_long
        self.make_short = make_short

    def epoch(self, epoch_idx: int):
        short_iter = self.make_short(epoch_idx)
        cycle = epoch_idx
        for batch_long in self.make_long(epoch_idx):
            try:
                batch_short = next(short_iter)
            except StopIteration:
                cycle += 1
                short_iter = self.make_short(cycle * 1000 + epoch_idx)
                batch_short = next(short_iter)
            yield batch_long, batch_short


class CyclicZipN:
    """N-loader generalization of CyclicZip for the triple pretrain loop
    (train_one_epoch_triple, engine_for_pretraining.py:310-355): the
    FIRST iterator drives the epoch; every other iterator cycles when
    exhausted.  (The reference plain-zips three loaders so the shortest
    ends the epoch — and then reads batch2 twice where it means batch3, a
    bug this rebuild does not reproduce; cycling matches the double
    loop's CyclicDataLoader semantics instead.)"""

    def __init__(self, make_lead, *make_others):
        self.make_lead = make_lead
        self.make_others = make_others

    def epoch(self, epoch_idx: int):
        iters = [m(epoch_idx) for m in self.make_others]
        cycles = [epoch_idx] * len(iters)
        for batch_lead in self.make_lead(epoch_idx):
            out = [batch_lead]
            for i, m in enumerate(self.make_others):
                try:
                    out.append(next(iters[i]))
                except StopIteration:
                    cycles[i] += 1
                    iters[i] = m(cycles[i] * 1000 + epoch_idx)
                    out.append(next(iters[i]))
            yield tuple(out)


def read_kinetics_clips(root: str, setting: str = "annotations/train.csv",
                        ignore_file: Optional[str] = None,
                        require_exists: bool = True) -> List[str]:
    """Kinetics-700 clip paths from the official CSV layout
    (kinetics.py _make_dataset_snellius:666-682): columns label /
    youtube_id / time_start / time_end; file at
    {root}/{subset}/{label}/{ytid}_{t1:06d}_{t2:06d}.mp4 where subset is
    the CSV basename.  ``ignore_file`` lists corrupt youtube ids one per
    line (the reference hardcodes kinetics_700_ignore_list)."""
    import csv

    subset = os.path.splitext(os.path.basename(setting))[0]
    csv_path = os.path.join(root, setting)
    if not os.path.exists(csv_path):
        raise FileNotFoundError(csv_path)
    ignore = set()
    if ignore_file and os.path.exists(ignore_file):
        with open(ignore_file) as f:
            ignore = {line.strip() for line in f if line.strip()}
    paths = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            ytid = row["youtube_id"]
            if ytid in ignore:
                continue
            t1 = str(int(float(row["time_start"]))).zfill(6)
            t2 = str(int(float(row["time_end"]))).zfill(6)
            p = os.path.join(root, subset, row["label"],
                             f"{ytid}_{t1}_{t2}.mp4")
            if require_exists and not os.path.exists(p):
                raise FileNotFoundError(p)
            paths.append(p)
    return paths


def tsn_train_indices(n_frames: int, new_length: int, new_step: int,
                      rng: np.random.Generator, num_segments: int = 1,
                      temporal_jitter: bool = False) -> np.ndarray:
    """TSN-style training frame indices (kinetics.py
    _sample_train_indices:684-704 + the frame-id walk of
    _video_TSN_decord_batch_loader:745-757), restated with an explicit rng.

    Returns 0-based frame ids of length num_segments * new_length."""
    skip_length = new_length * new_step
    avg = (n_frames - skip_length + 1) // num_segments
    if avg > 0:
        offsets = (np.arange(num_segments) * avg
                   + rng.integers(0, avg, size=num_segments))
    elif n_frames > max(num_segments, skip_length):
        offsets = np.sort(rng.integers(0, n_frames - skip_length + 1,
                                       size=num_segments))
    else:
        offsets = np.zeros(num_segments, np.int64)
    offsets = offsets + 1          # reference returns 1-based offsets
    if temporal_jitter:
        skip_offsets = rng.integers(0, new_step,
                                    size=skip_length // new_step)
    else:
        skip_offsets = np.zeros(skip_length // new_step, np.int64)

    ids = []
    for seg in offsets:
        offset = int(seg)
        for i in range(skip_length // new_step):
            if offset + skip_offsets[i] <= n_frames:
                ids.append(offset + int(skip_offsets[i]) - 1)
            else:
                ids.append(offset - 1)
            if offset + new_step < n_frames:
                offset += new_step
    return np.asarray(ids, np.int64)


class KineticsPretrainDataset:
    """Kinetics-700 MAE pretraining samples: ONE window per video per
    epoch (kinetics.py VideoMAE:577-597 / VideoMAE_aligned:976-1009).

    mode 'tsn'     — TSN random-offset window at stride sampling_rate
                     (the --data_set K700 recipe, jobs/dapt/pretrain_k700.sh)
    mode 'aligned' — fps-aligned window by linear frame interpolation at
                     target_fps (--data_set K700_aligned,
                     kinetics.py:850+ VideoMAE_aligned)

    Sampling is deterministic per (seed, epoch, index) — the loader calls
    set_epoch() so windows resample every epoch like the reference's
    per-__getitem__ RNG draws, but reproducibly."""

    def __init__(self, source, *, view_len: int = 16, sampling_rate: int = 4,
                 mode: str = "tsn", target_fps: float = 10.0, seed: int = 0,
                 temporal_jitter: bool = False):
        if mode not in ("tsn", "aligned"):
            raise ValueError(mode)
        self.source = source
        self.view_len = view_len
        self.sampling_rate = sampling_rate
        self.mode = mode
        self.target_fps = target_fps
        self.seed = seed
        self.temporal_jitter = temporal_jitter
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.source)

    def get_window(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self._epoch) * 1_000_003 + index)
        if self.mode == "aligned":
            return sample_interpolated_window(
                self.source, index, self.view_len, self.target_fps,
                self.source.fps(index), rng)
        idx = tsn_train_indices(self.source.num_frames(index),
                                self.view_len, self.sampling_rate, rng,
                                temporal_jitter=self.temporal_jitter)
        return self.source.read_window(index, idx)


def sample_frame_window_indices(n_frames: int, src_fps: float,
                                new_length: int, target_fps: float,
                                rng: np.random.Generator) -> np.ndarray:
    """Random fps-decimated window (kinetics.py sample_frame_window:294-313):
    step = src_fps // target_fps, random start so the window fits."""
    step = max(int(src_fps // target_fps), 1)
    window = new_length * step
    if n_frames < window:
        raise ValueError(f"video too short ({n_frames}) for window {window}")
    start = int(rng.integers(0, n_frames - window + 1))
    return start + np.arange(new_length) * step


def sample_interpolated_window(source, clip_idx: int, new_length: int,
                               target_fps: float, src_fps: float,
                               rng: np.random.Generator) -> np.ndarray:
    """fps-aligned window by LINEAR FRAME INTERPOLATION
    (kinetics.py sample_interpolated_window:317-366, used by
    VideoMAE_aligned): desired timestamps t0 + i/target_fps map to float
    source indices; floor/ceil frames blend with the fractional weight.

    source: any frame source with read_window(clip_idx, indices);
    returns (new_length, H, W, C) uint8.
    """
    n_frames = source.num_frames(clip_idx)
    duration = n_frames / src_fps
    window_dur = (new_length - 1) / target_fps
    if duration < window_dur:
        raise ValueError(
            f"video too short ({duration:.2f}s) for {new_length} frames "
            f"@ {target_fps} fps (needs >= {window_dur:.2f}s)")
    t0 = float(rng.random()) * (duration - window_dur)
    f_idx = (t0 + np.arange(new_length) / target_fps) * src_fps
    i0 = np.floor(f_idx).astype(int)
    i1 = np.minimum(i0 + 1, n_frames - 1)
    a = (f_idx - i0).astype(np.float32)

    needed = np.stack([i0, i1], axis=1).reshape(-1)
    frames = source.read_window(clip_idx, needed).astype(np.float32)
    floor_f = frames[0::2]
    ceil_f = frames[1::2]
    out = (1 - a[:, None, None, None]) * floor_f \
        + a[:, None, None, None] * ceil_f
    return out.clip(0, 255).astype(np.uint8)
