"""Frame-level anomaly classification datasets: DoTA and DADA-2000.

Behavioral reference: FrameClsDataset_DoTA (reference/dota.py:72-365)
and FrameClsDataset_DADA (reference/dada.py:26-353).  Same annotation
formats, label rules, TTC smoothing and windowing; restructured TPU-first:

  * annotations parse into plain ClipInfo records (numpy, no torch),
  * window enumeration is the shared RegularSequencer (labels = last frame
    of the window, dota.py:217-219),
  * eval runs CLIP-AT-ONCE: unique frames of a clip are decoded once
    (threaded zip reader), windows are gathered on device — the reference
    re-decodes every frame up to 16x per clip in its per-window loader,
  * train windows decode per-window like the reference (augmentation needs
    full-res pixels) but through the same threaded decoder.

DoTA layout:  <root>/dataset/<split>.txt, dataset/annotations/<clip>.json
(labels[].image_path + accident_id, ego_involve, night),
dataset/metadata_{train,val}.json, frames/<clip>/images.zip with
%06d.jpg members (orig 10 fps).
DADA layout:  <root>/<split>.txt with '<type>/<video>' lines,
annotation/full_anno.csv, frames/<type>/<video>/images.zip with
%04d.png members (orig 30 fps); frame labeled 1 inside
[abnormal start frame, abnormal end frame]; ego iff type in 1..18,61,62.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simple_tad_tpu_torch.data.labels import compute_time_vector, smooth_labels
from simple_tad_tpu_torch.data.sequencing import RegularSequencer
from simple_tad_tpu_torch.data.zipreader import decode_scaled, decode_zip_frames

# DoTA anomaly-category codes (reference/dota.py:46-70)
DOTA_CAT2CODE = {
    "start_stop_or_stationary": "ST", "moving_ahead_or_waiting": "AH",
    "lateral": "LA", "oncoming": "OC", "turning": "TC", "pedestrian": "VP",
    "obstacle": "VO", "leave_to_left": "OO", "leave_to_right": "OO",
    "unknown": "UK",
}
DADA_EGO_CATEGORIES = {str(c) for c in list(range(1, 19)) + [61, 62]}


@dataclasses.dataclass
class ClipInfo:
    name: str
    zip_path: str
    frame_names: List[str]            # zip member per frame, sorted by time
    timesteps: np.ndarray             # frame ids (ints)
    binary_labels: np.ndarray         # (F,) 0/1
    cat_labels: np.ndarray            # (F,) anomaly category per frame
    ego: bool
    night: bool
    ttc: np.ndarray                   # (F,) float
    smoothed: np.ndarray              # (F, 2) float32
    meta_category: Optional[str] = None   # clip-level code (DoTA)
    meta_ego: Optional[bool] = None


def read_dota_clips(data_path: str, split_file: str, *, orig_fps: int = 10,
                    ttc_TT: float = 2.0, ttc_TA: float = 1.0
                    ) -> List[ClipInfo]:
    meta_files = {"val_split.txt": "metadata_val.json",
                  "train_split.txt": "metadata_train.json"}
    with open(os.path.join(data_path, "dataset", split_file)) as f:
        names = [line.strip() for line in f if line.strip()]

    meta = None
    if split_file in meta_files:
        meta_path = os.path.join(data_path, "dataset", meta_files[split_file])
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)

    clips = []
    for name in names:
        with open(os.path.join(data_path, "dataset", "annotations",
                               f"{name}.json")) as f:
            anno = json.load(f)
        entries = sorted(
            (int(os.path.splitext(os.path.basename(e["image_path"]))[0]),
             int(e["accident_id"])) for e in anno["labels"])
        timesteps = np.array([t for t, _ in entries])
        cat = np.array([c for _, c in entries])
        binary = (cat > 0).astype(np.int64)
        ttc = compute_time_vector(binary, fps=orig_fps, TT=ttc_TT, TA=ttc_TA)
        smoothed = smooth_labels(binary, ttc, ttc_TT, ttc_TA)

        meta_cat = meta_ego = None
        if meta is not None and name in meta:
            group, category = meta[name]["anomaly_class"].split(": ")
            meta_ego = group == "ego"
            meta_cat = DOTA_CAT2CODE.get(category, "UK")

        clips.append(ClipInfo(
            name=name,
            zip_path=os.path.join(data_path, "frames", name, "images.zip"),
            frame_names=[f"{t:06d}.jpg" for t in timesteps],
            timesteps=timesteps, binary_labels=binary, cat_labels=cat,
            ego=bool(anno.get("ego_involve", False)),
            night=bool(anno.get("night", False)),
            ttc=ttc, smoothed=smoothed,
            meta_category=meta_cat, meta_ego=meta_ego))
    return clips


def _csv_number(text: str):
    """The number a CSV cell holds, as pandas reads a numeric column (an
    int where it is integral); None for text that is not a number."""
    try:
        value = float(text)
    except (TypeError, ValueError):
        return None
    return int(value) if value.is_integer() else value


def read_dada_clips(data_path: str, split_file: str, *, orig_fps: int = 30,
                    ttc_TT: float = 2.0, ttc_TA: float = 1.0,
                    video_ext: str = ".png") -> List[ClipInfo]:
    import csv
    import zipfile

    with open(os.path.join(data_path, split_file)) as f:
        names = [line.strip() for line in f if line.strip()]
    with open(os.path.join(data_path, "annotation", "full_anno.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    # the annotation row of a clip: the one whose (type, video) numbers
    # equal the clip name's, as the JAX package's pandas lookup
    by_key: Dict[tuple, list] = {}
    for r in rows:
        key = (_csv_number(r["type"]), _csv_number(r["video"]))
        by_key.setdefault(key, []).append(r)

    clips = []
    for name in names:
        clip_type, clip_video = name.split("/")
        found = by_key.get((int(clip_type), int(clip_video)), [])
        assert len(found) == 1, f"annotation rows != 1 for {name}"
        row = found[0]
        zip_path = os.path.join(data_path, "frames", name, "images.zip")
        with zipfile.ZipFile(zip_path) as zf:
            members = sorted(
                (int(os.path.splitext(m)[0].split("_")[-1]), m)
                for m in zf.namelist()
                if os.path.splitext(m)[1] == video_ext)
        timesteps = np.array([t for t, _ in members])
        st = int(_csv_number(row["abnormal start frame"]))
        en = int(_csv_number(row["abnormal end frame"]))
        if st > -1 and en > -1:
            binary = ((timesteps >= st) & (timesteps <= en)).astype(np.int64)
        else:
            binary = np.zeros(len(timesteps), np.int64)
        cat = binary * int(clip_type)
        ttc = compute_time_vector(binary, fps=orig_fps, TT=ttc_TT, TA=ttc_TA)
        clips.append(ClipInfo(
            name=name, zip_path=zip_path,
            frame_names=[f"{t:04d}{video_ext}" for t in timesteps],
            timesteps=timesteps, binary_labels=binary, cat_labels=cat,
            ego=clip_type in DADA_EGO_CATEGORIES,
            night=_csv_number(row["light(day,night)1-2"]) == 2,
            ttc=ttc, smoothed=smooth_labels(binary, ttc, ttc_TT, ttc_TA)))
    return clips


@dataclasses.dataclass
class WindowSample:
    clip_idx: int
    frame_idx: np.ndarray      # indices into the clip's frame list
    label: int
    smoothed: np.ndarray       # (2,)
    ttc: float


@dataclasses.dataclass
class ClipEvalView:
    """Everything needed to score one clip's windows in a batched pass."""
    clip: ClipInfo
    unique_frames: np.ndarray      # sorted unique frame indices used
    window_idx: np.ndarray         # (W, T) indices into unique_frames
    labels: np.ndarray             # (W,)
    smoothed: np.ndarray           # (W, 2)
    ttc: np.ndarray                # (W,)
    frame_names: List[str]         # last frame name per window (csv key)


class FrameDataset:
    """Window enumeration + decoding over a list of ClipInfo.

    mode: 'train' | 'validation' | 'test'.  view_step semantics follow
    build_frame_dataset (reference/datasets_frame.py:202-241): train
    uses sampling_rate, validation uses 1... — stride policy is the
    *caller's* job; pass the already-resolved ``view_step``.
    ``native_decoder``: decode with the C++ decoder (data/native.py; the
    CLIs' ``--native_decoder``) instead of zipfile + cv2.
    """

    def __init__(self, clips: Sequence[ClipInfo], *, mode: str = "test",
                 view_len: int = 16, target_fps: int = 10,
                 orig_fps: int = 10, view_step: int = 1,
                 crop_size: int = 224, native_decoder: bool = False):
        self.clips = list(clips)
        self.native_decoder = native_decoder
        self.mode = mode
        self.view_len = view_len
        self.target_fps = target_fps
        self.orig_fps = orig_fps
        self.view_step = view_step
        self.crop_size = crop_size
        self.samples: List[WindowSample] = []
        self._sequences_per_clip: List[Optional[np.ndarray]] = []
        self._prepare_views()

    def _prepare_views(self):
        seq = RegularSequencer(seq_frequency=self.target_fps,
                               seq_length=self.view_len,
                               step=self.view_step)
        for ci, clip in enumerate(self.clips):
            seqs = seq.get_sequences(len(clip.timesteps), self.orig_fps)
            self._sequences_per_clip.append(
                None if seqs is None else np.asarray(seqs))
            if seqs is None:
                continue
            for s in seqs:
                last = s[-1]
                self.samples.append(WindowSample(
                    clip_idx=ci, frame_idx=np.asarray(s),
                    label=int(clip.binary_labels[last]),
                    smoothed=clip.smoothed[last],
                    ttc=float(clip.ttc[last])))

    def __len__(self):
        return len(self.samples)

    @property
    def labels(self) -> np.ndarray:
        return np.array([s.label for s in self.samples])

    # ---- per-window decode (train path / reference-equivalent protocol)

    def get_window_frames(self, index: int, *, final_resize: bool = True,
                          resize_scale: Optional[float] = None
                          ) -> Tuple[np.ndarray, WindowSample]:
        """Decode one window.  final_resize=True: cv2 cubic resize to
        crop_size (val/test path, dota.py:346-347); else scaled decode for
        augmentation (train path)."""
        s = self.samples[index]
        clip = self.clips[s.clip_idx]
        names = [clip.frame_names[i] for i in s.frame_idx]
        if final_resize:
            frames = decode_zip_frames(
                clip.zip_path, names,
                resize=(self.crop_size, self.crop_size),
                native=self.native_decoder)
        else:
            frames = decode_scaled(clip.zip_path, names, self.crop_size,
                                   resize_scale or 1.0,
                                   native=self.native_decoder)
        return np.stack(frames), s

    # ---- clip-at-once eval views (TPU batched scoring)

    def clip_eval_views(self) -> List[ClipEvalView]:
        views = []
        for ci, clip in enumerate(self.clips):
            seqs = self._sequences_per_clip[ci]
            if seqs is None:
                continue
            unique, inverse = np.unique(seqs, return_inverse=True)
            window_idx = inverse.reshape(seqs.shape)
            last = seqs[:, -1]
            views.append(ClipEvalView(
                clip=clip, unique_frames=unique,
                window_idx=window_idx.astype(np.int32),
                labels=clip.binary_labels[last],
                smoothed=clip.smoothed[last],
                ttc=clip.ttc[last],
                frame_names=[clip.frame_names[i] for i in last]))
        return views

    def decode_clip_frames(self, view: ClipEvalView,
                           resize_on_host: bool = True) -> np.ndarray:
        """Decode a clip's unique frames once -> (F, H, W, C) uint8."""
        names = [view.clip.frame_names[i] for i in view.unique_frames]
        resize = ((self.crop_size, self.crop_size)
                  if resize_on_host else None)
        return np.stack(decode_zip_frames(view.clip.zip_path, names,
                                          resize=resize,
                                          native=self.native_decoder))
