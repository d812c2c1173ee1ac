"""Dataset preparation / integrity utilities, in the port.

Port of simple_tad_tpu/cli/data_tools.py (reference: data_tools/):
frames2zip (pack frame folders into images.zip), check-zips (CRC scan,
dada/check_corrupted_zips.py), check-videos (one frame read per video),
halfsplit (category-stratified half splits, dota/halfsplit.py),
anno-for-predictions (the frame-level annotation CSV that
eval/analysis.py:show_metrics joins with predictions.csv,
dota/anno_for_predictions.py), prepare-anno-dada2000 / -capdata (training
and validation lists from the full annotation CSV), convert-xlsx (an Excel
annotation to CSV), prepare-anno-bdd (BDD100K clip and view lists) and
prepare-views (pre-training view lists).  The CSVs are read and written
with the csv module, as pandas writes them; only convert-xlsx needs pandas
(and an Excel engine), imported when it runs.  cv2 is imported by the
commands that read videos.

Usage:
  python -m simple_tad_tpu_torch.cli.data_tools frames2zip --src dir/ \\
      --dst out/
  python -m simple_tad_tpu_torch.cli.data_tools check-zips --data_path root/
  python -m simple_tad_tpu_torch.cli.data_tools halfsplit \\
      --data_path root/ --split val_split.txt
  python -m simple_tad_tpu_torch.cli.data_tools anno-for-predictions \\
      --data_set DoTA --data_path root/ --split val_split.txt --out anno.csv
"""

from __future__ import annotations

import argparse
import os
import sys
import zipfile
from typing import List


def frames2zip(src: str, dst: str, ext: str = ".jpg") -> int:
    """Pack each <src>/<clip>/*.jpg folder into <dst>/<clip>/images.zip
    (data_tools/frames2zip.py:13-93; stored uncompressed: JPEGs don't
    deflate and a stored member reads faster)."""
    n = 0
    for clip in sorted(os.listdir(src)):
        clip_dir = os.path.join(src, clip)
        if not os.path.isdir(clip_dir):
            continue
        frames = sorted(f for f in os.listdir(clip_dir)
                        if f.lower().endswith(ext))
        if not frames:
            continue
        out_dir = os.path.join(dst, clip)
        os.makedirs(out_dir, exist_ok=True)
        with zipfile.ZipFile(os.path.join(out_dir, "images.zip"), "w",
                             zipfile.ZIP_STORED) as zf:
            for f in frames:
                zf.write(os.path.join(clip_dir, f), arcname=f)
        n += 1
    return n


def check_videos(root: str, exts=(".mp4", ".mov", ".avi", ".webm")
                 ) -> List[str]:
    """Open every video under root with cv2 and read one frame
    (data_tools/check_kinetics.py equivalent); returns unreadable paths."""
    import cv2
    bad = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if os.path.splitext(f)[1].lower() not in exts:
                continue
            path = os.path.join(dirpath, f)
            cap = cv2.VideoCapture(path)
            ok, _ = cap.read()
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            if not ok or n <= 0:
                bad.append(path)
    return bad


def check_zips(data_path: str) -> List[str]:
    """CRC-scan every frames/*/images.zip; returns corrupt paths
    (data_tools/dada/check_corrupted_zips.py)."""
    bad = []
    frames_root = os.path.join(data_path, "frames")
    for root, _dirs, files in os.walk(frames_root):
        for f in files:
            if f == "images.zip":
                path = os.path.join(root, f)
                try:
                    with zipfile.ZipFile(path) as zf:
                        if zf.testzip() is not None:
                            bad.append(path)
                except Exception:
                    bad.append(path)
    return bad


def halfsplit(data_path: str, split: str, seed: int = 0):
    """Category-stratified half split of a DoTA split file
    (data_tools/dota/halfsplit.py): writes <split>_half1/2.txt keeping the
    clip-level category distribution balanced."""
    import numpy as np
    from simple_tad_tpu_torch.data.frame_datasets import read_dota_clips
    clips = read_dota_clips(data_path, split)
    by_cat = {}
    for c in clips:
        by_cat.setdefault(c.meta_category or "UK", []).append(c.name)
    rng = np.random.default_rng(seed)
    half1, half2 = [], []
    for cat in sorted(by_cat):
        names = sorted(by_cat[cat])
        rng.shuffle(names)
        half1 += names[: len(names) // 2]
        half2 += names[len(names) // 2:]
    base = os.path.join(data_path, "dataset", os.path.splitext(split)[0])
    for suffix, names in (("_half1.txt", half1), ("_half2.txt", half2)):
        with open(base + suffix, "w") as f:
            f.write("\n".join(sorted(names)) + "\n")
    return sorted(half1), sorted(half2)


def anno_for_predictions(data_set: str, data_path: str, split: str,
                         out_csv: str, view_len: int = 16,
                         view_fps: int = 10):
    """Write the frame-level annotation CSV of ``split`` (one row a test
    window, eval/analysis.py:ANNO_COLUMNS) -> the table."""
    from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                          read_dada_clips,
                                                          read_dota_clips)
    from simple_tad_tpu_torch.eval.analysis import (build_frame_annotations,
                                                    write_table)
    if data_set == "DoTA":
        clips = read_dota_clips(data_path, split, orig_fps=10)
        orig_fps = 10
    else:
        clips = read_dada_clips(data_path, split, orig_fps=30)
        orig_fps = 30
    ds = FrameDataset(clips, mode="test", view_len=view_len,
                      target_fps=view_fps, orig_fps=orig_fps, view_step=1)
    table = build_frame_annotations(ds)
    write_table(table, out_csv)
    return table


def natsorted(items):
    """Natural sort ('10/2' after '2/2'), the natsort.natsorted subset the
    annotation-prep scripts rely on (prepare_anno_dada2000.py:2)."""
    import re

    def key(s):
        return tuple(int(t) if t.isdigit() else t
                     for t in re.split(r"(\d+)", str(s)))
    return sorted(items, key=key)


def _split_clip_ids(anno_line: str) -> str:
    """'<dir> <label> <start> <end> <toa>, <free text>' -> dir
    (prepare_anno_dada2000.py:21-24)."""
    main_data = anno_line.strip().split(",", 1)[0]
    return main_data.split()[0]


def prepare_anno_split(full_anno: str, orig_split: str, out_dir: str, *,
                       zfill: int, listed_role: str):
    """Derive training.txt/validation.txt from the full annotation CSV and
    an original split list.

    Equivalent of data_tools/dada/prepare_anno_dada2000.py (listed_role=
    'train', clip ids zfill 3) and prepare_anno_capdata.py (listed_role=
    'val', zfill 6): all clips come from full_anno ('type'/'video'
    columns -> 'type/zfilled-video'), the clips named in ``orig_split``
    take the listed role, the natsorted complement takes the other."""
    from simple_tad_tpu_torch.eval.analysis import read_table
    anno = read_table(full_anno)
    all_clips = natsorted(
        f"{int(t)}/{str(int(v)).zfill(zfill)}"
        for t, v in zip(anno["type"], anno["video"]))
    with open(orig_split) as f:
        listed = {_split_clip_ids(line) for line in f if line.strip()}
    missing = listed - set(all_clips)
    assert not missing, f"split clips absent from full_anno: {missing}"
    listed_sorted = natsorted(listed)
    complement = [c for c in all_clips if c not in listed]
    assert len(listed_sorted) + len(complement) == len(all_clips)
    train, val = ((listed_sorted, complement) if listed_role == "train"
                  else (complement, listed_sorted))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "training.txt"), "w") as f:
        f.write("\n".join(train))
    with open(os.path.join(out_dir, "validation.txt"), "w") as f:
        f.write("\n".join(val))
    return train, val


def convert_xlsx(src: str, dst: str, sheet: str = "annotation file"):
    """Excel annotation -> csv (data_tools/dada/convert_xlsx.py).  Needs
    pandas and an Excel engine (openpyxl / xlrd); without them it exits
    with a message that names what to install."""
    try:
        import pandas as pd
    except ImportError as e:
        raise SystemExit(
            f"convert-xlsx needs pandas and an Excel reader engine ({e}); "
            "install pandas with openpyxl (xlsx) or xlrd (legacy xls), or "
            "export the sheet to csv manually") from e
    try:
        frames = pd.read_excel(src, sheet_name=None)
    except ImportError as e:
        raise SystemExit(
            f"convert-xlsx needs an Excel reader engine ({e}); install "
            "openpyxl (xlsx) or xlrd (legacy xls), or export the sheet to "
            "csv manually") from e
    df = frames.get(sheet)
    if df is None:
        df = next(iter(frames.values()))
    df.to_csv(dst, index=False)
    return len(df)


def prepare_anno_bdd(data_path: str, out_dir: str, *, setting: str = "",
                     num_frames: int = 8, view_fps: int = 5,
                     sampling_rate: int = 4, fps: int = 30):
    """BDD100K prepared lists (data_tools/bdd100k/prepare_anno.py): scan the
    videos for durations, enumerate views with RegularSequencerWithStart
    (bdd100k.py:32,38-49; reference defaults new_length=8, target_fps=5,
    new_step=4), and write

      all_clips.txt           — relative video names, one per line
      all_dataset_samples.txt — ``clip_id,[f0, f1, ...]`` view lines

    ``setting`` optionally fixes the clip list/order from a split txt like
    the reference's all.txt; otherwise the videos tree is scanned.  Feed the
    outputs back via ``--clips_list``/``--view_list`` on the pretrain CLI.
    """
    from simple_tad_tpu_torch.data.pretrain_datasets import (
        PretrainWindowDataset, VideoFileSource, read_bdd_clips,
        save_view_list)
    names = read_bdd_clips(data_path, clips_list=setting or None)
    paths = [os.path.join(data_path, "videos", n) for n in names]
    source = VideoFileSource(paths)
    ds = PretrainWindowDataset(source, view_len=num_frames,
                               target_fps=view_fps, orig_fps=fps,
                               view_step=sampling_rate, with_start=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "all_clips.txt"), "w") as f:
        for n in names:
            f.write(n + "\n")
    save_view_list(ds.samples, os.path.join(out_dir,
                                            "all_dataset_samples.txt"))
    return names, ds.samples


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("simple_tad_tpu_torch data tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("frames2zip")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--ext", default=".jpg")
    p = sub.add_parser("check-zips")
    p.add_argument("--data_path", required=True)
    p = sub.add_parser("check-videos")
    p.add_argument("--data_path", required=True)
    p = sub.add_parser("halfsplit")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val_split.txt")
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("anno-for-predictions")
    p.add_argument("--data_set", default="DoTA")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val_split.txt")
    p.add_argument("--out", required=True)
    for name, ref in (("prepare-anno-dada2000",
                       "full_anno.csv + orig_training.txt -> training/"
                       "validation.txt (dada/prepare_anno_dada2000.py)"),
                      ("prepare-anno-capdata",
                       "cap annotation csv + orig testing list -> training/"
                       "validation.txt (dada/prepare_anno_capdata.py)")):
        p = sub.add_parser(name, help=ref)
        p.add_argument("--full_anno", required=True)
        p.add_argument("--orig_split", required=True)
        p.add_argument("--out_dir", required=True)
    p = sub.add_parser("convert-xlsx",
                       help="Excel annotation -> csv (dada/convert_xlsx.py)")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--sheet", default="annotation file")
    p = sub.add_parser("prepare-anno-bdd",
                       help="scan BDD100K videos -> all_clips.txt + "
                            "all_dataset_samples.txt (bdd100k/"
                            "prepare_anno.py)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--setting", default="",
                   help="optional split txt fixing the clip list/order")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--view_fps", type=int, default=5)
    p.add_argument("--sampling_rate", type=int, default=4)
    p.add_argument("--fps", type=int, default=30)
    p = sub.add_parser("prepare-views",
                       help="precompute pretrain view lists (the reference's"
                            " *_prepared datasets, bdd100k.py:164-188)")
    p.add_argument("--data_set", default="DoTA")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--view_fps", type=int, default=10)
    p.add_argument("--sampling_rate", type=int, default=4)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "frames2zip":
        n = frames2zip(args.src, args.dst, args.ext)
        print(f"packed {n} clips")
    elif args.cmd in ("check-zips", "check-videos"):
        check, what = ((check_zips, "corrupt zips")
                       if args.cmd == "check-zips"
                       else (check_videos, "unreadable videos"))
        bad = check(args.data_path)
        print(f"{len(bad)} {what}")
        for b in bad:
            print(b)
        sys.exit(1 if bad else 0)
    elif args.cmd == "halfsplit":
        h1, h2 = halfsplit(args.data_path, args.split, args.seed)
        print(f"half1: {len(h1)} clips, half2: {len(h2)} clips")
    elif args.cmd == "anno-for-predictions":
        table = anno_for_predictions(args.data_set, args.data_path,
                                     args.split, args.out)
        print(f"wrote {len(table['clip'])} rows to {args.out}")
    elif args.cmd in ("prepare-anno-dada2000", "prepare-anno-capdata"):
        zfill, role = ((3, "train") if args.cmd == "prepare-anno-dada2000"
                       else (6, "val"))
        train, val = prepare_anno_split(args.full_anno, args.orig_split,
                                        args.out_dir, zfill=zfill,
                                        listed_role=role)
        print(f"train {len(train)} clips, val {len(val)} clips")
    elif args.cmd == "prepare-anno-bdd":
        names, samples = prepare_anno_bdd(
            args.data_path, args.out_dir, setting=args.setting,
            num_frames=args.num_frames, view_fps=args.view_fps,
            sampling_rate=args.sampling_rate, fps=args.fps)
        print(f"{len(names)} clips, {len(samples)} views -> {args.out_dir}")
    elif args.cmd == "convert-xlsx":
        n = convert_xlsx(args.src, args.dst, args.sheet)
        print(f"wrote {n} rows to {args.dst}")
    elif args.cmd == "prepare-views":
        from simple_tad_tpu_torch.cli.pretrain import _build_source
        from simple_tad_tpu_torch.data.pretrain_datasets import (
            save_view_list)

        class _Cfg:
            num_frames = args.num_frames
            view_fps = args.view_fps
            sampling_rate = args.sampling_rate
        ds = _build_source(args.data_set, args.data_path, _Cfg)
        save_view_list(ds.samples, args.out)
        print(f"wrote {len(ds.samples)} views to {args.out}")


if __name__ == "__main__":
    main()
