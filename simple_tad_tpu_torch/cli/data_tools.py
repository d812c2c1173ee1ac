"""Dataset tools of the eval job, in the port.

Port of the ``anno-for-predictions`` command of
simple_tad_tpu/cli/data_tools.py (reference:
data_tools/dota/anno_for_predictions.py): the frame-level annotation CSV
that eval/analysis.py:show_metrics joins with predictions.csv.  The file's
other commands are not ported yet (ROADMAP.md queue 1 item 9).

Usage (the second step of jobs/eval/eval_DoTA.sh):
  python -m simple_tad_tpu_torch.cli.data_tools anno-for-predictions \\
      --data_set DoTA --data_path root/ --split val_split.txt --out anno.csv
"""

from __future__ import annotations

import argparse


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


def main(argv=None):
    parser = argparse.ArgumentParser("simple_tad_tpu_torch data tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("anno-for-predictions")
    p.add_argument("--data_set", default="DoTA")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val_split.txt")
    p.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    table = anno_for_predictions(args.data_set, args.data_path, args.split,
                                 args.out)
    print(f"wrote {len(table['clip'])} rows to {args.out}")


if __name__ == "__main__":
    main()
