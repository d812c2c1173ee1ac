"""Reference-compatible dataset builders, in the port.

Port of simple_tad_tpu/data/builders.py (reference: datasets_frame.py):
  build_frame_dataset(is_train, test_mode, args) -> (FrameDataset, nb_classes)
  build_pretraining_dataset(is_train, args) -> PretrainWindowDataset
Split-file names, fps constants, and stride policies match the reference
(train stride = args.sampling_rate, validation/test stride =
args.sampling_rate_val if set else 1 for DoTA test / sampling_rate for
val — datasets_frame.py:202-283).  ``args`` is any object with the
FinetuneConfig / PretrainConfig field names; an ``args.native_decoder``
that is true decodes the zips with the C++ decoder (data/native.py).
"""

from __future__ import annotations

from typing import Tuple

from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dada_clips,
                                                      read_dota_clips)
from simple_tad_tpu_torch.data.pretrain_datasets import (
    PretrainWindowDataset, VideoFileSource, ZipClipSource)


def _val_stride(args) -> int:
    return (args.sampling_rate_val
            if getattr(args, "sampling_rate_val", -1) > 0
            else args.sampling_rate)


def build_frame_dataset(is_train: bool, test_mode: bool, args
                        ) -> Tuple[FrameDataset, int]:
    data_set = args.data_set
    if data_set.startswith("DoTA"):
        orig_fps = 10
        if is_train:
            split = ("train_split_half1.txt" if "_half" in data_set
                     else "train_split.txt")
            mode, stride = "train", args.sampling_rate
        elif test_mode:
            split, mode, stride = "val_split.txt", "test", 1
        else:
            split, mode, stride = "val_split.txt", "validation", \
                _val_stride(args)
        clips = read_dota_clips(args.data_path, split, orig_fps=orig_fps,
                                ttc_TT=args.ttc_TT, ttc_TA=args.ttc_TA)
    elif data_set.startswith("DADA"):
        orig_fps = 30
        if is_train:
            split = ("DADA2K_my_split/half_training.txt"
                     if "_half" in data_set
                     else "DADA2K_my_split/training.txt")
            mode, stride = "train", args.sampling_rate
        else:
            # the test split is validation.txt at the validation stride
            # (datasets_frame.py:253-258)
            split = "DADA2K_my_split/validation.txt"
            mode = "test" if test_mode else "validation"
            stride = _val_stride(args)
        clips = read_dada_clips(args.data_path, split, orig_fps=orig_fps,
                                ttc_TT=args.ttc_TT, ttc_TA=args.ttc_TA)
    else:
        raise NotImplementedError(data_set)

    ds = FrameDataset(clips, mode=mode, view_len=args.num_frames,
                      target_fps=args.view_fps, orig_fps=orig_fps,
                      view_step=stride, crop_size=args.input_size,
                      native_decoder=getattr(args, "native_decoder", False))
    return ds, 2


def build_pretraining_dataset(is_train: bool, args) -> PretrainWindowDataset:
    data_set, data_path = args.data_set, args.data_path
    native = getattr(args, "native_decoder", False)
    if data_set == "DoTA":
        clips = read_dota_clips(data_path, "all_split.txt", orig_fps=10)
        source, orig_fps = ZipClipSource(clips, native_decoder=native), 10
    elif data_set in ("DADA2K", "DADA"):
        clips = read_dada_clips(data_path, "DADA2K_my_split/all.txt",
                                orig_fps=30)
        source, orig_fps = ZipClipSource(clips, native_decoder=native), 30
    elif data_set == "BDD100K":
        import glob
        import os
        paths = sorted(glob.glob(os.path.join(data_path, "videos", "*")))
        source, orig_fps = VideoFileSource(paths), 30
    elif data_set in ("K700", "Kinetics-700", "Kinetics-400",
                      "K700_aligned"):
        from simple_tad_tpu_torch.data.pretrain_datasets import (
            KineticsPretrainDataset, read_kinetics_clips)
        paths = read_kinetics_clips(data_path, "annotations/train.csv")
        source = VideoFileSource(paths, half_first=False)
        return KineticsPretrainDataset(
            source, view_len=args.num_frames,
            sampling_rate=args.sampling_rate,
            mode="aligned" if data_set == "K700_aligned" else "tsn",
            target_fps=args.view_fps, seed=getattr(args, "seed", 0))
    else:
        raise NotImplementedError(data_set)
    return PretrainWindowDataset(
        source, view_len=args.num_frames, target_fps=args.view_fps,
        orig_fps=orig_fps, view_step=args.sampling_rate)
