"""Typed configuration mirroring the reference argparse surface.

Behavioral reference: get_args in reference/run_frame_finetuning.py:29-221
and run_mae_double_pretraining.py.  Field names match the reference flags
1:1 (SURVEY.md §5f) so bash job configs translate directly; defaults are the
reference defaults.  Use ``FinetuneConfig.from_args([...])`` for CLI parsing.

Copy of simple_tad_tpu/config.py's FinetuneConfig and PretrainConfig, so
the port's CLIs take the same flags (tests/test_torch_host_copies.py holds
them to the originals).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass
class FinetuneConfig:
    # core
    model: str = "vit_base_patch16_224"
    batch_size: int = 64
    epochs: int = 30
    update_freq: int = 1
    # ZeRO-style optimizer-state sharding over the data mesh (the
    # reference's DeepSpeed --zero_stage / --enable_deepspeed analog,
    # utils.py:547-594); no-op on a single device
    zero_stage: int = 0
    # data
    data_set: str = "DoTA"                 # DoTA | DADA2K
    data_path: str = ""
    nb_classes: int = 2
    num_frames: int = 16
    num_segments: int = 1
    sampling_rate: int = 1                 # train window stride
    sampling_rate_val: int = -1
    view_fps: int = 10
    input_size: int = 224
    short_side_size: int = 320
    loss: str = "crossentropy"
    ttc_TT: float = 2.0
    ttc_TA: float = 1.0
    num_sample: int = 1                    # repeated augmentation
    num_workers: int = 8
    # model
    tubelet_size: int = 2
    drop: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path: float = 0.1
    fc_drop_rate: float = 0.0
    init_scale: float = 0.001
    final_reduction: str = "fc_norm"
    use_checkpoint: bool = False           # gradient checkpointing (remat)
    no_flash_attn: bool = False
    # augmentation
    aa: str = "rand-m6-n3-mstd0.5-inc1"
    train_interpolation: str = "bicubic"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    smoothing: float = 0.0
    # optimizer
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Sequence[float] = (0.9, 0.999)
    clip_grad: Optional[float] = None
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    lr: float = 1e-3
    layer_decay: float = 0.75
    warmup_lr: float = 1e-6
    min_lr: float = 1e-6
    warmup_epochs: int = 5
    warmup_steps: int = -1
    # checkpoints
    finetune: str = ""                     # path to init .pth / converted ckpt
    model_key: str = "model|module"
    output_dir: str = ""
    log_dir: Optional[str] = None
    resume: str = ""
    auto_resume: bool = True
    save_ckpt: bool = True
    save_ckpt_freq: int = 100
    model_ema: bool = False
    model_ema_decay: float = 0.9999
    # eval
    eval: bool = False
    dist_eval: bool = True
    crop_pct: Optional[float] = None
    # misc
    seed: int = 0
    start_epoch: int = 0
    nb_samples_per_epoch: int = 0          # ShortDistributedSampler cap
    freeze_layers: Optional[str] = None
    # TPU-specific (no reference analogue)
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    frame_bucket: int = 128
    quant8: bool = False      # int8 GEMM inference (see ops/quant.py)
    quant8_mode: str = "static"   # static (calibrated) | dynamic
    # parity-validation path (VERDICT r2 #4): cv2-exact eval pixels
    # (reference dota.py:346-347) and exact (non-binned) sklearn metrics
    resize_on_host: bool = False
    exact_metrics: bool = False

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None):
        parser = argparse.ArgumentParser("simple_tad_tpu frame finetuning")
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            if f.type == "bool" or isinstance(f.default, bool):
                # paired enable/disable flags so default-True options
                # (auto_resume, dist_eval, save_ckpt) can be turned off
                group = parser.add_mutually_exclusive_group()
                group.add_argument(name, dest=f.name, action="store_true",
                                   default=f.default)
                group.add_argument("--no_" + f.name, dest=f.name,
                                   action="store_false")
            elif f.name == "opt_betas":
                parser.add_argument(name, nargs="+", type=float,
                                    default=list(f.default))
            else:
                if f.default is not None and not isinstance(
                        f.default, (tuple, list)):
                    typ = type(f.default)
                else:
                    # None-default fields: recover the element type from
                    # the annotation (Optional[float] etc.); dataclass
                    # annotations are strings under __future__.annotations
                    ann = str(f.type)
                    if "float" in ann:
                        typ = float
                    elif "int" in ann:
                        typ = int
                    else:
                        typ = str
                parser.add_argument(name, type=typ, default=f.default)
        ns = parser.parse_args(argv)
        return cls(**vars(ns))


@dataclasses.dataclass
class PretrainConfig:
    model: str = "pretrain_videomae_base_patch16_224"
    batch_size: int = 64
    batch_size2: int = 0                   # second dataset (double DAPT)
    batch_size3: int = 0                   # third dataset (triple loop)
    epochs: int = 800
    stop_at_epoch: int = -1                # hard stop (double DAPT uses 12)
    update_freq: int = 1
    # data
    data_set: str = "DoTA"
    data_set2: str = ""
    data_set3: str = ""                    # train_one_epoch_triple
    data_path: str = ""
    data_path2: str = ""
    data_path3: str = ""
    # precomputed view lists (the *_prepared datasets: skip the per-clip
    # duration scan at startup; see data.pretrain_datasets.load_view_list)
    view_list: str = ""
    view_list2: str = ""
    view_list3: str = ""
    # BDD100K: txt of relative video names fixing clip-id order (the
    # prepared clips_txt, bdd100k.py:164-177); pairs with view_list
    clips_list: str = ""
    clips_list2: str = ""
    clips_list3: str = ""
    mask_type: str = "tube"
    mask_ratio: float = 0.9
    num_frames: int = 16
    sampling_rate: int = 4
    view_fps: int = 10
    input_size: int = 224
    transforms_finetune_align: bool = False
    nb_samples_per_epoch: int = 0
    num_workers: int = 8
    # model
    tubelet_size: int = 2
    decoder_depth: int = 4
    drop_path: float = 0.0
    use_checkpoint: bool = False           # gradient checkpointing (remat)
    normlize_target: bool = True           # (sic) reference spelling
    # optimizer
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Sequence[float] = (0.9, 0.95)
    clip_grad: Optional[float] = None
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    lr: float = 3e-4
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    warmup_epochs: int = 40
    warmup_steps: int = -1
    # checkpoints
    from_ckpt: str = ""
    output_dir: str = ""
    log_dir: Optional[str] = None
    resume: str = ""
    auto_resume: bool = True
    save_ckpt_freq: int = 20
    seed: int = 0
    start_epoch: int = 0
    # TPU-specific
    dtype: str = "bfloat16"
    attn_impl: str = "auto"

    save = FinetuneConfig.save
    from_args = classmethod(FinetuneConfig.from_args.__func__)
