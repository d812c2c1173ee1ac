"""InternVideo2 linear / attentive probing CLI, in PyTorch, on one device.

Port of simple_tad_tpu/cli/linear_probe.py (reference:
run_linear_probing.py): class fine-tuning with the trunk frozen but for its
last ``--open_block_num`` blocks; the attention-pooling head
('clip_projector') trains only with ``--open_clip_projector``; fc_norm
and the classifier always train.  ``--open_block_num 0`` alone is a
linear probe, with ``--open_clip_projector`` the attentive probe.  It
fills in the JAX CLI's defaults (``--open_block_num 0``, IV2-B, 8
frames, layer decay 1.0) and runs cli/class_finetune.py, whose optimizer
detaches the frozen parameters (FinetuneOptimizer.detach_frozen) so the
frozen trunk runs forward only.

Usage (jobs/probe/IV2-1B_ap_K710.sh):
  python -m simple_tad_tpu_torch.cli.linear_probe \\
      --model internvideo2_1B_patch14_224 --data_path /data/k710 \\
      --anno_train /data/k710/train.csv --nb_classes 710 \\
      --finetune 1B_pt.pth --open_block_num 0 --open_clip_projector \\
      --batch_size 64 --num_frames 16 --sparse_sampling --output_dir out/
"""

from __future__ import annotations

import sys


def main(argv=None):
    from simple_tad_tpu_torch.cli import class_finetune
    argv = list(argv if argv is not None else sys.argv[1:])

    def has(flag):
        return any(a == flag or a.startswith(flag + "=") for a in argv)

    for flag, value in (("--open_block_num", "0"),
                        ("--model", "internvideo2_base_patch14_224"),
                        ("--num_frames", "8"),
                        # probing has no layer decay: the trunk is frozen
                        ("--layer_decay", "1.0")):
        if not has(flag):
            argv += [flag, value]
    return class_finetune.main(argv)


if __name__ == "__main__":
    main()
