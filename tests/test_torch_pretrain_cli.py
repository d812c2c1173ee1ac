"""The port's pre-training CLI (simple_tad_tpu_torch.cli.pretrain) end to
end on the CPU, on the synthetic DoTA fixture with the flags of
jobs/dapt/pretrain_bdd_capdata.sh (mask 0.75, finetune-aligned transforms,
decoder depth 4, AdamW betas 0.9 / 0.95, lr 3e-4, min_lr 1e-5, a second
dataset), paths swapped for the fixture and the model cut for the CPU
(ViT-S at 32 x 32, fp32): one epoch with one and two datasets, a second run
auto-resumes, and the hand-off: the written checkpoint loads through
cli/finetune.py --finetune and its encoder weights come back equal.
"""

import glob
import os

import pytest
import torch

from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_dota_full
    root = str(tmp_path_factory.mktemp("dota_full"))
    return make_synthetic_dota_full(root, n_clips=2, frames_per_clip=24,
                                    h=48, w=64)


def _args(root, out, *extra):
    return ["--model", "pretrain_videomae_small_patch16_224",
            "--data_set", "DoTA", "--data_path", root, "--batch_size", "2",
            "--mask_ratio", "0.75", "--transforms_finetune_align",
            "--decoder_depth", "4", "--sampling_rate", "4",
            "--lr", "3e-4", "--min_lr", "1e-5", "--opt_betas", "0.9", "0.95",
            "--warmup_epochs", "1", "--epochs", "2", "--input_size", "32",
            "--num_frames", "16", "--dtype", "float32", "--num_workers", "2",
            "--save_ckpt_freq", "1", "--nb_samples_per_epoch", "8",
            "--output_dir", out, "--device", "cpu", *extra]


@pytest.mark.parametrize("second", [False, True], ids=["single", "double"])
def test_pretrain_cli_one_epoch(full_root, tmp_path, second):
    from simple_tad_tpu_torch.cli.pretrain import main
    out = str(tmp_path / "run")
    extra = (["--data_set2", "DoTA", "--data_path2", full_root,
              "--batch_size2", "1"] if second else [])
    state = main(_args(full_root, out, "--stop_at_epoch", "1", *extra))
    # 4 clips x 24 frames at stride 4: 12 windows, 8 an epoch, batch 2
    assert state.step == 4 and state.optimizer.count == 4
    for name in ("checkpoint-last.pth", "checkpoint-0.pth", "log.txt",
                 "params.json"):
        assert os.path.exists(os.path.join(out, name)), name
    weights = torch.load(os.path.join(out, "checkpoint-0.pth"),
                         weights_only=False)["model"]
    assert {"mask_token", "encoder_to_decoder.weight",
            "encoder.patch_embed.proj.weight", "decoder.head.weight",
            "encoder.blocks.11.mlp.fc2.bias",
            "decoder.blocks.3.norm2.weight"} <= set(weights)
    assert all(torch.isfinite(v).all() for v in weights.values())


def test_pretrain_cli_auto_resume_and_finetune_handoff(full_root, tmp_path):
    from simple_tad_tpu_torch.cli import finetune, pretrain
    out = str(tmp_path / "run")
    first = pretrain.main(_args(full_root, out, "--stop_at_epoch", "1"))
    params = {k: v.clone() for k, v in first.model.state_dict().items()}
    resumed = pretrain.main(_args(full_root, out, "--stop_at_epoch", "1"))
    assert resumed.step == first.step                # restored, no new steps
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    second = pretrain.main(_args(full_root, out))    # epoch 1 of 2
    assert second.step == 2 * first.step
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out, "checkpoint-?.pth"))) == ["checkpoint-0.pth",
                                                    "checkpoint-1.pth"]

    ckpt = os.path.join(out, "checkpoint-1.pth")
    state = finetune.main([
        "--data_set", "DoTA", "--data_path", full_root,
        "--model", "vit_small_patch16_224", "--input_size", "32",
        "--num_frames", "16", "--batch_size", "4", "--epochs", "0",
        "--warmup_epochs", "0", "--output_dir", str(tmp_path / "ft"),
        "--dtype", "float32", "--num_workers", "2", "--device", "cpu",
        "--finetune", ckpt])
    enc = torch.load(ckpt, weights_only=False)["model"]
    got = state.model.state_dict()
    n = 0
    for key, val in enc.items():
        if key.startswith("encoder."):
            name = key[len("encoder."):].replace("norm.", "fc_norm.", 1) \
                if key.startswith("encoder.norm.") else key[len("encoder."):]
            assert torch.equal(got[name], val), name
            n += 1
    assert n == len(got) - 2              # all but the fresh head


def test_pretrain_cli_rejects_unported_options(full_root, tmp_path):
    """``--use_checkpoint``, once refused, now checkpoints every encoder
    and decoder block, of PretrainVideoMAE and of the InternVideo2 DAPT
    model (tests/test_torch_remat.py holds the step to the plain one),
    and one epoch runs."""
    from simple_tad_tpu_torch.cli.pretrain import main
    state = main(_args(full_root, str(tmp_path / "a"), "--use_checkpoint",
                       "--stop_at_epoch", "1"))
    assert state.model.cfg.remat and state.step == 4
    state = main(_args(full_root, str(tmp_path / "b"), "--model",
                       "pretrain_videomae_internvideo2_patch14_224",
                       "--input_size", "28", "--use_checkpoint",
                       "--stop_at_epoch", "1"))
    assert state.model.cfg.remat and state.step == 4


def test_trainer_epoch_takes_the_plain_loops_steps():
    """PretrainTrainer's epoch (each step's parts staged on the host while
    the previous step runs, uploaded and concatenated on the device, the
    loss read one step late) takes the same steps as the plain loop: the
    parts concatenated on the host, augmented, one step, its loss read.
    Parameters bit-equal after three steps of two parts, the same mean
    loss."""
    import copy

    import numpy as np
    from simple_tad_tpu_torch.cli.pretrain import PretrainTrainer
    from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.ops.augment import pretrain_augment_align
    from simple_tad_tpu_torch.train import optim as O
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_mae_train_step)
    model = create_model("pretrain_videomae_small_patch16_224",
                         device="cpu", img_size=32, all_frames=4,
                         decoder_depth=1, dtype=torch.float32,
                         param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    maskgen = TubeMaskingGenerator((2, 2, 2), 0.75)
    rng = np.random.default_rng(0)
    batches = [[{"video_u8": rng.integers(0, 256, (n, 4, 40, 64, 3),
                                          np.uint8),
                 "mask": maskgen.batch(n, rng)} for n in (2, 1)]
               for _ in range(3)]
    step = make_mae_train_step(num_masked=maskgen.total_masks)

    def state(m):
        opt = O.FinetuneOptimizer(dict(m.named_parameters()),
                                  lr_schedule=1e-3, weight_decay=0.05,
                                  betas=(0.9, 0.95))
        return TrainState.create(m, opt, torch.Generator().manual_seed(1))

    plain = state(copy.deepcopy(model))
    aug = torch.Generator().manual_seed(5 * 1_000_003 + 0)
    losses = []
    for parts in batches:
        video = torch.from_numpy(np.concatenate([p["video_u8"]
                                                 for p in parts]))
        mask = torch.from_numpy(np.concatenate([p["mask"] for p in parts]))
        metrics = step(plain, {"video": pretrain_augment_align(
            video, aug, crop_size=32), "mask": mask})
        losses.append(float(metrics["loss"]))

    trainer = PretrainTrainer(step, state(model), device="cpu",
                              crop_size=32, dtype=torch.float32, seed=5)
    stats = trainer.train_one_epoch(batches, 0)
    assert trainer.state.step == plain.step == 3
    assert stats["loss"] == pytest.approx(np.mean(losses), rel=1e-12)
    got = trainer.state.model.state_dict()
    for k, v in plain.model.state_dict().items():
        assert torch.equal(got[k], v), k
