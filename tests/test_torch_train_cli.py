"""The port's fine-tuning CLI (simple_tad_tpu_torch.cli.finetune) end to
end on the CPU, on the synthetic DoTA fixture with the arguments
tests/test_cli.py gives the JAX CLI (ViT-S, 32x32 input, fp32, one
epoch): it writes log.txt, checkpoint-last and the best-metric
checkpoints, a second run auto-resumes, and the options once refused
(--zero_stage, --use_checkpoint, the optimizer menu) run."""

import glob
import json
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
    return ["--data_set", "DoTA", "--data_path", root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--num_frames", "16", "--batch_size", "4", "--epochs", "1",
            "--warmup_epochs", "0", "--output_dir", out,
            "--dtype", "float32", "--attn_impl", "naive",
            "--num_workers", "2", "--drop_path", "0.0", "--device", "cpu",
            *extra]


def test_finetune_cli_one_epoch_and_auto_resume(full_root, tmp_path):
    from simple_tad_tpu_torch.cli.finetune import main
    out = str(tmp_path / "run")
    state = main(_args(full_root, out, "--model_ema",
                       "--model_ema_decay", "0.5"))
    assert state.step > 0 and state.optimizer.count == state.step
    for name in ("checkpoint-last.pth", "log.txt", "params.json"):
        assert os.path.exists(os.path.join(out, name)), name
    best = glob.glob(os.path.join(out, "checkpoint-best*.pth"))
    assert len(best) == 4
    with open(os.path.join(out, "log.txt")) as f:
        record = json.loads(f.readline())
    assert record["epoch"] == 0 and "val_auroc" in record
    # the best checkpoints hold the EMA weights, the masters stay fp32
    ema = torch.load(best[0], weights_only=False)["model"]
    params = state.model.state_dict()
    assert all(v.dtype == torch.float32 for v in params.values())
    assert any(not torch.equal(ema[k], params[k]) for k in params)
    resumed = main(_args(full_root, out, "--model_ema",
                         "--model_ema_decay", "0.5"))
    assert resumed.step == state.step            # restored, no new steps
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, params[k]), k


@pytest.mark.parametrize("extra,match", [
    (["--zero_stage", "1"], "DDP"),
    (["--use_checkpoint"], "remat"),
    (["--opt", "lamb"], "optimizer"),
])
def test_finetune_cli_rejects_unported_options(full_root, tmp_path, extra,
                                               match):
    """The options the CLI once rejected as unported (``match`` names
    which) now run an epoch: ``--zero_stage`` (one process: nothing to
    shard), ``--use_checkpoint`` (the model checkpoints its blocks) and
    ``--opt lamb``; several devices in one process are still refused, in
    favour of one process per card under torchrun."""
    from simple_tad_tpu_torch.cli.finetune import main
    state = main(_args(full_root, str(tmp_path / "x"), *extra))
    assert state.step > 0 and state.optimizer.count == state.step
    if match == "DDP":
        assert state.optimizer.zero_stage == 0 and state.optimizer.owner \
            is None
    elif match == "remat":
        assert state.model.cfg.remat
    else:
        assert state.optimizer.opt == "lamb"
        assert set(state.optimizer.state) == {"mu", "nu"}
    with pytest.raises(ValueError, match="torchrun"):
        main(_args(full_root, str(tmp_path / "y"), *extra) + [
            "--device", "cpu,cpu"])


def test_attention_dropout_raises_in_training():
    """Attention dropout no longer raises in training (kernels C4 are
    ported): evaluation draws nothing, training draws the keep source from
    the generator and changes the output.  The form is checked at
    construction."""
    from simple_tad_tpu_torch.models import create_model
    model = create_model("vit_small_patch16_224", device="cpu", img_size=32,
                         depth=1, all_frames=4, attn_drop_rate=0.5,
                         param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 32, 32, 3,
                    generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    state = g.get_state()
    with torch.inference_mode():
        clean = model(x, generator=g)             # eval: no dropout
    assert torch.equal(g.get_state(), state)
    model.train()
    with torch.no_grad():
        dropped = model(x, generator=g)
    assert not torch.equal(g.get_state(), state)
    assert not torch.allclose(dropped, clean)
    with pytest.raises(ValueError, match="attn_dropout_form"):
        create_model("vit_small_patch16_224", device="cpu", img_size=32,
                     depth=1, attn_drop_rate=0.1, attn_dropout_form="bits")


def test_finetune_checkpoint_loads_into_fp32_training_model(tmp_path):
    """--finetune: a reference .pth fills the fp32 masters by name."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.utils.torch_convert import load_vit_checkpoint
    kw = dict(device="cpu", img_size=32, depth=2, all_frames=4)
    src = create_model("vit_small_patch16_224",
                       generator=torch.Generator().manual_seed(1), **kw)
    path = str(tmp_path / "init.pth")
    torch.save({"model": {"encoder." + k: v
                          for k, v in src.state_dict().items()}}, path)
    model = create_model("vit_small_patch16_224", param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0), **kw)
    loaded = load_vit_checkpoint(path, model)
    assert set(loaded) == set(model.state_dict())
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert torch.equal(p, src.state_dict()[n]), n


def test_trainer_stops_on_a_non_finite_loss():
    """The NaN hard exit (engine_for_frame_finetuning.py:148-150)."""
    import numpy as np
    from simple_tad_tpu_torch.train.engine import FinetuneTrainer

    class Loader:
        def epoch(self, epoch):
            yield {"video_u8": np.zeros((2, 2, 24, 40, 3), np.uint8),
                   "label": np.array([0, 1]),
                   "smoothed": np.zeros((2, 2), np.float32),
                   "ttc": np.zeros(2, np.float32)}

    def step(state, batch):
        return {"loss": torch.tensor(float("nan")),
                "grad_norm": torch.tensor(0.0),
                "acc": torch.tensor(0.0)}, torch.zeros(2, 2)

    trainer = FinetuneTrainer(step, None, device="cpu", crop_size=16)
    with pytest.raises(FloatingPointError, match="nan"):
        trainer.train_one_epoch(Loader(), 0)
