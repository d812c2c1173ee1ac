"""The port's InternVideo2 DAPT model (simple_tad_tpu_torch.models.mae.
PretrainIV2VideoMAE), its warm start, its registry names and the
pre-training CLI on the IV2 DAPT job's flags, against the JAX package.

A tiny IV2 MAE: 2 frames of 28 x 28 at patch 14, tubelet 1 (8 tokens, 6
masked at 0.75), the encoder 128 wide with 2 heads of 64 and depth 2, the
decoder 64 wide with 1 head and depth 2, LayerScale 0.1 so the blocks move
the output.  Tolerances: predictions within 1e-4 at fp32 (the JAX side's
XLA attention against the port's plain one); one and two MAE steps as
tests/test_torch_mae.py holds PretrainVideoMAE (loss and global norm 1e-5
relative, every gradient leaf 1e-4 and parameters and Adam moments 1e-5 of
the leaf's largest magnitude), the JAX side through its Pallas kernels in
interpret mode; the warm starts and the parameter round trip exact.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models import list_models as jax_list_models
from simple_tad_tpu.models import mae as jax_mae
from simple_tad_tpu.models.layers import sincos_3d_pos_embed
from simple_tad_tpu.ops.image import IMAGENET_MEAN, IMAGENET_STD
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_mae_train_step as jax_mae_step
from simple_tad_tpu.utils import torch_convert as jax_tc
from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
from simple_tad_tpu_torch.models import create_model, list_models, mae
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import TrainState, make_mae_train_step
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_train_step import (_adam_moments, _tree_close,
                                         pallas)  # noqa: F401
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

TINY = dict(img_size=28, all_frames=2, encoder_embed_dim=128,
            encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=64,
            decoder_depth=2, decoder_num_heads=1, init_values=0.1)
B = 3


def _masks(seed, batch=B, window=(2, 2, 2), ratio=0.75):
    gen = TubeMaskingGenerator(window, ratio)
    return gen.batch(batch, np.random.default_rng(seed)), gen.total_masks


def _jax_model(cfg, **kw):
    return jax_mae.PretrainIV2VideoMAE(jax_mae.IV2MAEConfig(**cfg, **kw))


@functools.lru_cache(maxsize=None)
def _init_tree(items, seed):
    """The JAX init of the config ``items`` (a sorted tuple), once a seed."""
    mask, nm = _masks(0, 1)
    return _jax_model(dict(items)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, 28, 28, 3)),
        jnp.asarray(mask), nm)["params"]


def _jax_params(cfg, seed=0, noise=0.02):
    params = _init_tree(tuple(sorted(cfg.items())), seed)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + noise * rng.standard_normal(a.shape).astype(np.float32), params)


def _port(params, cfg, **extra):
    model = mae.PretrainIV2VideoMAE(mae.IV2MAEConfig(**cfg, **extra),
                                    device="cpu")
    model.load_state_dict(tc.from_jax_params(params), strict=True)
    return model


@pytest.mark.parametrize("sep_pos_embed", [False, True],
                         ids=["joint", "sep"])
def test_predictions_match_jax(sep_pos_embed):
    cfg = dict(TINY, sep_pos_embed=sep_pos_embed)
    params = _jax_params(cfg)
    model = _port(params, cfg).eval()
    video = np.random.default_rng(4).standard_normal(
        (B, 2, 28, 28, 3)).astype(np.float32)
    mask, nm = _masks(5)
    want = _jax_model(cfg).apply({"params": params}, jnp.asarray(video),
                                 jnp.asarray(mask), nm)
    with torch.inference_mode():
        got = model(torch.from_numpy(video), torch.from_numpy(mask), nm)
    assert got.shape == (B, nm, 588) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    _tree_close(tc.to_jax_params(model.state_dict()), params, 0.0,
                "round trip")


def test_mae_steps_match_jax(pallas):
    """One step's loss and every gradient leaf, then the parameters and
    Adam moments after one and two steps, of make_mae_train_step on the
    588-wide targets against the JAX step (the DAPT job's AdamW: betas
    0.9 / 0.95, weight decay 0.05 on a cosine schedule), from the same
    weights."""
    params = _jax_params(TINY, seed=1)
    rng = np.random.default_rng(6)
    batches = []
    for i in range(2):
        mask, nm = _masks(7 + i)
        batches.append({"video": rng.standard_normal(
            (B, 2, 28, 28, 3)).astype(np.float32), "mask": mask})
    lr = JO.cosine_scheduler(3e-4 * B / 256, 3e-5, 1, 4)
    wd = JO.cosine_scheduler(0.05, 0.05, 1, 4)
    kw = dict(weight_decay=0.05, betas=(0.9, 0.95))
    jm = _jax_model(TINY, attn_impl="pallas")
    tx = JO.create_optimizer(params, lr_schedule=JO.array_schedule(lr),
                             wd_schedule=JO.array_schedule(wd), **kw)
    jstep = jax_mae_step(jm, tx, num_masked=nm, donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    model = _port(params, TINY, param_dtype=torch.float32)
    opt = O.FinetuneOptimizer(dict(model.named_parameters()),
                              lr_schedule=O.array_schedule(lr),
                              wd_schedule=O.array_schedule(wd), **kw)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    step = make_mae_train_step(num_masked=nm)

    def jax_loss(p, b):
        targets = jax_mae.mae_targets_fused(
            jnp.asarray(b["video"]), jnp.asarray(b["mask"]), nm,
            mean=jnp.asarray(IMAGENET_MEAN), std=jnp.asarray(IMAGENET_STD),
            patch_size=14, tubelet_size=1)
        pred = jm.apply({"params": p}, jnp.asarray(b["video"]),
                        jnp.asarray(b["mask"]), nm)
        return jnp.mean(jnp.square(pred - targets))

    for i, b in enumerate(batches):
        if i == 0:
            want_loss, want_grads = jax.value_and_grad(jax_loss)(
                jstate.params, b)
        jstate, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                                       rtol=1e-5)
            _tree_close(tc.to_jax_params({n: p.grad for n, p in
                                          model.named_parameters()}),
                        want_grads, 1e-4, "grad")
        _tree_close(tc.to_jax_params(model.state_dict()), jstate.params,
                    1e-5, f"params after step {i + 1}")
    assert state.step == 2 and opt.count == 2
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")


def _student_sd(seed, frames=2):
    """A stage-2 distillation student's state dict (the IV2 DAPT job's
    --from_ckpt): its trunk 128 wide at depth 2, the pos table with its
    CLS row, the tap decoders and pooling head the warm start ignores."""
    student = create_model(
        "distill_internvideo2_small_patch14_224", device="cpu",
        img_size=28, num_frames=frames, embed_dim=128, depth=2, num_heads=2,
        clip_teacher_embed_dim=96, clip_teacher_final_dim=64,
        clip_return_layer=1, clip_student_return_interval=1.0,
        generator=torch.Generator().manual_seed(seed))
    return dict(student.state_dict())


def _warm_start(sd, tmp_path, cfg=TINY):
    """(the port's model after load_checkpoint_auto, the JAX package's
    torch_to_iv2_mae_params merged over the same initial tree)."""
    path = str(tmp_path / "init.pth")
    torch.save({"model": sd}, path)
    params = _jax_params(cfg, seed=2)
    model = _port(params, cfg)
    loaded = tc.load_checkpoint_auto(path, model)
    want = jax_tc.merge_params(params, jax_tc.torch_to_iv2_mae_params(
        {k: v.numpy() for k, v in sd.items()}, encoder_depth=2,
        decoder_depth=2, encoder_dim=cfg["encoder_embed_dim"]))
    return model, loaded, want


def test_distill_student_warm_start_matches_jax(tmp_path):
    """The IV2 DAPT job's warm start from a stage-2 student .pth: the
    encoder's patch embedding, blocks and position table (its CLS row
    dropped) load, the decoder keeps its initialisation, as the JAX
    converter merged over the JAX init; the student's fc-free trunk has no
    norm for the encoder's."""
    sd = _student_sd(3)
    assert sd["pos_embed"].shape == (1, 9, 128)
    model, loaded, want = _warm_start(sd, tmp_path)
    assert "encoder.pos_embed" in loaded and not any(
        k.startswith("decoder.") for k in loaded)
    _tree_close(tc.to_jax_params(model.state_dict()), want, 0.0, "merged")
    torch.testing.assert_close(model.encoder.pos_embed.detach(),
                               sd["pos_embed"][:, 1:], rtol=0, atol=0)


def test_trunk_and_dapt_warm_starts_match_jax(tmp_path):
    """An InternVideo2 fine-tuning trunk (fc_norm at the encoder's width
    loads as the encoder's norm), and a whole DAPT checkpoint (every key
    by name), each equal to the JAX converter merged over the same init;
    a file without a block key, or with another temporal geometry,
    raises."""
    trunk = create_model("internvideo2_small_patch14_224", device="cpu",
                         img_size=28, num_frames=2, embed_dim=128, depth=2,
                         num_heads=2, attn_pool_num_heads=2,
                         clip_embed_dim=128, num_classes=5,
                         generator=torch.Generator().manual_seed(4))
    model, loaded, want = _warm_start(dict(trunk.state_dict()), tmp_path)
    assert "encoder.norm.weight" in loaded
    _tree_close(tc.to_jax_params(model.state_dict()), want, 0.0, "trunk")

    src = _port(_jax_params(TINY, seed=5), TINY)
    model, loaded, want = _warm_start(dict(src.state_dict()), tmp_path)
    assert set(loaded) == set(model.state_dict())
    _tree_close(tc.to_jax_params(model.state_dict()), want, 0.0, "dapt")

    sd = _student_sd(6)
    del sd["blocks.1.ls2.gamma"]
    with pytest.raises(KeyError, match="ls2.gamma"):
        _warm_start(sd, tmp_path)
    # a 4-frame student into a 2-frame model: the position tables differ
    # in length, and both packages refuse the merge (ROADMAP.md F8)
    sd = _student_sd(7, frames=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        _warm_start(sd, tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_tc.merge_params(_jax_params(TINY), jax_tc.torch_to_iv2_mae_params(
            {k: v.numpy() for k, v in sd.items()}, encoder_depth=2,
            decoder_depth=2, encoder_dim=128))


def test_registry_builds_every_jax_name():
    """Every name of the JAX registry builds in the port; the IV2 DAPT
    names at patch 14, tubelet 1, a 588-wide head, bias-free qkv, QK-norm,
    LayerScale 1e-5, and the joint table initialised to the 3-D sincos
    table without a CLS row."""
    assert set(list_models()) == set(jax_list_models())
    for name in list_models():
        create_model(name, device="meta")
    for name in ["pretrain_videomae_internvideo2_patch14_224"] + [
            f"pretrain_videomae_internvideo2_{s}_patch14_224"
            for s in ("small", "base", "large", "huge")]:
        m = create_model(name, device="meta")
        assert isinstance(m, mae.PretrainIV2VideoMAE), name
        c = m.cfg
        assert (c.patch_size, c.tubelet_size, c.decoder_num_classes,
                c.qkv_bias, c.qk_normalization, c.init_values) == (
                    14, 1, 588, False, True, 1e-5), name
    m = create_model("pretrain_videomae_internvideo2_patch14_224",
                     device="cpu", img_size=28, all_frames=2,
                     generator=torch.Generator().manual_seed(0))
    assert (m.cfg.encoder_embed_dim, m.cfg.decoder_embed_dim) == (384, 192)
    np.testing.assert_allclose(m.encoder.pos_embed.detach().numpy(),
                               sincos_3d_pos_embed(384, 2, 2), atol=1e-6)
    with pytest.raises(ValueError, match="588"):
        create_model("pretrain_videomae_internvideo2_patch14_224",
                     device="meta", tubelet_size=2)


def _bdd_root(root, n=3, frames=90):
    """BDD100K-style .mov videos (30 fps, 16:9 as the DoTA fixture's
    frames, so both datasets' windows concatenate) under root/videos."""
    import cv2
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    for i in range(n):
        path = os.path.join(root, "videos", f"clip{i}.mov")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (128, 72))
        for t in range(frames):
            wr.write(np.full((72, 128, 3), (3 * t + 40 * i) % 256, np.uint8))
        wr.release()
    return root


def test_pretrain_cli_on_the_iv2_dapt_jobs_flags(tmp_path):
    """jobs/dapt/IV2-S_dapt_bdd_capdata.sh's flags at a tiny size (input
    28, 16 frames: 16 x 2 x 2 tokens, tube masks at 0.75), BDD100K + DoTA,
    without --tubelet_size (the JAX CLI passes its default 2 and fails,
    ROADMAP.md F7), warm-started from a 16-frame stage-2 student: the
    model keeps tubelet 1 and the steps run."""
    from simple_tad_tpu_torch.cli.pretrain import main
    from tests.fixtures import make_synthetic_dota_full
    bdd = _bdd_root(str(tmp_path / "bdd"))
    cap = make_synthetic_dota_full(str(tmp_path / "cap"))
    student = create_model(
        "distill_internvideo2_small_patch14_224", device="cpu",
        img_size=28, num_frames=16, clip_teacher_embed_dim=96,
        clip_teacher_final_dim=64, clip_return_layer=1,
        clip_student_return_interval=1.0,
        generator=torch.Generator().manual_seed(9))
    sd = dict(student.state_dict())
    init = str(tmp_path / "S14_dist_1B_stage2.pth")
    torch.save({"model": sd}, init)
    out = str(tmp_path / "run")
    argv = ["--model", "pretrain_videomae_internvideo2_small_patch14_224",
            "--data_set", "BDD100K", "--data_path", bdd,
            "--data_set2", "DoTA", "--data_path2", cap,
            "--mask_ratio", "0.75", "--decoder_depth", "4",
            "--batch_size", "2", "--batch_size2", "1",
            "--num_frames", "16", "--sampling_rate", "4",
            "--opt_betas", "0.9", "0.95", "--lr", "3e-4", "--min_lr", "3e-5",
            "--warmup_epochs", "1", "--epochs", "2", "--stop_at_epoch", "1",
            "--save_ckpt_freq", "1", "--nb_samples_per_epoch", "4",
            "--from_ckpt", init, "--input_size", "28", "--dtype", "float32",
            "--num_workers", "2", "--output_dir", out, "--device", "cpu"]
    state = main(argv)
    model = state.model
    assert isinstance(model, mae.PretrainIV2VideoMAE)
    assert model.cfg.tubelet_size == 1 and model.cfg.num_patches == 64
    # CyclicZip: the dataset with more batches (DoTA, 4 of batch 1) drives
    assert state.step == 4 and state.optimizer.count == 4
    assert os.path.exists(os.path.join(out, "checkpoint-0.pth"))
    weights = torch.load(os.path.join(out, "checkpoint-0.pth"),
                         weights_only=False)["model"]
    assert weights["decoder.head.weight"].shape == (588, 192)
    # the warm start reached the encoder: its first block moved from the
    # student's weights by four small steps only
    diff = (weights["encoder.blocks.0.attn.qkv.weight"]
            - sd["blocks.0.attn.qkv.weight"]).abs().max()
    assert 0 < diff < 1e-2
