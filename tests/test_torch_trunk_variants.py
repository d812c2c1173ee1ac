"""The port's MVD and UMT trunk variants (3-D sincos table, CLS token, UMT's
tubelet-1 table, learnable position tables, the K710 head remap) against
the JAX package and the executed-reference goldens, on CPU.

Tolerances: the goldens at tests/test_golden_parity.py's atol and rtol
1e-4; the position tables within 1e-6 (float64 math cast to fp32, or
torch's own resamplers on both sides); the head remap exactly; fp32
logits within 1e-4 (ROADMAP.md's slice gate); one fine-tune step at
tests/test_torch_train_step.py's bounds (loss 1e-5, every gradient leaf
1e-4, parameters and Adam moments 1e-5, each relative to the leaf's
largest magnitude); FrameEvaluator's logits within 1e-4 and its AUROC / AP
within 1e-6 (tests/test_torch_eval.py's); the static int8 MVD on the JAX
package's quantized, calibrated tree within 1e-5
(tests/test_torch_quant_vit.py's).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.data.frame_datasets import FrameDataset as JaxFrameDataset
from simple_tad_tpu.data.frame_datasets import read_dota_clips as jax_read
from simple_tad_tpu.eval.engine import FrameEvaluator as JaxFrameEvaluator
from simple_tad_tpu.models import layers as jax_layers
from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.ops import quant as jax_quant
from simple_tad_tpu.train import losses as JL
from simple_tad_tpu.train import optim as JO
from simple_tad_tpu.train.steps import TrainState as JaxTrainState
from simple_tad_tpu.train.steps import make_finetune_train_step as jax_step
from simple_tad_tpu.utils import torch_convert as jax_tc
from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dota_clips)
from simple_tad_tpu_torch.eval.engine import FrameEvaluator
from simple_tad_tpu_torch.models import create_model, layers
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.ops import quant
from simple_tad_tpu_torch.train import losses as L
from simple_tad_tpu_torch.train import optim as O
from simple_tad_tpu_torch.train.steps import (TrainState,
                                              make_finetune_train_step)
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.fixtures import make_synthetic_dota
from tests.test_torch_train_step import (_adam_moments, _tree_close,
                                         pallas)  # noqa: F401
from tests.test_torch_vit import (_golden, drop_checkpoints,  # noqa: F401
                                  one_torch_thread,
                                  perturbed_jax_params)

BASE = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_classes=2, init_scale=1.0)
# (name, config): MVD with and without its CLS token (8 and 9 tokens), UMT
# with its fixed table at tubelet 1 (4 frames: the table resized in space
# and time) and with a learnable table
VARIANTS = {
    "mvd_cls": dict(BASE, all_frames=4, tubelet_size=2, pos_embed_kind="3d",
                    use_cls_token=True),
    "mvd": dict(BASE, all_frames=4, tubelet_size=2, pos_embed_kind="3d"),
    "umt": dict(BASE, all_frames=4, tubelet_size=1, pos_embed_kind="umt"),
    "umt_learnable": dict(BASE, all_frames=4, tubelet_size=1,
                          pos_embed_kind="umt", use_learnable_pos_emb=True),
}


def _port(params, **cfg):
    model = VisionTransformer(ViTConfig(**cfg), device="cpu").eval()
    model.load_state_dict(tc.from_jax_params(
        params, tubelet_size=cfg["tubelet_size"]), strict=True)
    return model


def _video(seed, batch, frames, size=32):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name,model_name,overrides", [
    ("mvd_s_cls.npz", "mvd_vit_small_patch16_224", {"use_cls_token": True}),
    # frames != 8 made the UMT table a learned parameter in the reference
    ("umt_b.npz", "umt_vit_base_patch16_224",
     {"tubelet_size": 1, "use_learnable_pos_emb": True}),
    # the native 8-frame geometry: the fixed UMT table, generated here
    ("umt_s_8f.npz", "umt_vit_base_patch16_224",
     {"tubelet_size": 1, "embed_dim": 384, "num_heads": 6}),
])
def test_trunk_variant_goldens(name, model_name, overrides, tmp_path):
    _golden(name, model_name, tmp_path, **overrides)


@pytest.mark.parametrize("grid,frames", [(14, 8), (2, 4), (7, 2)])
def test_sincos_3d_pos_embed_matches_jax(grid, frames):
    for dim in (128, 768):
        got = layers.sincos_3d_pos_embed(dim, grid, frames)
        want = jax_layers.sincos_3d_pos_embed(dim, grid, frames)
        assert got.shape == (1, frames * grid * grid, dim)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_patches,frames,patch", [
    (1568, 8, 16), (784, 4, 16), (16, 4, 16), (8 * 256, 8, 14)])
def test_umt_pos_embed_matches_jax(num_patches, frames, patch):
    got = layers.umt_pos_embed(num_patches, 128, frames, patch)
    want = jax_layers.umt_pos_embed(num_patches, 128, frames, patch)
    assert got.shape == (1, num_patches, 128)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("orig,new", [(14, 2), (14, 14), (4, 7)])
def test_interpolate_pos_embed_matches_jax(orig, new):
    pos = np.random.default_rng(orig).standard_normal(
        (1, 3 * orig * orig, 64)).astype(np.float32)
    got = tc.interpolate_pos_embed(torch.from_numpy(pos), num_temporal=3,
                                   new_size=new)
    want = jax_tc.interpolate_pos_embed(pos, num_temporal=3, new_size=new)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_classes,label_map", [
    (400, None), (600, "map"), (700, "map"), (2, None), (710, None),
    (None, None)])
def test_remap_710_head_matches_jax(num_classes, label_map):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((710, 16)).astype(np.float32)
    b = rng.standard_normal(710).astype(np.float32)
    idx = (rng.permutation(710)[:num_classes].tolist() if label_map
           else None)
    gw, gb = tc._remap_710_head(torch.from_numpy(w), torch.from_numpy(b),
                                num_classes, idx)
    ww, wb = jax_tc._remap_710_head(w, b, num_classes, idx)
    np.testing.assert_array_equal(gw.numpy(), ww)
    np.testing.assert_array_equal(gb.numpy(), wb)


def test_710_head_remapped_into_a_400_class_model(tmp_path):
    """A K710 checkpoint's head loads into a 400-class ViT as its first 400
    rows; a learnable position table of another grid is resampled."""
    cfg = dict(VARIANTS["umt_learnable"], num_classes=400)
    model = VisionTransformer(ViTConfig(**cfg), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["head.weight"] = torch.randn(710, 128)
    sd["head.bias"] = torch.randn(710)
    pos = torch.randn(1, 4 * 14 * 14, 128)
    sd["pos_embed"] = pos
    path = str(tmp_path / "k710.pth")
    torch.save({"model": sd}, path)
    loaded = tc.load_checkpoint_auto(path, model)
    assert "head.weight" in loaded and "pos_embed" in loaded
    assert torch.equal(model.head.weight, sd["head.weight"][:400])
    np.testing.assert_allclose(
        model.pos_embed.detach().numpy(),
        jax_tc.interpolate_pos_embed(pos.numpy(), num_temporal=4,
                                     new_size=2), atol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_logits_match_jax(variant):
    cfg = VARIANTS[variant]
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=1)
    model = _port(params, **cfg)
    x = _video(2, 3, cfg["all_frames"])
    want = np.asarray(JaxViT(jcfg).apply({"params": params}, jnp.asarray(x)))
    n = jcfg.num_patches
    tokens = np.random.default_rng(3).standard_normal(
        (3, n, 128)).astype(np.float32)
    want_tok = np.asarray(JaxViT(jcfg).apply(
        {"params": params}, jnp.asarray(tokens), tokens_input=True))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        got_tok = model(torch.from_numpy(tokens), tokens_input=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_tok.numpy(), want_tok, atol=1e-4, rtol=0)
    # from_jax_params and to_jax_params are inverses on the variant's tree
    back = tc.to_jax_params(model.state_dict())
    _tree_close(back, params, 0.0, "round trip")


@pytest.mark.parametrize("variant", ["mvd_cls", "umt_learnable"])
def test_variant_finetune_step_matches_jax(variant, pallas):
    """One train step (AdamW, layer decay 0.75, weight decay 0.05, clip 1,
    the job's lr 5e-4) of the port against make_finetune_train_step from
    the same weights, the JAX side through its Pallas kernels in interpret
    mode (as tests/test_torch_train_step.py): loss, every gradient leaf,
    the parameters and Adam moments after the step."""
    cfg = dict(VARIANTS[variant], init_values=0.1)
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 2, 4)
    batch = {"video": _video(6, 4, cfg["all_frames"])
             + labels[:, None, None, None, None] * 0.5,
             "label": labels.astype(np.int32),
             "smoothed": np.zeros((4, 2), np.float32),
             "ttc": np.zeros(4, np.float32)}
    kw = dict(lr_schedule=5e-4, weight_decay=0.05, layer_decay=0.75,
              depth=2, clip_grad=1.0)
    tx = JO.create_optimizer(params, **kw)
    jstep = jax_step(JaxViT(jcfg), tx, JL.create_criterion("crossentropy"),
                     donate=False)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx, jax.random.PRNGKey(1))
    jstate, (jm, _) = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                           batch))
    model = VisionTransformer(ViTConfig(**cfg, param_dtype=torch.float32),
                              device="cpu")
    model.load_state_dict(tc.from_jax_params(
        params, tubelet_size=cfg["tubelet_size"]))
    opt = O.FinetuneOptimizer(dict(model.named_parameters()), **kw)
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0))
    step = make_finetune_train_step(L.create_criterion("crossentropy"))
    m, _ = step(state, {k: torch.from_numpy(v).long() if k == "label"
                        else torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _tree_close(tc.to_jax_params({n: p.grad for n, p in
                                  model.named_parameters()}),
                jax.grad(lambda p: JL.cross_entropy(
                    JaxViT(jcfg).apply({"params": p},
                                       jnp.asarray(batch["video"]),
                                       deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(0),
                                             "droppath":
                                                 jax.random.PRNGKey(0)}),
                    jnp.asarray(batch["label"])))(
                        jax.tree_util.tree_map(jnp.asarray, params)),
                1e-4, "grad")
    _tree_close(tc.to_jax_params(model.state_dict()), jstate.params, 1e-5,
                "params")
    mu, nu = _adam_moments(jstate.opt_state)
    _tree_close(tc.to_jax_params(opt.mu), mu, 1e-5, "mu")
    _tree_close(tc.to_jax_params(opt.nu), nu, 1e-5, "nu")


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    return make_synthetic_dota(str(tmp_path_factory.mktemp("dota")),
                               n_clips=2, frames_per_clip=30, h=72, w=128)


@pytest.mark.parametrize("variant,frames,target_fps", [
    ("mvd_cls", 4, 10), ("umt", 4, 5)])
def test_frame_evaluator_matches_jax(dota_root, variant, frames,
                                     target_fps):
    """FrameEvaluator's token path (the CLS token and the table added inside
    the model; UMT's tubelet 1 embedding each frame once) against the JAX
    evaluator, and against the port's own pixel path."""
    cfg = VARIANTS[variant]
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=7)
    model = _port(params, **cfg)

    def ds(cls, read):
        return cls(read(dota_root, "val_split.txt"), mode="test",
                   view_len=frames, target_fps=target_fps, orig_fps=10,
                   view_step=1, crop_size=32)

    jres = JaxFrameEvaluator(JaxViT(jcfg), params, batch_size=8,
                             frame_bucket=64, dtype=jnp.float32,
                             resize_on_host=True).evaluate(
                                 ds(JaxFrameDataset, jax_read))
    port_ds = ds(FrameDataset, read_dota_clips)
    res = FrameEvaluator(model, device="cpu", batch_size=8,
                         resize_on_host=True).evaluate(port_ds)
    assert res.n_windows == jres.n_windows > 0
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_allclose(res.rows[col], jres.rows[col].to_numpy(),
                                   atol=1e-4)
    for key in ("auroc", "ap"):
        assert abs(getattr(res.metrics, key)
                   - getattr(jres.metrics, key)) <= 1e-6, key
    view = port_ds.clip_eval_views()[0]
    pix = FrameEvaluator(model, device="cpu", batch_size=8,
                         precompute_tubelets=False).score_view(port_ds, view)
    tok = FrameEvaluator(model, device="cpu",
                         batch_size=8).score_view(port_ds, view)
    np.testing.assert_allclose(tok, pix, atol=1e-5)


@pytest.mark.parametrize("variant", ["mvd_cls"])
def test_static_int8_variant_on_jax_tree_matches_jax(variant, monkeypatch):
    """The JAX package quantizes and calibrates the MVD trunk (CLS token,
    3-D table); the port's static int8 model on that tree gives its
    logits."""
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LNQ", "force")
    monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")
    cfg = VARIANTS[variant]
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=0)
    x = _video(1, 4, cfg["all_frames"])
    jm, qp = jax_quant.quantize_and_calibrate(JaxViT(jcfg), params,
                                              [jnp.asarray(x)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply({"params": qp}, jnp.asarray(x)))
    sd = tc.from_jax_params(jax.tree_util.tree_map(np.asarray, qp))
    assert "cls_token" in sd
    model = quant.quant_model(ViTConfig(**cfg), sd, "static", "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_registry_builds_the_job_trunks():
    """The MVD-B and UMT-B names build (UMT at its job geometry: tubelet 1,
    8 frames, N = 1568); so does the InternVideo2 pre-training name, at
    its own tubelet 1."""
    mvd = create_model("mvd_vit_base_patch16_224", device="meta",
                       use_cls_token=True)
    umt = create_model("umt_vit_base_patch16_224", device="meta")
    assert mvd.cfg.pos_embed_kind == "3d" and mvd.cls_token is not None
    assert (umt.cfg.tubelet_size, umt.cfg.all_frames,
            umt.cfg.num_patches) == (1, 8, 1568)
    iv2 = create_model("pretrain_videomae_internvideo2_patch14_224",
                       device="meta")
    assert (iv2.cfg.tubelet_size, iv2.cfg.num_patches) == (1, 2048)


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    from tests.fixtures import make_synthetic_dota_full
    return make_synthetic_dota_full(str(tmp_path_factory.mktemp("full")),
                                    n_clips=1, frames_per_clip=24, h=48,
                                    w=64)


@pytest.mark.parametrize("cli,model", [
    ("eval_frames", "umt_vit_base_patch16_224"),
    ("finetune", "mvd_vit_base_patch16_224"),
    ("inference", "mvd_vit_small_patch16_224")])
def test_clis_take_the_variant_trunks(cli, model, full_root, tmp_path):
    """The three CLIs build the MVD and UMT trunks (UMT with the flags of
    jobs/finetune/UMT-B_D2K.sh: tubelet 1, 8 frames, view_fps 5; the
    fine-tuning CLI with --epochs 0 builds, loads and returns)."""
    import importlib
    main = importlib.import_module(f"simple_tad_tpu_torch.cli.{cli}").main
    out = str(tmp_path / "out")
    common = ["--model", model, "--input_size", "32", "--device", "cpu"]
    if cli == "inference":
        from simple_tad_tpu_torch.models import create_model as build
        ckpt = str(tmp_path / "w.pth")
        torch.save({"model": build(model, device="cpu", img_size=32,
                                   all_frames=16,
                                   generator=torch.Generator().manual_seed(1)
                                   ).state_dict()}, ckpt)
        import zipfile
        frames = tmp_path / "frames"
        frames.mkdir()
        zp = os.path.join(full_root, "frames", "val_000", "images.zip")
        with zipfile.ZipFile(zp) as z:
            for name in sorted(z.namelist())[:17]:
                (frames / name).write_bytes(z.read(name))
        rows = main(common + ["--ckpt", ckpt, "--frames_folder", str(frames),
                              "--dtype", "float32"])
        assert len(rows) == 1 and 0.0 <= rows[0][1] <= 1.0
        return
    args = common + ["--data_set", "DoTA", "--data_path", full_root,
                     "--dtype", "float32", "--batch_size", "4",
                     "--output_dir", out]
    if model.startswith("umt"):
        args += ["--tubelet_size", "1", "--num_frames", "8", "--view_fps",
                 "5"]
    if cli == "finetune":
        state = main(args + ["--epochs", "0", "--warmup_epochs", "0",
                             "--num_workers", "1"])
        assert state.model.cfg.pos_embed_kind == "3d"
    else:
        res = main(args)
        assert res.n_windows > 0 and np.isfinite(
            res.rows["logits_risk"]).all()
        assert os.path.exists(os.path.join(out, "predictions.csv"))
