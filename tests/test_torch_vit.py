"""Port ViT (simple_tad_tpu_torch.models) against the JAX package's
VisionTransformer, the reference .pth layout and the executed-reference
goldens.

Tolerance: fp32 logits within 1e-4 (ROADMAP.md's slice gate); the goldens
at tests/test_golden_parity.py's 1e-4 atol and rtol.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.utils import torch_convert as jax_tc
from simple_tad_tpu_torch.models import create_model
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests import golden_utils as gu
from tests import torch_ref

TINY = dict(img_size=32, all_frames=16, patch_size=16, tubelet_size=2,
            embed_dim=128, depth=2, num_heads=2, num_classes=2,
            init_scale=1.0)          # N = 8 * 2 * 2 = 32 tokens, Dh = 64
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch CPU work on one intra-op thread (autouse here
    and in each port test module that imports it).  Under pytest-xdist
    every worker would otherwise start a thread per core, and the many
    small ops of these tests then wait on each other's thread barriers: a
    CLI test that takes seconds alone took minutes in the parallel suite."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_checkpoints(request):
    """Delete the checkpoints (*.pth) a test wrote under its tmp_path once
    it has read them (autouse here and in each port test module that
    imports it).  pytest keeps the last runs' temporary directories, and
    the CLI tests' full-width checkpoints (0.3-0.7 GB a test) filled the
    disk of a whole tier-1 run."""
    root = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if root is not None:
        for path in root.rglob("*.pth*"):
            path.unlink()


def perturbed_jax_params(cfg, seed=0):
    """JAX init, then every leaf moved by seeded numpy noise so q/v biases,
    LayerNorms, gammas and the head are all exercised."""
    params = JaxViT(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name or "gamma" in name:
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params)


def port_model_from(jax_params, **cfg):
    model = VisionTransformer(ViTConfig(**cfg), device="cpu").eval()
    model.load_state_dict(tc.from_jax_params(jax_params), strict=True)
    return model


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("final_reduction,init_values",
                         [("fc_norm", 0.0), ("fc_norm", 0.1), ("none", 0.1)])
def test_vit_matches_jax(final_reduction, init_values, kernels, monkeypatch):
    cfg = dict(TINY, final_reduction=final_reduction, init_values=init_values)
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg)
    model = port_model_from(params, **cfg)
    rng = np.random.default_rng(1)
    video = rng.standard_normal((2, 16, 32, 32, 3)).astype(np.float32)
    tokens = rng.standard_normal((2, 32, 128)).astype(np.float32)

    jm = JaxViT(jcfg)
    if kernels == "pallas":
        monkeypatch.setenv("SIMPLE_TAD_FORCE_PACKED_ATTN", "1")
        monkeypatch.setenv("SIMPLE_TAD_FUSED_LN", "force")
    with pltpu.force_tpu_interpret_mode():
        want_px = jm.apply({"params": params}, jnp.asarray(video))
        want_tok = jm.apply({"params": params}, jnp.asarray(tokens),
                            tokens_input=True)
    with torch.inference_mode():
        got_px = model(torch.from_numpy(video))
        got_tok = model(torch.from_numpy(tokens), tokens_input=True)
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-4)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok),
                               atol=1e-4)


def test_folded_normalization_matches_normalized_pixels():
    """The folded patch weights (what FrameEvaluator embeds raw frames
    with) equal the JAX package's fold, and the model on raw pixels with
    them equals the model on normalized pixels (tests/test_fold_norm.py's
    tolerance)."""
    from simple_tad_tpu.utils.fold_norm import \
        fold_normalization as jax_fold_normalization
    from simple_tad_tpu_torch.ops.image import normalize
    from simple_tad_tpu_torch.utils.fold_norm import fold_normalization
    params = perturbed_jax_params(JaxViTConfig(**TINY), seed=6)
    model = port_model_from(params, **TINY)
    folded = port_model_from(params, **TINY)
    w, b = fold_normalization(folded.patch_embed.proj.weight,
                              folded.patch_embed.proj.bias)
    with torch.no_grad():
        folded.patch_embed.proj.weight.copy_(w)
        folded.patch_embed.proj.bias.copy_(b)
    jax_sd = tc.from_jax_params(jax_fold_normalization(params))
    for name, got in (("weight", w), ("bias", b)):
        np.testing.assert_allclose(
            got.numpy(), jax_sd[f"patch_embed.proj.{name}"].numpy(),
            rtol=1e-6, atol=1e-6, err_msg=name)

    u8 = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 16, 32, 32, 3), dtype=np.uint8))
    with torch.inference_mode():
        want = model(normalize(u8))
        got = folded(u8.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-4)


def test_from_jax_params_matches_jax_exporter_and_round_trips():
    jcfg = JaxViTConfig(**dict(TINY, init_values=0.1))
    params = perturbed_jax_params(jcfg, seed=2)
    sd = tc.from_jax_params(params)
    ref = jax_tc.vit_params_to_torch_state_dict(params)
    assert sorted(sd) == sorted(ref)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    back = jax_tc.torch_to_vit_params({k: v.numpy() for k, v in sd.items()},
                                      depth=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, back),
                           jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("prefix", ["", "backbone."])
def test_pth_checkpoint_loads_by_name(prefix, tmp_path):
    sd = torch_ref.make_vit_state_dict(3, dim=128, depth=2, heads=2,
                                       gamma=True)
    sd["pos_embed"] = torch.zeros(1, 32, 128)       # fixed table: not loaded
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {prefix + k: v for k, v in sd.items()}}, path)
    model = VisionTransformer(ViTConfig(**dict(TINY, init_values=0.1)),
                              device="cpu").init_weights(
                                  torch.Generator().manual_seed(0)).eval()
    loaded = tc.load_vit_checkpoint(path, model)
    assert "pos_embed" not in loaded and "head.weight" in loaded
    x = np.random.default_rng(4).standard_normal(
        (2, 16, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        want = torch_ref.vit_forward(
            sd, torch.from_numpy(x.transpose(0, 4, 1, 2, 3)), depth=2,
            heads=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_pth_mismatched_head_is_dropped(tmp_path):
    sd = torch_ref.make_vit_state_dict(5, dim=128, depth=2, heads=2,
                                       num_classes=3)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"module": sd}, path)
    model = create_model("vit_small_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         **dict(TINY, num_classes=2))
    head = model.head.weight.clone()
    loaded = tc.load_vit_checkpoint(path, model)
    assert "head.weight" not in loaded and "blocks.1.mlp.fc2.bias" in loaded
    assert torch.equal(model.head.weight, head)


def _golden(name, model_name, tmp_path, **overrides):
    path = os.path.join(GOLDENS, name)
    if not os.path.exists(path):
        pytest.skip(f"golden fixture {name} missing")
    want, manifest, meta = gu.load_golden(path)
    sd = gu.build_state_dict(manifest)
    ckpt = str(tmp_path / "golden.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    model = create_model(model_name, device="cpu",
                         num_classes=meta["num_classes"],
                         all_frames=meta["all_frames"], **overrides)
    loaded = tc.load_vit_checkpoint(ckpt, model)
    assert set(loaded) == set(model.state_dict())     # every weight loaded
    x = gu.input_video(meta["input_seed"], meta["batch"],
                       meta["all_frames"], 224)
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 2, 3, 4, 1)).contiguous())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,model_name,overrides", [
    ("vit_s_fcnorm.npz", "vit_small_patch16_224", {}),
    ("vit_b_gamma.npz", "vit_base_patch16_224", {"init_values": 0.1}),
    ("vit_s_tokens.npz", "vit_small_patch16_224",
     {"final_reduction": "none"}),
])
def test_executed_reference_goldens(name, model_name, overrides, tmp_path):
    _golden(name, model_name, tmp_path, **overrides)


def test_unported_variants_raise():
    """The MVD and UMT trunks (tests/test_torch_trunk_variants.py), the
    InternVideo2 distillation students (tests/test_torch_distill.py) and
    the InternVideo2 pre-training models (tests/test_torch_iv2_mae.py) are
    ported, and so is gradient checkpointing (tests/test_torch_remat.py);
    a name outside the registry raises naming ROADMAP.md."""
    from simple_tad_tpu_torch.models.iv2_distill import DistillInternVideo2
    from simple_tad_tpu_torch.models.mae import PretrainIV2VideoMAE
    for name in ["pretrain_videomae_internvideo2_patch14_224"] + [
            f"pretrain_videomae_internvideo2_{size}_patch14_224"
            for size in ("small", "base", "large", "huge")]:
        assert isinstance(create_model(name, device="meta"),
                          PretrainIV2VideoMAE)
    with pytest.raises(KeyError, match="ROADMAP.md"):
        create_model("pretrain_videomae_internvideo2_tiny_patch14_224",
                     device="cpu")
    for size in ("small", "base", "large"):
        assert isinstance(create_model(
            f"distill_internvideo2_{size}_patch14_224", device="meta"),
            DistillInternVideo2)
    assert create_model("vit_small_patch16_224", device="meta",
                        remat=True).cfg.remat
    with pytest.raises(ValueError, match="pos_embed_kind"):
        create_model("vit_small_patch16_224", device="cpu",
                     pos_embed_kind="2d")
