"""Port InternVideo2 (simple_tad_tpu_torch.models.internvideo2, its int8
model and calibration) against the JAX package's InternVideo2 and the
executed-reference golden, on a tiny IV2 (embed_dim 128, 2 heads, Dh 64,
depth 2, 4 frames of 28x28: N = 17 tokens with the CLS token), fp32.

The JAX side runs its int8 serving path as on a TPU: the int8-storage
separate-operand attention and, for ``fused_rmsq``, the RMSNorm->int8
kernel are forced (SIMPLE_TAD_FORCE_QKV_I8=1, SIMPLE_TAD_FUSED_RMSQ=force)
and the Pallas kernels run in interpret mode.  The JAX static model also
pads its 17 tokens to 24 at the model level and masks the pad keys; the
port runs the unpadded program (tests/test_quant.py shows the two agree).

Tolerances, each with its reason:
  * fp32 logits within 1e-4 (ROADMAP.md's slice gate; read: 2.1e-7 at
    max |logit| 0.27);
  * the golden at tests/test_golden_parity.py's 2e-4 atol, 1e-3 rtol
    (read: 2.1e-7);
  * weight codes and scales bit for bit (the same numpy math);
  * the port's static model on the JAX package's own quantized, calibrated
    tree within 1e-5 of the JAX static logits, unfused and fused (the same
    int8 codes and scales; only fp32 summation order differs; read:
    1.4e-7 at max |logit| 0.42, the same fused or not, since in fp32 the
    two programs round at the same places);
  * calibration absmax within 5e-4 relative (dynamic int8 codes that flip
    at a rounding boundary compound layer by layer; the JAX calib forward
    runs XLA's attention, not the max-free kernel);
  * the port's own pipeline against its fp32 model: tests/test_quant.py's
    IV2 drift bound, max(0.1 * max |logit|, 0.06).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.internvideo2 import IV2Config as JaxIV2Config
from simple_tad_tpu.models.internvideo2 import InternVideo2 as JaxIV2
from simple_tad_tpu.ops import quant as jax_quant
from simple_tad_tpu_torch.models import create_model
from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln, quant
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests import golden_utils as gu
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

TINY_IV2 = dict(img_size=28, patch_size=14, embed_dim=128, depth=2,
                num_heads=2, mlp_ratio=4.0, num_frames=4,
                attn_pool_num_heads=2, clip_embed_dim=32, init_scale=1.0,
                num_classes=2)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def jax_iv2(attn_impl="auto", **cfg):
    return JaxIV2(JaxIV2Config(**dict(TINY_IV2, **cfg), drop_path_rate=0.0,
                               attn_impl=attn_impl))


def perturbed_iv2_params(seed=0, **cfg):
    """JAX init with every matrix scaled by 3 (tests/test_quant.py's IV2
    setup, so the trunk moves the logits) and every leaf moved by seeded
    noise (norms, gammas, biases and the tables all exercised)."""
    x = jnp.zeros((1, 4, 28, 28, 3))
    params = jax_iv2(**cfg).init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        a = a * 3.0 if a.ndim >= 2 else a
        name = jax.tree_util.keystr(path)
        big = "scale" in name or "gamma" in name
        return a + (0.1 if big else 0.02) * rng.standard_normal(
            a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params)


def port_iv2_from(jax_params, **cfg):
    model = InternVideo2(IV2Config(**dict(TINY_IV2, **cfg)),
                         device="cpu").eval()
    model.load_state_dict(tc.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_params)), strict=True)
    return model


def _video(seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 4, 28, 28, 3)).astype(np.float32)


def jitted_apply(model, **kw):
    """``model.apply`` as one jitted program: the interpret-mode Pallas
    kernels then run inside one dispatch (eager op-by-op dispatch around
    their host callbacks can deadlock on a loaded CPU)."""
    return jax.jit(lambda p, x: model.apply({"params": p}, x, **kw))


def _launch_counts():
    return (ln.LAUNCHES, ln.QUANT_LAUNCHES, ln.RMSQ_LAUNCHES, fa.LAUNCHES,
            fa.SEP_LAUNCHES, fa.I8_LAUNCHES, fa.I8_SEP_LAUNCHES)


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
@pytest.mark.parametrize("sep_pos_embed", [False, True])
def test_iv2_matches_jax(sep_pos_embed, attn_impl):
    """Pixels and tokens in; the JAX side with XLA's attention ('auto' on
    the CPU) or its Pallas kernel in interpret mode."""
    params = perturbed_iv2_params(sep_pos_embed=sep_pos_embed)
    model = port_iv2_from(params, sep_pos_embed=sep_pos_embed)
    rng = np.random.default_rng(1)
    video = _video(1)
    tokens = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jm = jax_iv2(attn_impl, sep_pos_embed=sep_pos_embed)
    with pltpu.force_tpu_interpret_mode():
        want_px = jitted_apply(jm)(params, jnp.asarray(video))
        want_tok = jitted_apply(jm, tokens_input=True)(params,
                                                       jnp.asarray(tokens))
    with torch.inference_mode():
        got_px = model(torch.from_numpy(video))
        got_tok = model(torch.from_numpy(tokens), tokens_input=True)
    assert np.abs(np.asarray(want_px)).max() > 1e-2
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-4)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok),
                               atol=1e-4)


def test_iv2_init_matches_jax_tables():
    """The port's initialiser gives the JAX package's sincos position
    tables and unit norms (seeded draws differ by framework)."""
    for sep in (False, True):
        jp = jax_iv2(sep_pos_embed=sep).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 28, 28, 3)))["params"]
        model = create_model("internvideo2_small_patch14_224", device="cpu",
                             generator=torch.Generator().manual_seed(0),
                             **dict(TINY_IV2, sep_pos_embed=sep))
        sd = model.state_dict()
        want = tc.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
        for key in ("pos_embed", "pos_embed_spatial", "pos_embed_temporal",
                    "pos_embed_cls", "blocks.0.norm1.weight",
                    "blocks.1.ls2.gamma", "clip_projector.norm1_k.bias"):
            if key in want:
                np.testing.assert_array_equal(sd[key].numpy(),
                                              want[key].numpy(), key)
        assert sorted(sd) == sorted(want)


def test_golden_iv2_s():
    """IV2-S (12 layers, 4 frames of 224x224) loads the reference state
    dict by name and gives the executed reference's logits."""
    want, manifest, meta = gu.load_golden(os.path.join(GOLDENS, "iv2_s.npz"))
    sd = {k: torch.from_numpy(v)
          for k, v in gu.build_state_dict(manifest).items()}
    model = create_model("internvideo2_small_patch14_224", device="cpu",
                         num_classes=meta["num_classes"],
                         all_frames=meta["num_frames"])
    model.load_state_dict(sd, strict=True)
    x = gu.input_video(meta["input_seed"], meta["batch"], 4, 224)
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 2, 3, 4, 1).copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_quantize_iv2_params_matches_jax_bitwise():
    params = perturbed_iv2_params(seed=3)
    got = quant.quantize_iv2_params(tc.from_jax_params(params))
    want = tc.from_jax_params(jax_quant.quantize_iv2_params(params))
    assert sorted(got) == sorted(want)
    n_q = 0
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy().view(np.uint8),
                                      want[key].numpy().view(np.uint8), key)
        n_q += key.endswith(".weight_q")
    assert n_q == 4 * TINY_IV2["depth"]
    bf16 = {k: v.bfloat16() for k, v in tc.from_jax_params(params).items()}
    with pytest.raises(TypeError, match="fp32 masters"):
        quant.quantize_iv2_params(bf16)


@pytest.fixture
def jax_int8_gates(monkeypatch):
    monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")
    return monkeypatch


@pytest.mark.parametrize("fused_rmsq", [False, True])
def test_static_iv2_on_jax_tree_matches_jax(fused_rmsq, jax_int8_gates):
    """The JAX package quantizes and calibrates; from_jax_params carries its
    int8 tree into the port, whose static model gives the JAX static
    model's logits.  On the CPU no kernel launch is counted."""
    if fused_rmsq:
        jax_int8_gates.setenv("SIMPLE_TAD_FUSED_RMSQ", "force")
    params = perturbed_iv2_params(seed=4)
    x = _video(2)
    with pltpu.force_tpu_interpret_mode():
        jm, qp = jax_quant.quantize_and_calibrate(jax_iv2(), params,
                                                  [jnp.asarray(x)])
        want = np.asarray(jitted_apply(jm)(qp, jnp.asarray(x)))
    sd = tc.from_jax_params(jax.tree_util.tree_map(np.asarray, qp))
    assert sd["blocks.0.attn.qkv_amax"].shape == (3, 2)
    assert ("blocks.1.norm2.act_amax" in sd) == fused_rmsq
    model = quant.quant_model(IV2Config(**TINY_IV2, fused_rmsq=fused_rmsq),
                              sd, "static", "cpu")
    before = _launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _launch_counts() == before
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_calibration_matches_jax(jax_int8_gates):
    """Every absmax site the JAX calib forward sows with the fused RMSNorm
    option (the norm scopes included), recorded by the port's calib forward
    on the same fp32 params and inputs (two batches)."""
    jax_int8_gates.setenv("SIMPLE_TAD_FUSED_RMSQ", "force")
    params = perturbed_iv2_params(seed=5)
    batches = [_video(3), _video(4) * 1.5]
    qp = jax_quant.quantize_iv2_params(params)
    calib = JaxIV2(dataclasses.replace(jax_iv2().cfg, quant=True,
                                       quant_mode="calib"))
    jamax = jax_quant.calibrate_act_amax(calib, qp, [jnp.asarray(b)
                                                     for b in batches])
    want = {k: v for k, v in tc.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_quant.apply_act_amax(qp, jamax))).items()
        if k.endswith("amax")}
    qstate = quant.quantize_iv2_params(tc.from_jax_params(params))
    model = quant.quant_model(IV2Config(**TINY_IV2, fused_rmsq=True),
                              qstate, "calib", "cpu")
    got = quant.calibrate_act_amax(model, [torch.from_numpy(b)
                                           for b in batches])
    assert sorted(got) == sorted(want)
    assert len(got) == 8 * TINY_IV2["depth"]
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=5e-4, err_msg=key)


@pytest.mark.parametrize("fused_rmsq", [False, True])
def test_quantize_and_calibrate_tracks_fp32_model(fused_rmsq):
    params = perturbed_iv2_params(seed=6)
    fp = port_iv2_from(params)
    x = torch.from_numpy(_video(7))
    cfg = dataclasses.replace(fp.cfg, fused_rmsq=fused_rmsq)
    static = quant.quantize_and_calibrate(cfg, fp.state_dict(), [x],
                                          device="cpu")
    assert isinstance(static, InternVideo2) and static.cfg.quant_mode \
        == "static"
    with torch.inference_mode():
        want = fp(x).numpy()
        got = static(x).numpy()
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert np.abs(got - want).max() < max(0.1 * scale, 0.06), \
        (np.abs(got - want).max(), scale)
    with pytest.raises(ValueError, match="fused_rmsq"):
        InternVideo2(IV2Config(**TINY_IV2, fused_rmsq=True), device="cpu")
