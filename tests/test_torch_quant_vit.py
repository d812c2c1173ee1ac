"""Port int8 ViT serving (quant modules, calibration, FrameEvaluator and
the CLIs with --quant8) against the JAX package, at fp32 compute on a tiny
ViT (embed_dim 128, 2 heads, Dh 64, depth 2, 32x32 frames).

The JAX side runs its int8 serving path as on a TPU: the LayerNorm->int8
and int8-storage attention gates are forced (SIMPLE_TAD_FUSED_LNQ=force,
SIMPLE_TAD_FORCE_QKV_I8=1) and the Pallas kernels run in interpret mode.

Tolerances, each with its reason:
  * the port's static model on the JAX package's own quantized, calibrated
    tree: logits within 1e-5 (the same int8 codes and scales; only fp32
    summation order differs, and one int8 code flipped anywhere would move
    the logits by ~1e-3).  At head dim 80 (embed 640, 8 heads; the TPU
    program's bf16 attention route) within 2e-3, ROADMAP F2's int8 bound:
    read 3.1e-4 at max |logit| 0.68, one LayerNorm->int8 code of the
    second block flipping (the Pallas LN kernel sums a 640-wide row in
    another fp32 order; with the JAX LN codes and attention fed in, the
    port reads 4.2e-7).  Before the routes were the TPU program's, the
    port ran int8-storage attention there: 1.06e-2;
  * calibration absmax: within 5e-4 relative (read: 5.5e-5; a dynamic
    int8 code that flips at a rounding boundary moves a GEMM output by one
    quantum, and the flips compound layer by layer; the JAX calib forward
    also runs XLA's attention, not the max-free kernel);
  * the port's own quantize_and_calibrate against the fp32 model:
    tests/test_quant.py's drift bound (max(0.08 * max |logit|, 0.05),
    argmax agreement >= 0.75);
  * FrameEvaluator against the JAX evaluator: logits within 1e-3 (read:
    2.5e-4 static, 1.5e-4 dynamic, at max |logit| 0.51; the calibration
    differences above carried to the logits), AUROC/AP within 1e-4.
"""

import csv
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.data.frame_datasets import FrameDataset as JaxFrameDataset
from simple_tad_tpu.data.frame_datasets import read_dota_clips as jax_read
from simple_tad_tpu.eval.engine import FrameEvaluator as JaxFrameEvaluator
from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.ops import quant as jax_quant
from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dota_clips)
from simple_tad_tpu_torch.eval.engine import FrameEvaluator
from simple_tad_tpu_torch.models import create_model
from simple_tad_tpu_torch.models.vit import ViTConfig
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln, quant
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.fixtures import make_synthetic_dota
from tests.test_torch_vit import (TINY, drop_checkpoints,  # noqa: F401
                                   one_torch_thread,
                                   perturbed_jax_params, port_model_from)

TINY4 = dict(TINY, all_frames=4)           # N = 2 * 2 * 2 = 8 tokens


@pytest.fixture
def jax_int8_gates(monkeypatch):
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LNQ", "force")
    monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")


def _video(seed, batch=4, frames=4):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, 32, 32, 3)).astype(np.float32)


def _launch_counts():
    return ln.LAUNCHES, ln.QUANT_LAUNCHES, fa.LAUNCHES, fa.I8_LAUNCHES


def _jax_tree_to_port(tree):
    return tc.from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("init_values,geometry,atol", [
    pytest.param(0.0, {}, 1e-5, id="0.0"),
    pytest.param(0.1, {}, 1e-5, id="0.1"),
    # Dh 80: no int8-storage attention in the TPU program (128 % 80), no
    # packed one (80 % 64): bf16 attention, proj quantizing its input.  At
    # C = 640 one LayerNorm->int8 code flips (the Pallas LN kernel sums the
    # row in another fp32 order): the int8 bound of ROADMAP F2
    pytest.param(0.0, dict(embed_dim=640, num_heads=8), 2e-3, id="dh80"),
    # N = 4352 > 4096: beyond the kernels' single-pass cap, the same route
    pytest.param(0.0, dict(patch_size=2, all_frames=34, depth=1), 1e-5,
                 id="n4352")])
def test_static_vit_on_jax_tree_matches_jax(init_values, geometry, atol,
                                            jax_int8_gates):
    """The JAX package quantizes and calibrates; from_jax_params carries its
    int8 tree into the port, whose static model then gives the JAX static
    model's logits, at every geometry (the attention route is the TPU
    program's: ops/attention.py:static_attention_route).  On the CPU no
    kernel launch is counted."""
    cfg = dict(TINY4, init_values=init_values, **geometry)
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=0)
    x = _video(1, batch=1 if geometry.get("all_frames") else 4,
               frames=cfg["all_frames"])
    jm, qp = jax_quant.quantize_and_calibrate(JaxViT(jcfg), params,
                                              [jnp.asarray(x)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply({"params": qp}, jnp.asarray(x)))
    sd = _jax_tree_to_port(qp)
    assert sd["blocks.0.norm2.act_amax"].shape == ()
    assert sd["blocks.0.attn.qkv_amax"].shape == (3, cfg["num_heads"])
    model = quant.quant_model(ViTConfig(**cfg), sd, "static", "cpu")
    before = _launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _launch_counts() == before
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_calibration_matches_jax(jax_int8_gates):
    """Every absmax site the JAX calib forward sows, recorded by the port's
    calib forward on the same fp32 params and inputs (two batches)."""
    jcfg = JaxViTConfig(**TINY4)
    params = perturbed_jax_params(jcfg, seed=2)
    batches = [_video(3), _video(4) * 1.5]
    qp = jax_quant.quantize_vit_params(params)
    calib = JaxViT(JaxViTConfig(**dict(TINY4, quant=True,
                                       quant_mode="calib")))
    jamax = jax_quant.calibrate_act_amax(calib, qp, [jnp.asarray(b)
                                                     for b in batches])
    want = {k: v for k, v in _jax_tree_to_port(
        jax_quant.apply_act_amax(qp, jamax)).items() if k.endswith("amax")}
    qstate = quant.quantize_vit_params(tc.from_jax_params(params))
    model = quant.quant_model(ViTConfig(**TINY4), qstate, "calib", "cpu")
    got = quant.calibrate_act_amax(model,
                                   [torch.from_numpy(b) for b in batches])
    assert sorted(got) == sorted(want)
    assert len(got) == 8 * TINY4["depth"]
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=5e-4, err_msg=key)
    # a quantile reduce picks between the per-batch values
    med = quant.calibrate_act_amax(model, [torch.from_numpy(b)
                                           for b in batches], reduce=0.5)
    assert all((med[k] <= got[k]).all() for k in got)
    with pytest.raises(ValueError, match="quantile"):
        quant.calibrate_act_amax(model, [], reduce=1.5)


def test_quantize_and_calibrate_tracks_fp32_model():
    """tests/test_quant.py's drift bound, on the port's own pipeline; the
    static model serves with the calibrated scales and no JAX at all."""
    params = perturbed_jax_params(JaxViTConfig(**TINY4), seed=5)
    fp = port_model_from(params, **TINY4)
    x = torch.from_numpy(_video(6))
    static = quant.quantize_and_calibrate(fp.cfg, fp.state_dict(), [x],
                                          device="cpu")
    assert static.cfg.quant and static.cfg.quant_mode == "static"
    with torch.inference_mode():
        want = fp(x).numpy()
        got = static(x).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < max(0.08 * scale, 0.05), \
        (np.abs(got - want).max(), scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75
    with pytest.raises(ValueError, match="not initialised"):
        create_model("vit_small_patch16_224", device="cpu",
                     generator=torch.Generator().manual_seed(0), quant=True,
                     **TINY4)


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota_q8")
    return make_synthetic_dota(str(root), n_clips=3, frames_per_clip=40,
                               h=72, w=128)


def _dataset(cls, read, root):
    return cls(read(root, "val_split.txt"), mode="test", view_len=16,
               target_fps=10, orig_fps=10, view_step=1, crop_size=32)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_evaluator_quant8_matches_jax(mode, dota_root, jax_int8_gates):
    params = perturbed_jax_params(JaxViTConfig(**TINY), seed=7)
    with pltpu.force_tpu_interpret_mode():
        jres = JaxFrameEvaluator(
            JaxViT(JaxViTConfig(**TINY)), params, batch_size=8,
            frame_bucket=64, dtype=jnp.float32, resize_on_host=True,
            quant8=True, quant8_mode=mode).evaluate(
                _dataset(JaxFrameDataset, jax_read, dota_root))
    ev = FrameEvaluator(port_model_from(params, **TINY), device="cpu",
                        batch_size=8, resize_on_host=True, quant8=True,
                        quant8_mode=mode)
    res = ev.evaluate(_dataset(FrameDataset, read_dota_clips, dota_root))
    assert ev.model.cfg.quant_mode == mode
    assert res.n_windows == jres.n_windows == 75
    for col in ("clip", "filename", "label"):
        assert res.rows[col] == jres.rows[col].tolist(), col
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_allclose(res.rows[col], jres.rows[col].to_numpy(),
                                   atol=1e-3)
    for key in ("auroc", "ap"):
        assert abs(getattr(res.metrics, key)
                   - getattr(jres.metrics, key)) <= 1e-4, key


def test_evaluator_quant8_needs_fp32_masters():
    model = create_model("vit_small_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, **TINY4)
    with pytest.raises(TypeError, match="fp32 masters"):
        FrameEvaluator(model, device="cpu", quant8=True)
    masters = create_model("vit_small_patch16_224", device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           **TINY4).state_dict()
    ev = FrameEvaluator(model, device="cpu", quant8=True,
                        quant8_mode="dynamic", fp32_state=masters)
    assert ev.model.blocks[0].attn.qkv.weight_q.dtype == torch.int8
    with pytest.raises(ValueError, match="quant8_mode"):
        FrameEvaluator(model, device="cpu", quant8=True, quant8_mode="fp8",
                       fp32_state=masters)


def test_eval_cli_quant8(dota_root, tmp_path):
    from simple_tad_tpu_torch.cli.eval_frames import main
    args = ["--data_set", "DoTA", "--data_path", dota_root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--num_frames", "16", "--batch_size", "8", "--device", "cpu"]
    for mode in ("static", "dynamic"):
        out = tmp_path / mode
        res = main(args + ["--quant8", "--quant8_mode", mode,
                           "--output_dir", str(out)])
        with open(out / "predictions.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert len(rows) == 76 and res.n_windows == 75
        logits = np.array([[float(r[2]), float(r[3])] for r in rows[1:]])
        assert np.isfinite(logits).all()
        with open(out / "params.json") as f:
            assert '"quant8": true' in f.read()


def test_inference_cli_quant8_stream_and_batched(dota_root, tmp_path):
    """--quant8 quantizes, calibrates on the first window and serves the
    static model; streaming and batched scoring agree window by window,
    within 2e-3: fp32 sums run in another order at batch 1 than at batch
    25, which can move an int8 code at a rounding boundary."""
    from simple_tad_tpu_torch.cli.inference import main
    frames_dir = tmp_path / "frames"
    with zipfile.ZipFile(os.path.join(dota_root, "frames", "clip_001",
                                      "images.zip")) as z:
        z.extractall(frames_dir)
    model = create_model("vit_small_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(3),
                         img_size=32, init_scale=1.0)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"model": model.state_dict()}, ckpt)
    args = ["--ckpt", ckpt, "--frames_folder", str(frames_dir),
            "--input_size", "32", "--dtype", "float32", "--device", "cpu",
            "--quant8"]
    stream = main(args)
    batched = main(args + ["--batched"])
    assert len(stream) == 24 and len(batched) == 25
    assert [p for p, _ in stream] == [p for p, _ in batched[1:]]
    risks = [r for _, r in stream]
    assert all(0.0 <= r <= 1.0 for r in risks)
    np.testing.assert_allclose(risks, [r for _, r in batched[1:]], atol=2e-3)
