"""Port the static int8 serving options (``fused_w8a8``, ``fused_mlp``,
``qkv_i8=False``: the fused int8 GEMM kernels B4 and the int8-output
attention B3; the ViT's ``add_lnq`` and ``int8_attn``: the deferred-residual
carry through E1 and the int8-compute attention E2) against the JAX
package's programs that they reproduce, on the tiny fp32 ViT
(tests/test_torch_quant_vit.py) and IV2 (tests/test_torch_iv2.py).

The JAX side runs each program as on a TPU, its Pallas kernels in
interpret mode: SIMPLE_TAD_FUSED_LNQ=force and SIMPLE_TAD_FORCE_QKV_I8=1
(the default int8 program), plus SIMPLE_TAD_FUSED_W8A8=force for
``fused_w8a8``, or SIMPLE_TAD_QKV_I8=0 with SIMPLE_TAD_FORCE_PACKED_ATTN=1
for ``qkv_i8=False`` (the ViT then runs _flash_primal_packed_qkv_q8_impl),
SIMPLE_TAD_ADD_LNQ=1 for ``add_lnq`` (its scanned blocks then take the
carry through _add_ln_quant_kernel) and SIMPLE_TAD_INT8_ATTN=1 with
SIMPLE_TAD_FORCE_INT8_ATTN=1 for ``int8_attn`` (_fwd_kernel_int8_packed).
``fused_mlp`` is held to the JAX *unfused* static model: the JAX fused MLP
applies the tanh GELU at fp32, the unfused model the erf one (ROADMAP F4),
and the port's fused MLP computes the unfused model's function.  The JAX
InternVideo2 reaches its B3 only on a TPU (off it, its separate-operand
attention is XLA's), so its ``qkv_i8=False`` model is held to that XLA
program, and the B3 kernels themselves to the port's plain versions below
(single-pass and key-grid forms).

Tolerances, each with its reason:
  * logits of the port's static model on the JAX package's own quantized,
    calibrated tree: 1e-5, as tests/test_torch_quant_vit.py (the same
    int8 codes and scales; on the CPU the port's kernels are their plain
    versions, the unfused model's operations bit for bit);
  * the B3 plain versions against the Pallas kernels: codes at most 1
    apart, at most 1% of codes apart, and a control (probabilities not
    rounded to bf16) beyond that share, as tests/test_torch_iv2_ops.py;
  * FrameEvaluator and the CLIs: with the fused GEMMs, and with
    ``add_lnq``, the same predictions bit for bit (plain versions on the
    CPU); with ``qkv_i8=False`` (bf16 attention instead of int8-stored q, k,
    v) and with ``int8_attn`` (probabilities in 1/127 steps) within ROADMAP
    F2's int8 bound, 2e-3 in risk.
"""

import csv
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.ops import flash_attention as jax_fa
from simple_tad_tpu.ops import quant as jax_quant
from simple_tad_tpu_torch.data.frame_datasets import (FrameDataset,
                                                      read_dota_clips)
from simple_tad_tpu_torch.eval.engine import FrameEvaluator
from simple_tad_tpu_torch.models import create_model
from simple_tad_tpu_torch.models.internvideo2 import IV2Config, InternVideo2
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import int8_gemm, ln, quant
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.fixtures import make_synthetic_dota
from tests.test_torch_iv2 import (TINY_IV2, jax_iv2, jitted_apply,
                                  perturbed_iv2_params)
from tests.test_torch_iv2 import _video as _iv2_video
from tests.test_torch_quant_vit import TINY4, _video
from tests.test_torch_vit import (TINY, drop_checkpoints,  # noqa: F401
                                  one_torch_thread,
                                  perturbed_jax_params, port_model_from)

CODE_SHARE = 0.01
ADD_LNQ = {"SIMPLE_TAD_ADD_LNQ": "1"}
INT8_ATTN = {"SIMPLE_TAD_INT8_ATTN": "1", "SIMPLE_TAD_FORCE_INT8_ATTN": "1"}
VARIANTS = dict(add_lnq=True, int8_attn=True)
JAX_PROGRAMS = {
    # port options -> (the JAX environment of the program they reproduce,
    # the options, the tree's geometry beyond TINY4)
    "fused_w8a8": ({"SIMPLE_TAD_FUSED_W8A8": "force"},
                   dict(fused_w8a8=True), {}),
    "fused_mlp": ({}, dict(fused_mlp=True), {}),
    "fused_both": ({"SIMPLE_TAD_FUSED_W8A8": "force"},
                   dict(fused_w8a8=True, fused_mlp=True), {}),
    "no_qkv_i8": ({"SIMPLE_TAD_QKV_I8": "0",
                   "SIMPLE_TAD_FORCE_PACKED_ATTN": "1"},
                  dict(qkv_i8=False), {}),
    "add_lnq": (ADD_LNQ, dict(add_lnq=True), {}),
    "int8_attn": (INT8_ATTN, dict(int8_attn=True), {}),
    "add_lnq_int8_attn": ({**ADD_LNQ, **INT8_ATTN}, VARIANTS, {}),
    "add_lnq_int8_attn_fused": (
        {**ADD_LNQ, **INT8_ATTN, "SIMPLE_TAD_FUSED_W8A8": "force"},
        dict(VARIANTS, fused_w8a8=True, fused_mlp=True), {}),
    # N = 4 * 5 = 20 tokens, no multiple of 8: the JAX kernels pad to 24
    # and mask, the port's kernels mask by index
    "add_lnq_int8_attn_n20": ({**ADD_LNQ, **INT8_ATTN}, VARIANTS,
                              dict(all_frames=10)),
}
# the logit bound of a case where one LayerNorm->int8 code flips (the
# Pallas LN kernel sums the row in another fp32 order): ROADMAP F2's int8
# bound.  At N = 20 block 1's norm2 emits one code 1 apart from the JAX
# one on inputs equal to the JAX ones (every earlier GEMM output and every
# E2 output equal bit for bit): logits 4.21e-5 apart
LOGIT_ATOL = {"add_lnq_int8_attn_n20": 2e-3}


def _counts():
    return (ln.QUANT_LAUNCHES, ln.ADD_QUANT_LAUNCHES, ln.RMSQ_LAUNCHES,
            fa.I8_LAUNCHES, fa.INT8_LAUNCHES,
            fa.I8_SEP_LAUNCHES, fa.Q8_LAUNCHES, fa.Q8_SEP_LAUNCHES,
            fa.SEP_LAUNCHES, int8_gemm.GEMM_LAUNCHES,
            int8_gemm.MLP_LAUNCHES)


def _port_tree(qp):
    return tc.from_jax_params(jax.tree_util.tree_map(np.asarray, qp))


@pytest.mark.parametrize("program", sorted(JAX_PROGRAMS))
def test_static_vit_options_on_jax_tree_match_jax(program, monkeypatch):
    env, options, geometry = JAX_PROGRAMS[program]
    cfg = dict(TINY4, **geometry)
    jcfg = JaxViTConfig(**cfg)
    params = perturbed_jax_params(jcfg, seed=0)
    x = _video(1, frames=cfg["all_frames"])
    monkeypatch.setenv("SIMPLE_TAD_FUSED_LNQ", "force")
    monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    with pltpu.force_tpu_interpret_mode():
        jm, qp = jax_quant.quantize_and_calibrate(JaxViT(jcfg), params,
                                                  [jnp.asarray(x)])
        want = np.asarray(jitted_apply(jm)(qp, jnp.asarray(x)))
    sd = _port_tree(qp)
    if not options.get("qkv_i8", True):
        # a static tree of this JAX program has no qkv_amax (only the
        # int8-storage branch makes it); the model must not need it
        sd = {k: v for k, v in sd.items() if not k.endswith("qkv_amax")}
    model = quant.quant_model(ViTConfig(**cfg, **options), sd, "static",
                              "cpu")
    assert model._carry() == options.get("add_lnq", False)
    assert isinstance(model.blocks[0].mlp.fused_mlp, bool)
    assert model.blocks[0].mlp.fused_mlp == options.get("fused_mlp", False)
    before = _counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _counts() == before
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want,
                               atol=LOGIT_ATOL.get(program, 1e-5), rtol=0)


@pytest.mark.parametrize("program", ["fused", "fused_rmsq", "no_qkv_i8"])
def test_static_iv2_options_on_jax_tree_match_jax(program, monkeypatch):
    """InternVideo2 with both fused GEMM options against the JAX unfused
    static model (with the fused RMSNorm->int8, whose int8 output then
    feeds the MLP kernel), and with qkv_i8=False against the JAX program
    with SIMPLE_TAD_QKV_I8=0 (on the CPU: XLA attention, proj quantizing
    its input; the port: B3 on separate operands)."""
    options = dict(fused_w8a8=True, fused_mlp=True)
    if program == "no_qkv_i8":
        monkeypatch.setenv("SIMPLE_TAD_QKV_I8", "0")
        options["qkv_i8"] = False
    else:
        monkeypatch.setenv("SIMPLE_TAD_FORCE_QKV_I8", "1")
    if program == "fused_rmsq":
        monkeypatch.setenv("SIMPLE_TAD_FUSED_RMSQ", "force")
        options["fused_rmsq"] = True
    params = perturbed_iv2_params(seed=4)
    x = _iv2_video(2)
    with pltpu.force_tpu_interpret_mode():
        jm, qp = jax_quant.quantize_and_calibrate(jax_iv2(), params,
                                                  [jnp.asarray(x)])
        want = np.asarray(jitted_apply(jm)(qp, jnp.asarray(x)))
    model = quant.quant_model(IV2Config(**TINY_IV2, **options),
                              _port_tree(qp), "static", "cpu")
    assert model.blocks[0].mlp.fused_mlp
    assert hasattr(model.blocks[0].attn, "qkv_amax") == (
        program != "no_qkv_i8")
    before = _counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert _counts() == before
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _code_diff(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d > 0).mean())


def _q8_control(q, k, v, heads, scale, out_amax):
    """The plain B3 with probabilities not rounded to bf16."""
    qh, kh, vh = (fa._heads(t, heads).float() for t in (q, k, v))
    qs = (qh * (scale * fa.LOG2E)).to(q.dtype).float()
    s = qs @ kh.transpose(-1, -2)
    p = torch.exp2(s - torch.ceil(s.amax(-1, keepdim=True)))
    o = (p @ vh) / p.sum(-1, keepdim=True)
    return ln.quantize_static(fa._merge_heads(o), out_amax)


def _sep_qkv(n, d, heads, dtype, seed):
    rng = np.random.default_rng(seed)
    C = heads * d
    qkv = torch.from_numpy(rng.standard_normal(
        (2, n, 3 * C)).astype(np.float32)).to(dtype)
    return qkv, C


@pytest.fixture(params=["single_pass", "2", "3"])
def kv_grid(request, monkeypatch):
    """The JAX launcher's plan for separate operands: single-pass, or a
    forced key grid of 2 or 3 steps (_kv_grid_call with the int8
    epilogue, the kernel InternVideo2's N = 2049 takes)."""
    if request.param != "single_pass":
        monkeypatch.setenv("SIMPLE_TAD_ATTN_KV_GRID", request.param)
    return request.param


def _check_codes(got, want, control, dtype):
    worst, share = _code_diff(got.numpy(), want)
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    if dtype == torch.bfloat16:          # in fp32 the rounding is exact
        assert _code_diff(control.numpy(), want)[1] > CODE_SHARE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_attention_q8_plain_matches_pallas_kernel(dtype):
    """B3 on the packed qkv against _flash_primal_packed_qkv_q8_impl
    (_fwd_kernel_nomax_packed_q8) on the same values."""
    d, heads, n = 64, 2, 130
    qkv, C = _sep_qkv(n, d, heads, dtype, 0)
    scale = d ** -0.5
    out_amax = torch.tensor(float(fa.flash_attention_qkv_plain(
        qkv.float(), heads, scale).abs().max()) * 0.9)
    fn = jax.jit(functools.partial(
        jax_fa._flash_primal_packed_qkv_q8_impl, num_heads=heads,
        scale=scale, block_q=0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(qkv.float().numpy()).astype(jdt),
                             out_amax=jnp.asarray(out_amax.numpy())))
    got = fa.flash_attention_qkv_q8(qkv, heads, scale, out_amax)
    assert got.dtype == torch.int8 and got.shape == (2, n, C)
    _check_codes(got, want, _q8_control(*fa._qkv_views(qkv, C), heads,
                                        scale, out_amax), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_attention_q8_sep_plain_matches_pallas_kernel(dtype, kv_grid):
    """B3 on separate operands (v the strided column block) against
    _flash_primal_packed_q8_impl: _fwd_kernel_nomax_packed_q8, or with the
    key grid _fwd_kernel_nomax_packed_kv_q8."""
    d, heads, n = 64, 2, 130
    qkv, C = _sep_qkv(n, d, heads, dtype, 1)
    q, k = qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous()
    v = qkv[..., 2 * C:]
    scale = d ** -0.5
    out_amax = torch.tensor(float(fa.flash_attention_plain(
        q.float(), k.float(), v.float(), heads, scale).abs().max()))
    fn = jax.jit(functools.partial(
        jax_fa._flash_primal_packed_q8_impl, num_heads=heads, scale=scale,
        block_q=0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(*(jnp.asarray(t.float().numpy()).astype(jdt)
                               for t in (q, k, v)),
                             out_amax=jnp.asarray(out_amax.numpy())))
    got = fa.flash_attention_q8(q, k, v, heads, scale, out_amax)
    assert got.dtype == torch.int8 and got.shape == (2, n, C)
    _check_codes(got, want, _q8_control(q, k, v, heads, scale, out_amax),
                 dtype)
    # keys at or beyond n_valid are left out
    part = fa.flash_attention_q8(q, k, v, heads, scale, out_amax, 100)
    assert torch.equal(part, fa.flash_attention_q8_plain(
        q, k[:, :100], v[:, :100], heads, scale, out_amax))


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota_fused")
    return make_synthetic_dota(str(root), n_clips=3, frames_per_clip=40,
                               h=72, w=128)


def _risks(rows):
    logits = np.stack([rows["logits_safe"], rows["logits_risk"]], 1)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return e[:, 1] / e.sum(1)


@pytest.fixture(scope="module")
def evaluated(dota_root):
    """FrameEvaluator (static int8) with the default program, with the
    fused GEMMs, with qkv_i8=False, with add_lnq and with add_lnq and
    int8_attn, on the same tiny ViT."""
    params = perturbed_jax_params(JaxViTConfig(**TINY), seed=7)
    ds = FrameDataset(read_dota_clips(dota_root, "val_split.txt"),
                      mode="test", view_len=16, target_fps=10, orig_fps=10,
                      view_step=1, crop_size=32)
    out = {}
    for name, options in (("default", {}),
                          ("fused", dict(fused_w8a8=True, fused_mlp=True)),
                          ("no_qkv_i8", dict(qkv_i8=False)),
                          ("add_lnq", dict(add_lnq=True)),
                          ("variants", dict(add_lnq=True, int8_attn=True))):
        ev = FrameEvaluator(port_model_from(params, **TINY), device="cpu",
                            batch_size=8, resize_on_host=True, quant8=True,
                            **options)
        out[name] = (ev, ev.evaluate(ds))
    return out


def test_evaluator_options_serve_the_same_predictions(evaluated):
    _, base = evaluated["default"]
    ev, fused = evaluated["fused"]
    assert ev.model.cfg.fused_w8a8 and ev.model.cfg.fused_mlp
    assert ev.model.blocks[0].mlp.fused_mlp
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_array_equal(fused.rows[col], base.rows[col])
    ev, no_i8 = evaluated["no_qkv_i8"]
    assert not ev.model.cfg.qkv_i8
    assert not hasattr(ev.model.blocks[0].attn, "qkv_amax")
    assert no_i8.n_windows == base.n_windows == 75
    np.testing.assert_allclose(_risks(no_i8.rows), _risks(base.rows),
                               atol=2e-3)
    ev, carried = evaluated["add_lnq"]
    assert ev.model.cfg.add_lnq and ev.model._carry()
    for col in ("logits_safe", "logits_risk"):
        np.testing.assert_array_equal(carried.rows[col], base.rows[col])
    ev, variants = evaluated["variants"]
    assert ev.model.cfg.int8_attn and ev.model._carry()
    assert ev.model.blocks[0].attn.qkv_amax.shape == (3, 2)
    assert variants.n_windows == 75
    np.testing.assert_allclose(_risks(variants.rows), _risks(base.rows),
                               atol=2e-3)


def _csv_risks(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    logits = np.array([[float(r["logits_safe"]), float(r["logits_risk"])]
                       for r in rows])
    return _risks({"logits_safe": logits[:, 0], "logits_risk": logits[:, 1]})


def test_eval_cli_options(dota_root, tmp_path):
    from simple_tad_tpu_torch.cli.eval_frames import main
    args = ["--data_set", "DoTA", "--data_path", dota_root,
            "--model", "vit_small_patch16_224", "--input_size", "32",
            "--num_frames", "16", "--batch_size", "8", "--device", "cpu",
            "--quant8"]
    risks = {}
    for name, flags in (("default", []),
                        ("fused", ["--fused_w8a8", "--fused_mlp"]),
                        ("no_qkv_i8", ["--no_qkv_i8"]),
                        ("variants", ["--add_lnq", "--int8_attn"])):
        out = tmp_path / name
        res = main(args + flags + ["--output_dir", str(out)])
        assert res.n_windows == 75
        risks[name] = _csv_risks(out / "predictions.csv")
    np.testing.assert_array_equal(risks["fused"], risks["default"])
    np.testing.assert_allclose(risks["no_qkv_i8"], risks["default"],
                               atol=2e-3)
    np.testing.assert_allclose(risks["variants"], risks["default"],
                               atol=2e-3)


def test_inference_cli_options(dota_root, tmp_path):
    """Streaming and batched, with the fused GEMMs, with --no_qkv_i8 and
    with --add_lnq --int8_attn."""
    import os
    import zipfile
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
    base = [r for _, r in main(args)]
    for flags in (["--fused_w8a8", "--fused_mlp"], ["--no_qkv_i8"],
                  ["--add_lnq", "--int8_attn"]):
        stream = [r for _, r in main(args + flags)]
        batched = [r for _, r in main(args + flags + ["--batched"])]
        assert len(stream) == 24 and len(batched) == 25
        if flags[0] == "--fused_w8a8":
            assert stream == base
        np.testing.assert_allclose(stream, base, atol=2e-3)
        np.testing.assert_allclose(stream, batched[1:], atol=2e-3)
    with pytest.raises(ValueError, match="options of --quant8"):
        main(args[:-1] + ["--fused_mlp"])
    with pytest.raises(ValueError, match="options of --quant8 with a ViT"):
        main(args[:-1] + ["--int8_attn"])


def test_options_raise_outside_static_int8():
    """Each option belongs to the static int8 model (and its calibration
    twin): on a bf16/fp32 or dynamic int8 model, or a FrameEvaluator that
    serves none, it raises."""
    for options in (dict(fused_w8a8=True), dict(fused_mlp=True),
                    dict(qkv_i8=False), dict(add_lnq=True),
                    dict(int8_attn=True)):
        with pytest.raises(ValueError, match="static int8"):
            VisionTransformer(ViTConfig(**TINY4, **options), device="cpu")
        with pytest.raises(ValueError, match="static int8"):
            VisionTransformer(ViTConfig(**TINY4, quant=True,
                                        quant_mode="dynamic", **options),
                              device="cpu")
        if "add_lnq" in options or "int8_attn" in options:
            # InternVideo2 has neither option (its JAX model neither)
            iv2 = create_model("internvideo2_small_patch14_224",
                               device="cpu",
                               generator=torch.Generator().manual_seed(0),
                               **TINY_IV2)
            with pytest.raises(ValueError, match="static int8 ViT"):
                FrameEvaluator(iv2, device="cpu", quant8=True, **options)
        else:
            with pytest.raises(ValueError, match="static int8"):
                InternVideo2(IV2Config(**TINY_IV2, **options), device="cpu")
        model = create_model("vit_small_patch16_224", device="cpu",
                             generator=torch.Generator().manual_seed(0),
                             **TINY4)
        with pytest.raises(ValueError, match="static int8"):
            FrameEvaluator(model, device="cpu", **options)
        with pytest.raises(ValueError, match="static int8"):
            FrameEvaluator(model, device="cpu", quant8=True,
                           quant8_mode="dynamic", **options)
    # the calibration twin of a configured static model builds
    cfg = dataclasses.replace(ViTConfig(**TINY4), quant=True,
                              quant_mode="calib", fused_w8a8=True,
                              fused_mlp=True, qkv_i8=False, add_lnq=True,
                              int8_attn=True)
    VisionTransformer(cfg, device="cpu")
