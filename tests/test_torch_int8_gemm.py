"""Port the fused static int8 GEMMs (simple_tad_tpu_torch.ops.int8_gemm,
kernel B4: w8a8_gemm and w8a8_mlp) against the JAX package's
(ops/int8_gemm.py, the Pallas kernels _gemm_kernel and _mlp_kernel in
interpret mode) and its unfused int8 math (ops/quant.py).

Tolerances, each with its reason:
  * against the Pallas kernels: tests/test_int8_gemm.py's, fp32 rtol 1e-5,
    atol 1e-4 (the int32 products are exact; the fp32 epilogues may
    associate differently), and the activation codes equal bit for bit;
  * the int8-input and erf forms against the JAX unfused chain
    (int8_matmul_static + bias + gelu_for): fp32 within 1e-6 relative of
    max |y| (one fp32 rounding of the rescale product); the MLP's hidden
    codes are the chain's, so its output is within the same bound;
  * against the port's own unfused static model the plain versions are
    equal bit for bit (the same torch operations in the same order).
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.models.layers import gelu_for as jax_gelu_for
from simple_tad_tpu.ops import int8_gemm as jax_gemm
from simple_tad_tpu.ops.quant import int8_matmul_static, quantize_weight
from simple_tad_tpu_torch import models
from simple_tad_tpu_torch.models.layers import Mlp
from simple_tad_tpu_torch.ops import int8_gemm, ln, quant
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)


def _qw(rng, k, n, scale=1.0):
    """(K, N) JAX-layout codes and scales, and the port's (N, K) codes."""
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    q, s = quantize_weight(w)
    return q, s, torch.from_numpy(np.ascontiguousarray(q.T))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", ["bias_fp32", "gelu_n_blocks_m_tail",
                                  "q8_out_gelu"])
def test_w8a8_gemm_plain_matches_pallas_kernel(case):
    """tests/test_int8_gemm.py's two GEMM cases: a bias epilogue on
    (3, 50, 256) -> 384, and the GELU epilogue with N in two blocks and an
    M tail (70 rows in 32-row blocks); and the int8-output form of the
    second (the MLP kernel's fc1 launch): ``w8a8_gemm_q8_plain`` is
    quantize_static of the fp32 GEMM output, and the JAX kernel's output
    quantized by its own _quantize_tile gives the same codes."""
    rng = np.random.default_rng(0 if case == "bias_fp32" else 1)
    if case == "bias_fp32":
        x = rng.normal(size=(3, 50, 256)).astype(np.float32)
        wq, ws, wt = _qw(rng, 256, 384)
        bias = rng.normal(size=(384,)).astype(np.float32)
        amax = np.float32(np.abs(x).max())
        kw, act = dict(bias=jnp.asarray(bias), block_m=64), None
    else:
        x = rng.normal(size=(70, 128)).astype(np.float32)
        wq, ws, wt = _qw(rng, 128, 512)
        bias, amax = None, np.float32(3.0)     # some codes clip
        kw, act = dict(act="gelu", block_m=32, block_n=256), "gelu_tanh"
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_gemm.w8a8_gemm(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
            jnp.asarray(amax), out_dtype=jnp.float32, **kw))
    got = int8_gemm.w8a8_gemm(_t(x), wt, _t(ws), torch.tensor(amax),
                              None if bias is None else _t(bias), act,
                              torch.float32)
    if case == "q8_out_gelu":
        out_amax = np.float32(np.abs(want).max() * 0.8)   # some codes clip
        codes = int8_gemm.w8a8_gemm_q8_plain(
            _t(x), wt, _t(ws), torch.tensor(amax), None, act,
            torch.tensor(out_amax))
        assert codes.dtype == torch.int8
        assert torch.equal(codes, ln.quantize_static(got,
                                                     torch.tensor(out_amax)))
        jax_codes = np.asarray(jax_gemm._quantize_tile(
            jnp.asarray(want), jnp.float32(127.0) / jnp.asarray(out_amax)))
        np.testing.assert_array_equal(codes.numpy(), jax_codes)
        return
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # the activation codes are the JAX kernel's quantize, bit for bit
    codes = jax_gemm._quantize_tile(jnp.asarray(x),
                                    jnp.float32(127.0) / jnp.asarray(amax))
    np.testing.assert_array_equal(
        ln.quantize_static(_t(x), torch.tensor(amax)).numpy(),
        np.asarray(codes))


def test_w8a8_mlp_plain_matches_pallas_kernel():
    """tests/test_int8_gemm.py's MLP case (2, 60, 256) -> 512 -> 256 with
    the tanh GELU the JAX kernel always applies."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 60, 256)).astype(np.float32)
    w1q, w1s, w1t = _qw(rng, 256, 512, 0.05)
    w2q, w2s, w2t = _qw(rng, 512, 256, 0.05)
    b1 = rng.normal(size=(512,)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(256,)).astype(np.float32) * 0.1
    a1 = np.float32(np.abs(x).max())
    h = jax_gemm._gelu_tanh(int8_matmul_static(
        jnp.asarray(x), jnp.asarray(w1q), jnp.asarray(w1s), a1)
        + jnp.asarray(b1))
    a2 = np.float32(float(jnp.abs(h).max()))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_gemm.w8a8_mlp(
            *map(jnp.asarray, (x, w1q, w1s, a1, b1, w2q, w2s, a2, b2)),
            block_m=64, out_dtype=jnp.float32))
    got = int8_gemm.w8a8_mlp(_t(x), w1t, _t(w1s), torch.tensor(a1), _t(b1),
                             w2t, _t(w2s), torch.tensor(a2), _t(b2),
                             "gelu_tanh", torch.float32)
    assert got.shape == (2, 60, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "gelu_erf", "gelu_tanh"])
def test_w8a8_gemm_int8_input_matches_jax_unfused(act, bias):
    """The port's kernels also take int8 x (the LayerNorm->int8 and int8
    attention outputs): the JAX unfused chain int8_matmul_static on the
    same codes, + bias, + gelu_for (erf at fp32, tanh at bf16)."""
    rng = np.random.default_rng(3)
    amax = np.float32(2.5)
    x8 = np.clip(np.round(rng.normal(size=(2, 33, 192)) * (127.0 / amax)),
                 -127, 127).astype(np.int8)
    wq, ws, wt = _qw(rng, 192, 96, 0.05)
    b = rng.normal(size=(96,)).astype(np.float32) * 0.1
    want = int8_matmul_static(jnp.asarray(x8), jnp.asarray(wq),
                              jnp.asarray(ws), jnp.asarray(amax))
    if bias:
        want = want + jnp.asarray(b)
    if act is not None:
        want = jax_gelu_for(jnp.bfloat16 if act == "gelu_tanh"
                            else jnp.float32)(want)
    got = int8_gemm.w8a8_gemm(_t(x8), wt, _t(ws), torch.tensor(amax),
                              _t(b) if bias else None, act, torch.float32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("x_dtype", ["int8", "float32", "bfloat16"])
def test_w8a8_mlp_erf_matches_jax_unfused_chain(x_dtype):
    """The fp32 model's MLP applies the erf GELU (ROADMAP F4): the port's
    w8a8_mlp with 'gelu_erf' against the JAX unfused static chain at fp32
    (fc1, gelu_for(fp32), fc2 quantizing its fp32 input)."""
    rng = np.random.default_rng(4)
    a1 = np.float32(3.0)
    x = rng.normal(size=(40, 128)).astype(np.float32)
    if x_dtype == "int8":
        x = np.clip(np.round(x * (127.0 / a1)), -127, 127).astype(np.int8)
    elif x_dtype == "bfloat16":   # the IV2 MLP's input: bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w1q, w1s, w1t = _qw(rng, 128, 256, 0.05)
    w2q, w2s, w2t = _qw(rng, 256, 128, 0.05)
    b1, b2 = (rng.normal(size=(n,)).astype(np.float32) * 0.1
              for n in (256, 128))
    h = jax_gelu_for(jnp.float32)(int8_matmul_static(
        jnp.asarray(x), jnp.asarray(w1q), jnp.asarray(w1s), a1)
        + jnp.asarray(b1))
    a2 = np.float32(float(jnp.abs(h).max()) * 0.8)     # some codes clip
    want = np.asarray(int8_matmul_static(h, jnp.asarray(w2q),
                                         jnp.asarray(w2s), a2) + b2)
    xt = _t(x).bfloat16() if x_dtype == "bfloat16" else _t(x)
    got = int8_gemm.w8a8_mlp(xt, w1t, _t(w1s), torch.tensor(a1), _t(b1),
                             w2t, _t(w2s), torch.tensor(a2), _t(b2),
                             "gelu_erf", torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_plain_versions_are_the_unfused_model_math():
    """On the CPU the wrappers run the plain versions (no launch counted),
    and those are the unfused static model's operations bit for bit:
    int8_matmul_static + bias, GELU, the re-quantize, + bias, the cast."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(2, 9, 256)).astype(np.float32)).bfloat16()
    _, w1s, w1t = _qw(rng, 256, 512, 0.05)
    _, w2s, w2t = _qw(rng, 512, 256, 0.05)
    b1, b2 = (_t(rng.normal(size=(n,)).astype(np.float32) * 0.1)
              for n in (512, 256))
    a1, a2 = torch.tensor(3.0), torch.tensor(0.8)
    before = (int8_gemm.GEMM_LAUNCHES, int8_gemm.MLP_LAUNCHES)
    got = int8_gemm.w8a8_mlp(x, w1t, _t(w1s), a1, b1, w2t, _t(w2s), a2, b2,
                             "gelu_tanh", torch.bfloat16)
    h = torch.nn.functional.gelu(
        quant.int8_matmul_static(x, w1t, _t(w1s), a1) + b1,
        approximate="tanh")
    want = (quant.int8_matmul_static(h, w2t, _t(w2s), a2) + b2).bfloat16()
    assert torch.equal(got, want)
    gemm = int8_gemm.w8a8_gemm(x, w1t, _t(w1s), a1, b1, None, torch.bfloat16)
    assert torch.equal(gemm, (quant.int8_matmul_static(
        x, w1t, _t(w1s), a1) + b1).bfloat16())
    assert (int8_gemm.GEMM_LAUNCHES, int8_gemm.MLP_LAUNCHES) == before


def test_kernel_argument_checks():
    """What the kernels do not take raises before any launch (shown on CPU
    tensors: the checks do not depend on the device)."""
    rng = np.random.default_rng(6)
    amax = torch.tensor(1.0)
    _, ws, wt = _qw(rng, 48, 64)
    x = torch.zeros((4, 48), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_gemm.check_gemm_args(x, wt, _t(ws), amax)
    _, ws, wt = _qw(rng, 64, 60)
    with pytest.raises(ValueError, match="multiple of 8"):
        int8_gemm.check_gemm_args(torch.zeros((4, 64)), wt, _t(ws), amax)
    _, ws, wt = _qw(rng, 64, 64)
    with pytest.raises(ValueError, match="activation"):
        int8_gemm.check_gemm_args(torch.zeros((4, 64)), wt, _t(ws), amax,
                                  act="relu")
    with pytest.raises(ValueError, match="out_dtype"):
        int8_gemm.check_gemm_args(torch.zeros((4, 64)), wt, _t(ws), amax,
                                  out_dtype=torch.float16)
    with pytest.raises(ValueError, match="bias"):
        int8_gemm.check_gemm_args(torch.zeros((4, 64)), wt, _t(ws), amax,
                                  bias=torch.zeros(63))
    assert int8_gemm.check_gemm_args(torch.zeros((4, 64)), wt, _t(ws),
                                     amax) == 1
    with pytest.raises(ValueError, match="unsupported device"):
        int8_gemm.w8a8_gemm(torch.zeros((4, 64), device="meta"), wt, _t(ws),
                            amax)
    # the MLP's width rule: dim and hidden multiples of 32 (its two
    # products' K); ViT-L's and IV2-1B's widths among them
    for dim, hidden, fits in ((384, 1536, True), (768, 3072, True),
                              (1024, 4096, True), (1408, 6144, True),
                              (768, 3000, False), (48, 192, False)):
        assert int8_gemm.use_fused_mlp(dim, hidden) == fits, (dim, hidden)
    _, s1, w1 = _qw(rng, 48, 192)
    _, s2, w2 = _qw(rng, 192, 48)
    with pytest.raises(ValueError, match="use_fused_mlp"):
        int8_gemm.check_mlp_args(torch.zeros((4, 48)), w1, _t(s1), amax,
                                 None, w2, _t(s2), amax, None)


@pytest.mark.parametrize("name", [n for n in models.list_models()
                                  if models.model_family(n)
                                  not in ("mae", "iv2_mae")])
def test_use_fused_mlp_at_every_registered_width(name):
    """Every registered ViT and InternVideo2 width (the served families;
    the pre-training models are not served in int8) takes the MLP kernel
    with ``fused_mlp`` (its dim and hidden are multiples of 32), and the
    model's Mlp says so."""
    kind, cfg = models._REGISTRY[name]
    dim = cfg["embed_dim"]
    hidden = int(dim * cfg["mlp_ratio"])
    assert int8_gemm.use_fused_mlp(dim, hidden), (name, dim, hidden)
    mlp = Mlp(dim, hidden, quant=True, quant_mode="static", fused_w8a8=True,
              fused_mlp=True, device="meta")
    assert mlp.fused_mlp, name
