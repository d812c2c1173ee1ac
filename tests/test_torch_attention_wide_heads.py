"""The bf16/fp32 attention forwards at the head dims the wgmma forward
takes beyond 64 (ViT-H's 80, IV2-1B's 88, IV2-6B's 128) against the JAX
package's Pallas kernels in interpret mode, B=2, H=2, ragged N in
{37, 65}: A1 on separate operands (v the strided column block of the
qkv tensor) against _flash_primal_packed_impl, B3 on separate operands
against _flash_primal_packed_q8_impl, C1 on the packed qkv against
_flash_fwd_packed_qkv_impl, C3-fwd against _flash_fwd_impl on the
(B*H, N, Dh) relayout.  The JAX side runs each head zero-padded to 128
lanes, as its models store IV2-1B's 88 (the pad columns add nothing to
QK or PV, and are dropped from its output); the port takes the head dim
as it is.  C3-fwd at (37, 88) is held by
tests/test_torch_iv2_train_attention.py (C3_CASES) and is not repeated.

Tolerances, each with its reason:
  * A1-sep and C1 out: fp32 3e-5 (summation order), bf16 2e-2 (one bf16
    ulp at |out| <= 4): both sides are max-free, the port's integer row
    maximum only scales every rounded probability by a power of two;
  * C1 lse: fp32 1e-5, bf16 1e-4 (the same rounded probabilities summed
    in another order), as tests/test_torch_train_attention.py;
  * C3-fwd: fp32 3e-5; bf16 out 1.6e-2 and lse 5.7e-3, the bounds of
    tests/test_torch_iv2_train_attention.py (_fwd_kernel subtracts the true
    row maximum, so each probability is rounded from another value);
  * B3 codes: at most 1 apart in at most 1% of codes (a code moves only
    where its fp32 value sits within a rounding error of a half-integer),
    and in bf16 a control (probabilities not rounded to bf16) beyond that
    share.
The CUDA kernel is held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops import flash_attention as jfa
from simple_tad_tpu_torch.ops import flash_attention as fa
from simple_tad_tpu_torch.ops import ln
from tests.test_torch_vit import one_torch_thread  # noqa: F401

B, H, LANES = 2, 2, 128
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
OUT_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 0.0)}
LSE_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-4, 0.0)}
C3_TOL = {"float32": dict(out=(3e-5, 3e-5), lse=(3e-5, 0.0)),
          "bfloat16": dict(out=(1.6e-2, 0.0), lse=(5.7e-3, 0.0))}
CODE_SHARE = 0.01
HEAD_DIMS = [80, 88, 128]
LENGTHS = [37, 65]
# (N, Dh) of C3-fwd: every pair but the one C3_CASES holds
C3_FWD_CASES = [(n, d) for n in LENGTHS for d in HEAD_DIMS
                if (n, d) != (37, 88)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1], err_msg=msg)


def _sep(qkv, C, dtype):
    """q and k contiguous, v the strided column block (row stride 3C)."""
    t = torch.from_numpy(qkv).to(dtype)
    return t[..., :C].contiguous(), t[..., C:2 * C].contiguous(), \
        t[..., 2 * C:]


def _lanes(t, d, jdt):
    """(B, N, H*d) port tensor -> the JAX (B, N, H*128), each head
    zero-padded to the 128 lanes."""
    a = t.float().numpy().reshape(B, -1, H, d)
    a = np.pad(a, ((0, 0), (0, 0), (0, 0), (0, LANES - d)))
    return jnp.asarray(a.reshape(B, -1, H * LANES)).astype(jdt)


def _unlanes(x, d):
    """JAX (B, N, H*128) -> (B, N, H*d) numpy fp32, pad columns dropped."""
    a = np.asarray(jnp.asarray(x, jnp.float32))
    return a.reshape(B, -1, H, LANES)[..., :d].reshape(B, -1, H * d)


def _code_diff(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(diff.max()), float((diff > 0).mean())


def _q8_control(q, k, v, scale, out_amax):
    """The plain B3 without rounding the probabilities to bf16."""
    qh, kh, vh = (fa._heads(t, H).float() for t in (q, k, v))
    qs = (qh * (scale * fa.LOG2E)).to(q.dtype).float()
    s = qs @ kh.transpose(-1, -2)
    p = torch.exp2(s - torch.ceil(s.amax(-1, keepdim=True)))
    o = (p @ vh) / p.sum(-1, keepdim=True)
    return ln.quantize_static(fa._merge_heads(o), out_amax)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_a1_sep_matches_pallas(d, n, dtype):
    tdt, jdt = DTYPES[dtype]
    C, scale = H * d, d ** -0.5
    q, k, v = _sep(_rand((B, n, 3 * C), n + d), C, tdt)
    fn = jax.jit(functools.partial(jfa._flash_primal_packed_impl,
                                   num_heads=H, scale=scale, block_q=0))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(_lanes(t, d, jdt) for t in (q, k, v)))
    got = fa.flash_attention(q, k, v, H, scale)
    assert got.dtype == tdt and got.shape == (B, n, C)
    _close(got.float(), _unlanes(want, d), OUT_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_b3_sep_matches_pallas(d, n, dtype):
    tdt, jdt = DTYPES[dtype]
    C, scale = H * d, d ** -0.5
    q, k, v = _sep(_rand((B, n, 3 * C), 2 * n + d), C, tdt)
    out_amax = torch.tensor(float(fa.flash_attention_plain(
        q.float(), k.float(), v.float(), H, scale).abs().max()) * 0.9)
    fn = jax.jit(functools.partial(jfa._flash_primal_packed_q8_impl,
                                   num_heads=H, scale=scale, block_q=0))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(_lanes(t, d, jdt) for t in (q, k, v)),
                  out_amax=jnp.asarray(out_amax.numpy()))
    want = np.asarray(want).reshape(B, n, H, LANES)[..., :d].reshape(
        B, n, C)
    got = fa.flash_attention_q8(q, k, v, H, scale, out_amax)
    assert got.dtype == torch.int8 and got.shape == (B, n, C)
    assert np.abs(got.numpy()).max() == 127
    worst, share = _code_diff(got.numpy(), want)
    assert worst <= 1 and share <= CODE_SHARE, (worst, share)
    if dtype == "bfloat16":          # in fp32 the rounding is exact
        control = _q8_control(q, k, v, scale, out_amax)
        assert _code_diff(control.numpy(), want)[1] > CODE_SHARE
    # keys at or beyond n_kv are left out
    n_kv = n - 5
    assert torch.equal(
        fa.flash_attention_q8(q, k, v, H, scale, out_amax, n_kv),
        fa.flash_attention_q8_plain(q, k[:, :n_kv], v[:, :n_kv], H, scale,
                                    out_amax))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_c1_matches_pallas(d, n, dtype):
    tdt, jdt = DTYPES[dtype]
    C, scale = H * d, d ** -0.5
    qkv = torch.from_numpy(_rand((B, n, 3 * C), 3 * n + d)).to(tdt)
    jqkv = jnp.concatenate([_lanes(t, d, jdt) for t in qkv.split(C, -1)],
                           axis=-1)
    fn = jax.jit(functools.partial(jfa._flash_fwd_packed_qkv_impl,
                                   num_heads=H, scale=scale, block_q=0))
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = fn(jqkv)
    out, lse = fa.flash_attention_qkv_fwd_lse(qkv, H, scale)
    assert out.dtype == tdt and lse.shape == (B, H, n)
    _close(out.float(), _unlanes(jout, d), OUT_TOL[dtype], "out")
    # the JAX lse is (B, head groups, N, heads a group): one head a group
    # of 128 lanes
    _close(lse, np.asarray(jlse)[..., 0], LSE_TOL[dtype], "lse")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", C3_FWD_CASES)
def test_plain_c3_fwd_matches_pallas(n, d, dtype):
    tdt, jdt = DTYPES[dtype]
    tol = C3_TOL[dtype]
    C, scale = H * d, d ** -0.5
    q, k, v = _sep(_rand((B, n, 3 * C), 4 * n + d), C, tdt)

    def bh(t):
        """(B, N, H*d) -> the JAX (B*H, N, 128), zero-padded."""
        a = t.float().numpy().reshape(B, n, H, d).transpose(0, 2, 1, 3)
        a = np.pad(a.reshape(B * H, n, d), ((0, 0), (0, 0), (0, LANES - d)))
        return jnp.asarray(a).astype(jdt)

    fn = jax.jit(functools.partial(jfa._flash_fwd_impl, scale=scale,
                                   block_q=0))
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = fn(bh(q), bh(k), bh(v))
    out, lse = fa.flash_attention_fwd_lse(q, k, v, H, scale)
    assert out.dtype == tdt and out.shape == (B, n, C)
    want = np.asarray(jnp.asarray(jout, jnp.float32))[..., :d].reshape(
        B, H, n, d).transpose(0, 2, 1, 3).reshape(B, n, C)
    _close(out.float(), want, tol["out"], "out")
    _close(lse, np.asarray(jlse).reshape(B, H, n), tol["lse"], "lse")
