"""The port's training attention on separate operands (kernels C3:
simple_tad_tpu_torch.ops.flash_attention.flash_attention_fwd_lse,
flash_attention_bwd and the autograd FlashAttention) against the JAX
package's _flash_fwd_impl and _flash_bwd_impl (TPU kernels _fwd_kernel and
_bwd_merged_kernel_dt) in interpret mode, on the (B*H, N, Dh) relayout the
JAX side runs them on.  B=2, H=2, ragged N in {9, 37} at Dh in {64, 88}, plus
Dh 80 and 128 at N = 9 and N = 129 at Dh 64: the port takes 80 and 88 as
they are, the JAX side zero-pads them to 128 as its dot_product_attention
does (the pad columns add nothing to QK or PV).

Tolerances, each with its reason:
  * fp32 out and lse 3e-5 (as tests/test_torch_attention.py: summation
    order; the port's integer row maximum and the TPU kernel's true one give
    the same fp32 function; read: 1.3e-6 and 9.5e-7);
  * bf16 out 1.6e-2 absolute: the port subtracts the row maximum rounded up
    to an integer where _fwd_kernel subtracts the true one, so each
    probability is rounded to bf16 from another value, and out moves by up
    to one bf16 ulp (1.6e-2 at |out| in [2, 4); read: 7.8e-3, one ulp at
    |out| in [1, 2));
  * bf16 lse 5.7e-3, the analytic bound: each rounded probability lies
    within half a bf16 ulp (2^-9 relative) of its exact value on either
    side, so the two denominators differ by at most 2^-8 relative and lse
    by log2(1 + 2^-8) = 5.6e-3 (read: 2.9e-3 at N = 9, 1.8e-3 at N = 37;
    at Dh 88, padded to 128, the TPU kernel sums unrounded fp32 p);
  * the backward on the JAX forward's own residuals: fp32 1e-4 (sums of N
    products in another order), bf16 3e-2 absolute plus 1e-2 relative (bf16
    outputs, one ulp of the largest gradients), as
    tests/test_torch_train_attention.py holds the packed C2;
  * gradients through FlashAttention against jax.grad of the JAX
    flash_attention (its custom VJP _flash_core_packed) with those bounds,
    v a strided view of a (B, N, 3C) tensor on the port side;
  * float64 gradcheck at eps 1e-6, atol 1e-6.
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops import flash_attention as jfa
from simple_tad_tpu_torch.ops import flash_attention as fa
from tests.test_torch_vit import one_torch_thread  # noqa: F401

B, H = 2, 2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(out=(3e-5, 3e-5), lse=(3e-5, 0.0), grad=(1e-4, 1e-4)),
       "bfloat16": dict(out=(1.6e-2, 0.0), lse=(5.7e-3, 0.0),
                        grad=(3e-2, 1e-2))}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1], err_msg=msg)


def _sep(qkv, C, dtype):
    """q, k contiguous and v the strided column block, as InternVideo2's
    attention gives them."""
    t = torch.from_numpy(qkv).to(dtype)
    return t[..., :C].contiguous(), t[..., C:2 * C].contiguous(), t[..., 2 * C:]


def _bh(x, d, dp):
    """(B, N, H*d) numpy -> the JAX layout (B*H, N, dp), zero-padded."""
    b, n, _ = x.shape
    t = x.reshape(b, n, H, d).transpose(0, 2, 1, 3).reshape(b * H, n, d)
    return jnp.asarray(np.pad(t, ((0, 0), (0, 0), (0, dp - d))))


def _from_bh(x, d):
    """JAX (B*H, N, dp) -> (B, N, H*d) numpy fp32, pad columns dropped."""
    a = np.asarray(jnp.asarray(x, jnp.float32))[..., :d]
    return a.reshape(B, H, -1, d).transpose(0, 2, 1, 3).reshape(B, -1, H * d)


# (N, Dh): the ragged N of 9 and 37 at Dh 64 and 88, and the head dims the
# backward's route separates (64 the wgmma kernels, 80 and 128 the mma.sync
# ones) at N = 129, one row past two 64-row tiles (80 and 128 at N = 9 to
# keep interpret mode cheap)
C3_CASES = [(9, 64), (9, 88), (37, 64), (37, 88), (9, 80), (9, 128),
            (129, 64)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", C3_CASES)
def test_plain_c3_matches_pallas(n, d, dtype):
    tdt, jdt = DTYPES[dtype]
    tol = TOL[dtype]
    C, dp, scale = H * d, -(-d // 64) * 64, d ** -0.5
    qkv = _rand((B, n, 3 * C), n + d)
    dout = _rand((B, n, C), 1)
    q, k, v = _sep(qkv, C, tdt)
    jq, jk, jv = (_bh(t.float().numpy(), d, dp).astype(jdt) for t in (q, k, v))
    jdo = _bh(dout, d, dp).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = jfa._flash_fwd_impl(jq, jk, jv, scale, 0)
        jdq, jdk, jdv = jfa._flash_bwd_impl(jq, jk, jv, jout, jlse, jdo,
                                            scale, 0)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, H, scale)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert out.shape == (B, n, C) and lse.shape == (B, H, n)
    _close(out.float(), _from_bh(jout, d), tol["out"], "out")
    _close(lse, np.asarray(jlse).reshape(B, H, n), tol["lse"], "lse")
    # the backward on the JAX forward's own residuals
    grads = fa.flash_attention_bwd(
        q, k, v, torch.from_numpy(_from_bh(jout, d)).to(tdt),
        torch.from_numpy(np.array(jlse).reshape(B, H, n)),
        torch.from_numpy(dout).to(tdt), H, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert got.dtype == tdt and got.shape == (B, n, C), name
        _close(got.float(), _from_bh(want, d), tol["grad"], name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_function_gradient_matches_jax_grad(dtype):
    """FlashAttention through autograd (v a strided view) against jax.grad
    of the JAX package's flash_attention on (B, N, H, Dh) operands."""
    tdt, jdt = DTYPES[dtype]
    n, d = 37, 64
    C, scale = H * d, d ** -0.5
    qkv = _rand((B, n, 3 * C), 2)
    w = _rand((B, n, C), 3)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, scale=scale)
        return jnp.sum(out.astype(jnp.float32).reshape(B, n, C) * w)

    jops = [jnp.asarray(qkv[..., i * C:(i + 1) * C].reshape(B, n, H, d)
                        ).astype(jdt) for i in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jops)
    leaf = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    q, k, v = leaf[..., :C], leaf[..., C:2 * C], leaf[..., 2 * C:]
    before = (fa.SEP_LAUNCHES, fa.SEP_FWD_LSE_LAUNCHES, fa.SEP_BWD_LAUNCHES)
    out = fa.flash_attention(q.contiguous(), k.contiguous(), v, H, scale)
    (out.float() * torch.from_numpy(w)).sum().backward()
    # the CPU takes the plain versions
    assert (fa.SEP_LAUNCHES, fa.SEP_FWD_LSE_LAUNCHES,
            fa.SEP_BWD_LAUNCHES) == before
    got = leaf.grad.float().numpy()
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(got[..., i * C:(i + 1) * C],
               np.asarray(want[i].astype(jnp.float32)).reshape(B, n, C),
               TOL[dtype]["grad"], name)


def test_attention_function_gradcheck_float64():
    """The plain Function's analytic gradient in float64 against finite
    differences, v a strided view."""
    x = torch.from_numpy(_rand((1, 6, 3 * 2 * 8), 4)).double()
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: fa.FlashAttention.apply(t[..., :16], t[..., 16:32],
                                          t[..., 32:], 2, 8 ** -0.5),
        (x,), eps=1e-6, atol=1e-6)


def test_separate_and_packed_plain_training_attention_agree():
    """The separate-operand plain versions on views of one qkv give the
    packed plain versions' results bit for bit: one arithmetic, shared."""
    qkv = torch.from_numpy(_rand((B, 20, 3 * H * 64), 5)).bfloat16()
    dout = torch.from_numpy(_rand((B, 20, H * 64), 6)).bfloat16()
    C, scale = H * 64, 0.125
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    out, lse = fa.flash_attention_fwd_lse_plain(q, k, v, H, scale)
    pout, plse = fa.flash_attention_qkv_fwd_lse_plain(qkv, H, scale)
    assert torch.equal(out, pout) and torch.equal(lse, plse)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, H, scale)
    assert torch.equal(torch.cat(grads, -1), fa.flash_attention_qkv_bwd_plain(
        qkv, out, lse, dout, H, scale))


def test_attention_without_grad_is_the_inference_path():
    qkv = torch.from_numpy(_rand((B, 16, 3 * H * 64), 7))
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    with torch.no_grad():
        got = fa.flash_attention(q.requires_grad_(True), k, v, H, 0.125)
    assert got.grad_fn is None
    assert torch.equal(got, fa.flash_attention_plain(q.detach(), k, v, H,
                                                     0.125))
