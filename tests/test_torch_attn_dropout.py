"""The port's attention dropout (kernels C4's plain versions and dispatch:
simple_tad_tpu_torch.ops.flash_attention.flash_attention_drop_fwd /
_bwd, FlashAttentionDrop, philox4x32_plain, dropout_keep_plain, and
ops/attention.py's dropout branch) against the JAX package.

The mask form is held to the JAX Pallas mask kernels _flash_drop_fwd_impl
and _flash_drop_bwd_impl (TPU kernels _fwd_kernel_drop, _bwd_dq_kernel_drop,
_bwd_dkv_kernel_drop) in interpret mode on the (B*H, N, Dh) relayout, at
rate 0.3: N = 131 (padded to 136 on the JAX side), 136 and 320 with
block_q 80 (the blocked, transposed dk/dv).  The TPU's hardware PRNG bits
cannot be reproduced, so the seed form (the port's Philox) is held to the
same JAX mask kernels fed dropout_keep_plain's mask, and Philox itself to
known-answer vectors and keep statistics.

Tolerances, each with its reason: fp32 out, lse and gradients within 1e-5
of each tensor's largest magnitude (summation order; the port subtracts
the row maximum rounded up to an integer where the TPU kernel subtracts
the true one, which in fp32 is the same function); gradients through
autograd against jax.grad likewise; the mask, the Philox words and the
dropout threshold exact; the keep rate and the correlations of
neighbouring keep bits within 5 standard errors of 1 - rate and 0.
The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from simple_tad_tpu.ops import attention as jattn
from simple_tad_tpu.ops import flash_attention as jfa
from simple_tad_tpu_torch.ops import attention as attn
from simple_tad_tpu_torch.ops import flash_attention as fa
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

B, H, D = 2, 2, 64
C = H * D
RATE = 0.3
REL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask(n, seed, rate=RATE):
    return (np.random.default_rng(seed).random((B, H, n, n))
            >= rate).astype(np.int8)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=REL * max(float(np.abs(want).max()),
                                              1e-12), err_msg=what)


def _ops(qkv):
    """q, k contiguous and v the strided column block of the qkv tensor."""
    t = torch.from_numpy(qkv)
    return (t[..., :C].contiguous(), t[..., C:2 * C].contiguous(),
            t[..., 2 * C:])


def _bh(x):
    """(B, N, H*Dh) numpy -> the JAX (B*H, N, Dh) layout."""
    b, n, _ = x.shape
    return jnp.asarray(x.reshape(b, n, H, D).transpose(0, 2, 1, 3)
                       .reshape(b * H, n, D))


def _from_bh(x):
    a = np.asarray(x, np.float32)
    return a.reshape(B, H, -1, D).transpose(0, 2, 1, 3).reshape(B, -1, C)


def _jax_mask_kernels(qkv, dout, mask, n, block_q):
    """out, lse, dq, dk, dv of the JAX Pallas mask kernels in interpret
    mode (the backward on the forward's own residuals), in the port's
    layouts."""
    jq, jk, jv = (_bh(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    jm = jnp.asarray(mask.reshape(B * H, n, n))
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_drop_fwd_impl(jq, jk, jv, jm, D ** -0.5,
                                            1 - RATE, block_q)
        grads = jfa._flash_drop_bwd_impl(jq, jk, jv, jm, out, lse,
                                         _bh(dout), D ** -0.5, 1 - RATE,
                                         block_q)
    return (_from_bh(out), np.array(lse).reshape(B, H, n),
            *(_from_bh(g) for g in grads))


def _check_against_jax(qkv, dout, n, block_q, keep_mask, **src):
    want = _jax_mask_kernels(qkv, dout, keep_mask, n, block_q)
    q, k, v = _ops(qkv)
    out, lse = fa.flash_attention_drop_fwd(q, k, v, H, D ** -0.5, RATE,
                                           **src)
    assert out.shape == (B, n, C) and lse.shape == (B, H, n)
    _close(out, want[0], "out")
    _close(lse, want[1], "lse")
    grads = fa.flash_attention_drop_bwd(
        q, k, v, torch.from_numpy(want[0]), torch.from_numpy(want[1]),
        torch.from_numpy(dout), H, D ** -0.5, RATE, **src)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want[2:]):
        assert got.shape == (B, n, C) and got.dtype == torch.float32
        _close(got, w, name)


@pytest.mark.parametrize("n,block_q", [(131, 0), (136, 0), (320, 80)])
def test_plain_mask_form_matches_pallas_mask_kernels(n, block_q):
    qkv, dout = _rand((B, n, 3 * C), n), _rand((B, n, C), n + 1)
    mask = _mask(n, n + 2)
    _check_against_jax(qkv, dout, n, block_q, mask,
                       mask=torch.from_numpy(mask))


@pytest.mark.parametrize("n,block_q", [(136, 0), (320, 80)])
def test_plain_rng_form_matches_pallas_mask_kernels_fed_its_bits(n, block_q):
    """The seed form's forward and backward are the JAX mask kernels' on
    dropout_keep_plain's mask: the Philox bits are the only difference."""
    qkv, dout = _rand((B, n, 3 * C), n + 3), _rand((B, n, C), n + 4)
    seed = torch.tensor([n, -12345], dtype=torch.int32)
    keep = fa.dropout_keep_plain(seed, B, H, n, RATE)
    _check_against_jax(qkv, dout, n, block_q, keep.numpy(), seed=seed)


@pytest.mark.parametrize("form", ["mask", "seed"])
def test_autograd_matches_jax_grad(form):
    """FlashAttentionDrop through autograd (v a strided view) against
    jax.grad of the JAX package's flash_attention(dropout_mask=...) on
    (B, N, H, Dh) operands, in interpret mode."""
    n = 136
    qkv, w = _rand((B, n, 3 * C), 5), _rand((B, n, C), 6)
    if form == "mask":
        keep = torch.from_numpy(_mask(n, 7))
        src = {"mask": keep}
    else:
        src = {"seed": torch.tensor([77, 78], dtype=torch.int32)}
        keep = fa.dropout_keep_plain(src["seed"], B, H, n, RATE)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, scale=D ** -0.5,
                                  dropout_mask=jnp.asarray(keep.numpy()),
                                  keep_prob=1 - RATE)
        return jnp.sum(out.reshape(B, n, C) * w)

    jops = [jnp.asarray(qkv[..., i * C:(i + 1) * C].reshape(B, n, H, D))
            for i in range(3)]
    with pltpu.force_tpu_interpret_mode():
        jl, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*jops)
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    q, k, v = leaf[..., :C], leaf[..., C:2 * C], leaf[..., 2 * C:]
    out = fa.flash_attention_drop(q.contiguous(), k.contiguous(), v, H,
                                  D ** -0.5, RATE, **src)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for i, name in enumerate("qkv"):
        _close(leaf.grad[..., i * C:(i + 1) * C],
               np.asarray(want[i]).reshape(B, n, C), f"d{name}")


def test_gradcheck_float64():
    """The plain forward and backward are each other's derivative."""
    n = 11
    qkv = torch.from_numpy(_rand((1, n, 3 * 16), 8)).double()
    mask = torch.from_numpy((np.random.default_rng(9).random((1, 2, n, n))
                             >= 0.4).astype(np.int8))
    leaf = qkv.requires_grad_(True)

    def f(x):
        return fa.flash_attention_drop(x[..., :16], x[..., 16:32],
                                       x[..., 32:], 2, 0.25, 0.4, mask=mask)

    assert torch.autograd.gradcheck(f, (leaf,), eps=1e-6, atol=1e-6)


# Philox4x32-10 known-answer vectors (counter, key, output), checked with
# a scalar implementation of the generator
KAT = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                               0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = fa.philox4x32_plain(torch.tensor(counter, dtype=torch.int64),
                              torch.tensor(key, dtype=torch.int64))
    assert [int(x) for x in got] == list(want)
    # int32 words read as their bits
    as_i32 = torch.tensor(np.array(counter, np.uint32).view(np.int32))
    got = fa.philox4x32_plain(as_i32, torch.tensor(
        np.array(key, np.uint32).view(np.int32)))
    assert [int(x) for x in got] == list(want)


def test_keep_mask_follows_the_philox_map():
    """dropout_keep_plain's element (b, h, q, k) is word 2 ((q >> 3) & 1) +
    ((k >> 3) & 1) of Philox at counter (k & ~8, q & ~8, b H + h, 0)."""
    seed = torch.tensor([-5, 99], dtype=torch.int32)
    n, rate = 37, 0.5
    keep = fa.dropout_keep_plain(seed, B, H, n, rate)
    thresh = fa.dropout_rng_thresh(rate)
    rng = np.random.default_rng(10)
    for _ in range(40):
        b, h, q, k = (int(rng.integers(x)) for x in (B, H, n, n))
        w = fa.philox4x32_plain(
            torch.tensor([k & ~8, q & ~8, b * H + h, 0]), seed)
        word = int(w[2 * ((q >> 3) & 1) + ((k >> 3) & 1)])
        assert int(keep[b, h, q, k]) == int(word >= thresh)


def test_keep_mask_is_a_function_of_the_seed():
    seed = torch.tensor([1, 2], dtype=torch.int32)
    a = fa.dropout_keep_plain(seed, B, H, 50, 0.1)
    assert a.dtype == torch.int8 and a.shape == (B, H, 50, 50)
    assert a.is_contiguous()
    assert torch.equal(a, fa.dropout_keep_plain(seed.clone(), B, H, 50, 0.1))
    assert not torch.equal(a, fa.dropout_keep_plain(seed + 1, B, H, 50, 0.1))
    assert not torch.equal(a, fa.dropout_keep_plain(
        torch.tensor([1, 3], dtype=torch.int32), B, H, 50, 0.1))
    # a prefix of a longer sequence's mask: the map knows no N
    assert torch.equal(a, fa.dropout_keep_plain(seed, B, H, 64, 0.1)
                       [..., :50, :50])


def _within(x, mean, n, var):
    """|mean of n samples of variance var - mean| within 5 standard
    errors."""
    return abs(x - mean) <= 5 * (var / n) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_statistics(rate):
    """Keep rate 1 - rate; neighbouring columns, rows 8 apart (one Philox
    call's words), heads and batches uncorrelated."""
    b, h, n = 4, 3, 160
    m = fa.dropout_keep_plain(torch.tensor([2024, -7], dtype=torch.int32),
                              b, h, n, rate).double()
    keep = 1 - rate
    assert _within(m.mean().item(), keep, m.numel(), keep * rate)
    x = m - keep
    var = (keep * rate) ** 2       # variance of a product of two
    for what, a, c in (("columns", x[..., :, 1:], x[..., :, :-1]),
                       ("columns 8 apart", x[..., :, 8:], x[..., :, :-8]),
                       ("rows 8 apart", x[..., 8:, :], x[..., :-8, :]),
                       ("heads", x[:, 1:], x[:, :-1]),
                       ("batches", x[1:], x[:-1])):
        prod = a * c
        assert _within(prod.mean().item(), 0.0, prod.numel(), var), what


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5, 0.9, 1.0, 1 - 2 ** -40,
                                  2 ** -33])
def test_dropout_threshold_is_the_jax_one(rate):
    assert attn.dropout_rng_thresh(rate) == jfa._drop_rng_thresh(rate)
    assert fa.dropout_rng_thresh(rate) <= 2 ** 32 - 1


def _qkv(n=24, seed=11):
    return torch.from_numpy(_rand((B, n, 3 * C), seed))


def test_no_dropout_leaves_the_generator_alone():
    """At rate 0 (eval, or no dropout) the dropout path is never taken and
    the generator does not move."""
    qkv = _qkv()
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    for form in attn.DROPOUT_FORMS:
        out = attn.dot_product_attention_qkv(qkv, num_heads=H,
                                             scale=D ** -0.5,
                                             dropout_rate=0.0, generator=g,
                                             dropout_form=form)
        assert torch.equal(out, fa.flash_attention_qkv(qkv, H, D ** -0.5))
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("form", ["rng", "mask"])
def test_dropout_dispatch_draws_and_takes_its_plain_version(form,
                                                            monkeypatch):
    """A positive rate draws the form's keep source from the generator (a
    seed, or an int8 mask) and runs that form's plain version, on the
    packed qkv read as three column views; in grad mode it trains."""
    qkv = _qkv().requires_grad_(True)
    calls = []
    plain = fa.flash_attention_drop_fwd_plain

    def spy(*args, **kw):
        calls.append(sorted(k for k, v in kw.items() if v is not None))
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_drop_fwd_plain", spy)
    g = torch.Generator().manual_seed(4)
    replay = torch.Generator().manual_seed(4)
    out = attn.dot_product_attention_qkv(qkv, num_heads=H, scale=D ** -0.5,
                                         dropout_rate=RATE, generator=g,
                                         dropout_form=form)
    assert calls == [["seed"] if form == "rng" else ["mask"]]
    assert not torch.equal(g.get_state(), replay.get_state())
    n = qkv.shape[1]
    src = ({"seed": attn.draw_dropout_seed(replay)} if form == "rng" else
           {"mask": attn.make_dropout_mask(replay, RATE, B, H, n)})
    assert torch.equal(g.get_state(), replay.get_state())
    q, k, v = qkv.detach()[..., :C], qkv.detach()[..., C:2 * C], \
        qkv.detach()[..., 2 * C:]
    want = plain(q, k, v, H, D ** -0.5, RATE, **src)[0]
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


def test_dropout_sources_on_the_generator():
    g = torch.Generator().manual_seed(5)
    seed = attn.draw_dropout_seed(g)
    assert seed.dtype == torch.int32 and seed.shape == (2,)
    mask = attn.make_dropout_mask(g, 0.25, 3, 2, 40)
    assert mask.dtype == torch.int8 and mask.shape == (3, 2, 40, 40)
    assert set(mask.unique().tolist()) == {0, 1}
    assert _within(mask.double().mean().item(), 0.75, mask.numel(),
                   0.75 * 0.25)
    with pytest.raises(ValueError, match="dropout form"):
        attn.dot_product_attention_qkv(_qkv(), num_heads=H, scale=0.1,
                                       dropout_rate=0.1, generator=g,
                                       dropout_form="bits")


def test_long_sequences_take_plain_attention_with_the_mask(monkeypatch):
    """Beyond the single-pass cap (N > 4096) both forms take the JAX
    package's route: plain attention with a drawn mask (its
    _naive_attention with dropout_mask)."""
    n, h, d = 4100, 1, 16
    qkv = torch.from_numpy(_rand((1, n, 3 * h * d), 12))
    g = torch.Generator().manual_seed(6)
    drawn = []
    make = attn.make_dropout_mask

    def spy(*args, **kw):
        drawn.append(make(*args, **kw))
        return drawn[-1]

    monkeypatch.setattr(attn, "make_dropout_mask", spy)
    monkeypatch.setattr(fa, "flash_attention_drop_fwd_plain", None)
    out = attn.dot_product_attention_qkv(qkv, num_heads=h, scale=d ** -0.5,
                                         dropout_rate=RATE, generator=g,
                                         dropout_form="rng")
    assert len(drawn) == 1 and drawn[0].shape == (1, h, n, n)
    jq, jk, jv = (jnp.asarray(qkv[..., i * d:(i + 1) * d].numpy()
                              .reshape(1, n, h, d)) for i in range(3))
    want = jattn._naive_attention(jq, jk, jv, d ** -0.5, dropout_rate=RATE,
                                  deterministic=False,
                                  dropout_mask=jnp.asarray(drawn[0].numpy()))
    _close(out, np.asarray(want).reshape(1, n, h * d), "out")
