"""The bf16/fp32 attention forward's route by dtype and head dim
(kernels A1 packed and on separate operands, C1, C3-fwd, B3 and C4-fwd;
simple_tad_tpu_torch.ops.flash_attention.attention_fwd_route), on the CPU.

bf16 at head dims 64 to 128 takes the wgmma kernel of csrc/attention.cu
(a template on its tile width, 64, 96 or 128 columns), with or without
dropout (C4-fwd in either keep form), bf16 at head dims 8 to 56 the
mma.sync kernel, fp32 the CUDA-core kernel; the function mirrors the
source's route() (stt_attention_fwd_route on the card,
tests/test_torch_cuda.py).  A CPU tensor takes the plain version and counts
no launch on any route.  The dropout forward counts its call on the route
it takes, as the other forwards do.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simple_tad_tpu_torch.ops import flash_attention as fa

SOURCE = Path(fa.__file__).resolve().parent.parent / "csrc" / "attention.cu"
ROUTE_COUNTERS = ("FWD_WGMMA_LAUNCHES", "FWD_MMA_LAUNCHES",
                  "FWD_F32_LAUNCHES")
# route() of csrc/attention.cu, as its source spells it: it takes no
# dropout input
ROUTE_EXPR = (r"constexpr int route\(int dtype, int d\) \{\s*"
              r"return dtype == stt::kFloat32 \? kRouteF32\s*"
              r": d >= wg::kMinD\s*\? kRouteWgmma\s*"
              r": kRouteMma;\s*\}")
# every dispatch of a C4 entry point (stt_attention_fwd_lse_drop,
# stt_attention_bwd_drop) goes through that route()
DISPATCH_EXPR = r"if \(route\(dtype, d\) == kRouteWgmma\)"


def _wgmma_min_head_dim(src: str) -> int:
    """The least head dim of a source's wgmma route, as its
    namespace wg declares it."""
    wg = src[src.index("namespace wg {"):]
    return int(re.search(r"constexpr int kMinD = (\d+);", wg).group(1))


def _source_route():
    """-> route(dtype, d) of csrc/attention.cu as a Python function
    returning the route's name, from the source's codes and the wgmma
    route's least head dim (the entry points take head dims up to 128)."""
    src = SOURCE.read_text()
    assert re.search(ROUTE_EXPR, src), "route() no longer reads as expected"
    assert len(re.findall(DISPATCH_EXPR, src)) == 1, \
        "dispatch no longer takes route() for every keep form"
    codes = {k: int(v) for k, v in re.findall(r"kRoute(\w+) = (\d)", src)}
    min_d = _wgmma_min_head_dim(src)

    def route(dtype, d):
        code = (codes["F32"] if dtype == torch.float32
                else codes["Wgmma"] if d >= min_d
                else codes["Mma"])
        return fa.FWD_ROUTES[code]
    return route


@pytest.mark.parametrize("head_dim", range(8, fa.MAX_HEAD_DIM + 1, 8))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_route_matches_the_kernel_source(dtype, head_dim):
    want = ("fp32" if dtype == torch.float32
            else "wgmma" if head_dim >= 64 else "mma_sync")
    got = fa.attention_fwd_route(dtype, head_dim)
    assert got == want == _source_route()(dtype, head_dim)
    assert got in fa.FWD_ROUTES


@pytest.mark.parametrize("head_dim", range(8, fa.MAX_HEAD_DIM + 1, 8))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_dropout_forward_counts_its_route(dtype, head_dim, monkeypatch):
    """flash_attention_drop_fwd counts a CUDA call on the route
    attention_fwd_route names (the counting helper it calls, called here
    directly: the kernel does not run on the CPU), and on no other."""
    for name in ROUTE_COUNTERS:
        monkeypatch.setattr(fa, name, 0)
    fa._count_fwd_route(dtype, head_dim)
    route = fa.attention_fwd_route(dtype, head_dim)
    assert {name: getattr(fa, name) for name in ROUTE_COUNTERS} == {
        name: int(name == fa._FWD_COUNTERS[route]) for name in ROUTE_COUNTERS}
    assert "_count_fwd_route(q.dtype, D)" in inspect.getsource(
        fa.flash_attention_drop_fwd)


def test_route_codes_are_the_backward_ones():
    """attention.cu and attention_train.cu number the three routes alike,
    and both wgmma routes start at head dim 64."""
    fwd = SOURCE.read_text()
    bwd = SOURCE.with_name("attention_train.cu").read_text()
    assert re.findall(r"kRoute(\w+) = (\d)", fwd) == \
        re.findall(r"kRoute(\w+) = (\d)", bwd)
    assert fa.FWD_ROUTES == fa.BWD_ROUTES
    assert _wgmma_min_head_dim(bwd) == fa.WGMMA_HEAD_DIM
    assert _wgmma_min_head_dim(fwd) == fa.WGMMA_HEAD_DIM


@pytest.mark.parametrize("head_dim", [0, -8, 12, 60, 136, 256])
def test_route_rejects_head_dims_the_kernels_refuse(head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.attention_fwd_route(torch.bfloat16, head_dim)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8],
                         ids=str)
def test_route_rejects_dtypes_the_kernels_refuse(dtype):
    with pytest.raises(TypeError, match="dtype"):
        fa.attention_fwd_route(dtype, 64)


def _randn(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _forward_calls(b, n, heads, d, dtype):
    """-> {name: (wrapper call, plain call)} of every forward entry on one
    seeded (B, N, 3C) qkv: packed, separate with v strided, int8 out with
    keys masked, dropout with a mask."""
    C = heads * d
    scale = d ** -0.5
    qkv = _randn((b, n, 3 * C), d + n, dtype)
    q, k, v = qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(), \
        qkv[..., 2 * C:]
    out_amax = fa.flash_attention_qkv_plain(qkv, heads, scale).float(
        ).abs().max()
    mask = torch.from_numpy(np.random.default_rng(n).random(
        (b, heads, n, n)) >= 0.1).to(torch.int8)
    sep = (q, k, v, heads, scale)
    return {
        "A1": (lambda: fa.flash_attention_qkv(qkv, heads, scale),
               lambda: fa.flash_attention_qkv_plain(qkv, heads, scale)),
        "A1-sep": (lambda: fa.flash_attention(*sep),
                   lambda: fa.flash_attention_plain(*sep)),
        "C1": (lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
               lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                            scale)),
        "C3-fwd": (lambda: fa.flash_attention_fwd_lse(*sep),
                   lambda: fa.flash_attention_fwd_lse_plain(*sep)),
        "B3": (lambda: fa.flash_attention_qkv_q8(qkv, heads, scale,
                                                 out_amax),
               lambda: fa.flash_attention_qkv_q8_plain(qkv, heads, scale,
                                                       out_amax)),
        "B3-sep": (lambda: fa.flash_attention_q8(*sep, out_amax, n - 3),
                   lambda: fa.flash_attention_q8_plain(*sep, out_amax,
                                                       n - 3)),
        "C4-fwd": (lambda: fa.flash_attention_drop_fwd(*sep, 0.1, mask=mask),
                   lambda: fa.flash_attention_drop_fwd_plain(*sep, 0.1,
                                                             mask=mask)),
    }


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_cpu_forward_takes_the_plain_version_on_no_route(dtype, d):
    """On CPU tensors every forward wrapper returns its plain version's
    result and no route counter moves."""
    for name, (wrapper, plain) in _forward_calls(2, 65, 2, d, dtype).items():
        before = [getattr(fa, c) for c in ROUTE_COUNTERS]
        got, want = wrapper(), plain()
        assert [getattr(fa, c) for c in ROUTE_COUNTERS] == before, name
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name
