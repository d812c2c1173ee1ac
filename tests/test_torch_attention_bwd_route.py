"""The training backward's route by dtype and head dim (kernels C2, C3-bwd
and C4-bwd, simple_tad_tpu_torch.ops.flash_attention.attention_bwd_route),
on the CPU.

bf16 at head dims 64 to 128 takes the wgmma kernels of
csrc/attention_train.cu, with or without dropout (C4-bwd in either keep
form), bf16 at head dims 8 to 56 the mma.sync kernels, fp32 the CUDA-core
kernels; the function
mirrors the source's dispatch (stt_attention_bwd_route on the card,
tests/test_torch_cuda.py).  A CPU tensor takes the plain version and
counts no launch on any route.  The dropout backward counts its call on
the route it takes, as the forward does.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simple_tad_tpu_torch.ops import flash_attention as fa

SOURCE = (Path(fa.__file__).resolve().parent.parent / "csrc"
          / "attention_train.cu")
ROUTE_COUNTERS = ("BWD_WGMMA_LAUNCHES", "BWD_MMA_LAUNCHES",
                  "BWD_F32_LAUNCHES")


@pytest.mark.parametrize("head_dim", range(8, fa.MAX_HEAD_DIM + 1, 8))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_route_by_dtype_and_head_dim(dtype, head_dim):
    want = ("fp32" if dtype == torch.float32
            else "wgmma" if head_dim >= 64 else "mma_sync")
    assert fa.attention_bwd_route(dtype, head_dim) == want
    assert want in fa.BWD_ROUTES


@pytest.mark.parametrize("head_dim", [0, -8, 12, 60, 136, 256])
def test_route_rejects_head_dims_the_kernels_refuse(head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.attention_bwd_route(torch.bfloat16, head_dim)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8],
                         ids=str)
def test_route_rejects_dtypes_the_kernels_refuse(dtype):
    with pytest.raises(TypeError, match="dtype"):
        fa.attention_bwd_route(dtype, 64)


def test_route_matches_the_kernel_source():
    """The route codes and the wgmma route's least head dim of
    csrc/attention_train.cu, and its route(), which takes no dropout
    argument: every keep form's dispatch takes the route of the call
    without dropout."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int route\(int dtype, int d\) \{\s*"
                     r"return dtype == stt::kFloat32 \? kRouteF32\s*"
                     r": d >= wg::kMinD\s*\? kRouteWgmma\s*"
                     r": kRouteMma;\s*\}", src)
    assert len(re.findall(r"if \(route\(dtype, d\) == kRouteWgmma\)",
                          src)) == 1
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
    assert [fa.BWD_ROUTES[int(codes[k])] for k in ("F32", "Mma", "Wgmma")
            ] == ["fp32", "mma_sync", "wgmma"]
    wg = src[src.index("namespace wg {"):]
    assert int(re.search(r"constexpr int kMinD = (\d+);", wg).group(1)) \
        == fa.WGMMA_HEAD_DIM


@pytest.mark.parametrize("head_dim", range(8, fa.MAX_HEAD_DIM + 1, 8))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_dropout_backward_counts_its_route(dtype, head_dim, monkeypatch):
    """flash_attention_drop_bwd counts a CUDA call on the route
    attention_bwd_route names (the counting helper it calls, called here
    directly: the kernel does not run on the CPU), and on no other."""
    for name in ROUTE_COUNTERS:
        monkeypatch.setattr(fa, name, 0)
    fa._count_bwd_route(dtype, head_dim)
    route = fa.attention_bwd_route(dtype, head_dim)
    assert {name: getattr(fa, name) for name in ROUTE_COUNTERS} == {
        name: int(name == fa._BWD_COUNTERS[route]) for name in ROUTE_COUNTERS}
    assert "_count_bwd_route(q.dtype, D)" in inspect.getsource(
        fa.flash_attention_drop_bwd)


def _operands(b, n, heads, d, dtype, seed):
    rng = np.random.default_rng(seed)
    C = heads * d
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * C)).astype(
        np.float32)).to(dtype)
    dout = torch.from_numpy(rng.standard_normal((b, n, C)).astype(
        np.float32)).to(dtype)
    return qkv, dout


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_cpu_backward_takes_the_plain_version_on_no_route(dtype, d):
    """On CPU tensors both wrappers return the plain versions' results and
    no route counter moves."""
    heads, scale = 2, d ** -0.5
    qkv, dout = _operands(2, 65, heads, d, dtype, d)
    C = heads * d
    out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
    before = [getattr(fa, name) for name in ROUTE_COUNTERS]
    got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads, scale)
    views = (qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:])
    sep = fa.flash_attention_bwd(*views, out, lse, dout, heads, scale)
    assert [getattr(fa, name) for name in ROUTE_COUNTERS] == before
    assert torch.equal(got, fa.flash_attention_qkv_bwd_plain(
        qkv, out, lse, dout, heads, scale))
    assert torch.equal(torch.cat(sep, -1), got)
