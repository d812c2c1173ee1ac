"""The int8 attentions' routes by head dim, on the CPU: B2 and D2
(csrc/attention_i8.cu; simple_tad_tpu_torch.ops.flash_attention.
attention_i8_route) and E2 (csrc/attention_int8.cu; attention_int8_route).

B2 and D2: at head dims 64 to 128 (multiples of 8, read in place; 56 the
wrappers pad to 64) a CUDA call takes the wgmma kernel, below that (padded
to 16, 32 or 48) the mma.sync kernel.  E2: where the head dim the kernel is
given (the wrapper zero-pads a multiple of 8 to the next multiple of 16) is
64, the wgmma kernel; at 16, 32 and 48 the mma.sync kernel.  The functions
mirror the sources' route() (stt_attention_i8_route and
stt_attention_int8_route on the card, tests/test_torch_cuda.py).  A CPU
tensor takes the plain version and counts no launch on any route.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simple_tad_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
ROUTE_COUNTERS = ("I8_WGMMA_LAUNCHES", "I8_MMA_LAUNCHES",
                  "INT8_WGMMA_LAUNCHES", "INT8_MMA_LAUNCHES")
# each source: route() as it spells it, the wgmma head dim's name in its
# namespace wg and how route() compares the head dim with it, the check of
# the head dims its entry point and route query refuse, and how often
# that check is spelled
SOURCES = {
    "attention_i8.cu": (
        r"constexpr int route\(int d\) \{\s*"
        r"return d >= wg::kMinD \? kRouteWgmma : kRouteMma;\s*\}",
        "kMinD", ">=",
        r"d > 0 && d <= 128 && d % \(d < wg::kMinD \? 16 : 8\) == 0", 1,
        r"!head_dim_ok\(d\)", 2),
    "attention_int8.cu": (
        r"constexpr int route\(int d\) \{\s*"
        r"return d == wg::kD \? kRouteWgmma : kRouteMma;\s*\}",
        "kD", "==", r"d % 16 != 0 \|\| d > 64", 2, None, 0)}
DISPATCH_EXPR = r"if \(route\(d\) == kRouteWgmma\)"


def _wgmma_dim(name):
    src = (CSRC / name).read_text()
    wg = src[src.index("namespace wg {"):]
    const = SOURCES[name][1]
    return int(re.search(rf"constexpr int {const} = (\d+);", wg).group(1))


def _source_route(name):
    """-> route(d) of csrc/``name`` as a Python function returning the
    route's name (fa.FWD_ROUTES of its code), from the source's codes and
    wgmma head dim."""
    route_expr, _, op, refused, n_refused, called, n_called = SOURCES[name]
    src = (CSRC / name).read_text()
    assert re.search(route_expr, src), f"{name}: route() reads otherwise"
    assert len(re.findall(DISPATCH_EXPR, src)) == 1, \
        f"{name}: the entry point no longer dispatches through route()"
    assert len(re.findall(refused, src)) == n_refused, \
        f"{name}: the head dims refused read otherwise"
    if called:
        assert len(re.findall(called, src)) == n_called, \
            f"{name}: the entry point and its route query refuse otherwise"
    codes = {k: int(v) for k, v in re.findall(r"kRoute(\w+) = (\d)", src)}
    kd = _wgmma_dim(name)

    def route(d):
        wide = d >= kd if op == ">=" else d == kd
        return fa.FWD_ROUTES[codes["Wgmma"] if wide else codes["Mma"]]
    return route


def test_route_codes_are_the_forward_ones():
    """Both sources number their two routes as attention.cu does, and both
    wgmma routes start at head dim 64."""
    fwd = dict(re.findall(r"kRoute(\w+) = (\d)",
                          (CSRC / "attention.cu").read_text()))
    for name in SOURCES:
        src = (CSRC / name).read_text()
        codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
        assert codes == {k: fwd[k] for k in ("Mma", "Wgmma")}, name
        assert _wgmma_dim(name) == fa.WGMMA_HEAD_DIM, name


@pytest.mark.parametrize("head_dim", range(8, fa.MAX_HEAD_DIM + 1, 8))
def test_i8_route_matches_the_kernel_source(head_dim):
    """B2 and D2: every head dim D2 takes (B2 the multiples of 16 among
    them), on the head dim the kernel is given (attention_i8_head_dim:
    below 64 padded to a multiple of 16, from 64 on as it is)."""
    dim = fa.attention_i8_head_dim(head_dim)
    assert dim == (head_dim if head_dim >= 64 else -(-head_dim // 16) * 16)
    got = fa.attention_i8_route(head_dim)
    assert got == ("wgmma" if head_dim >= 56 else "mma_sync")
    assert got == _source_route("attention_i8.cu")(dim)


@pytest.mark.parametrize("head_dim", range(8, fa.INT8_MAX_HEAD_DIM + 1, 8))
def test_int8_route_matches_the_kernel_source(head_dim):
    """E2: 16, 32 and 48 (and 8, 24, 40 padded to them) on mma.sync, 64
    (and 56) on wgmma."""
    padded = -(-head_dim // 16) * 16
    got = fa.attention_int8_route(head_dim)
    assert got == ("wgmma" if padded == 64 else "mma_sync")
    assert got == _source_route("attention_int8.cu")(padded)


@pytest.mark.parametrize("head_dim", [0, -8, 12, 60, 136, 256])
def test_i8_route_rejects_head_dims_the_kernels_refuse(head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.attention_i8_route(head_dim)


@pytest.mark.parametrize("head_dim", [0, -16, 12, 72, 80, 128])
def test_int8_route_rejects_head_dims_the_kernel_refuses(head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.attention_int8_route(head_dim)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _amax(heads, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.5, 4.0, (3, heads)).astype(
        np.float32))


def _int8_calls(b, n, heads, d):
    """-> {name: (wrapper call, plain call)} of B2, D2 (v strided, keys
    masked) and E2 on one seeded int8 qkv."""
    C = heads * d
    scale = d ** -0.5
    qkv = _codes((b, n, 3 * C), d + n)
    amax = _amax(heads, n)
    q, k, v = qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(), \
        qkv[..., 2 * C:]
    out_amax = fa.attention_i8_plain_f32(qkv, amax, heads, scale).abs().max()
    sep = (q, k, v, amax, heads, scale, out_amax, n - 3)
    calls = {
        "D2": (lambda: fa.flash_attention_i8d(*sep),
               lambda: fa.flash_attention_i8d_plain(*sep))}
    if d % 16 == 0:
        calls["B2"] = (
            lambda: fa.flash_attention_qkv_i8d(qkv, amax, heads, scale,
                                               out_amax),
            lambda: fa.flash_attention_qkv_i8d_plain(qkv, amax, heads, scale,
                                                     out_amax))
    if d <= fa.INT8_MAX_HEAD_DIM:
        calls["E2"] = (
            lambda: fa.flash_attention_qkv_int8(qkv, amax, heads, scale),
            lambda: fa.flash_attention_qkv_int8_plain(qkv, amax, heads,
                                                      scale))
    return calls


@pytest.mark.parametrize("d", [32, 56, 64, 80, 88])
def test_cpu_calls_take_the_plain_version_on_no_route(d):
    """On CPU tensors B2, D2 and E2 return their plain version's result,
    and no launch or route counter moves."""
    counters = ROUTE_COUNTERS + ("I8_LAUNCHES", "I8_SEP_LAUNCHES",
                                 "INT8_LAUNCHES")
    for name, (wrapper, plain) in _int8_calls(2, 67, 2, d).items():
        before = [getattr(fa, c) for c in counters]
        got, want = wrapper(), plain()
        assert [getattr(fa, c) for c in counters] == before, name
        assert torch.equal(got, want), name
