"""Transformer building blocks of the video ViT, in PyTorch.

Port of simple_tad_tpu/models/layers.py.  Parameters carry the reference's
torch names (``norm1.weight``, ``attn.qkv.weight``, ``attn.q_bias``,
``mlp.fc1.weight``, ``patch_embed.proj.weight``, ...) so a released
``.pth`` loads by name.  Parameters are stored in the dtype the JAX
package computes them in: Linear weights and biases, ``q_bias``/``v_bias``
and LayerScale gammas in the compute dtype; LayerNorm parameters and the
patch-embed bias in fp32.  Nothing is initialised at construction
(``torch.empty``); ``init_weights`` fills every parameter from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simple_tad_tpu_torch.ops.attention import dot_product_attention_qkv
from simple_tad_tpu_torch.ops.ln import layernorm


def gelu_for(dtype):
    """Exact erf GELU at fp32; tanh approximation at bf16 (the JAX
    package's choice, layers.py:gelu_for)."""
    if dtype == torch.bfloat16:
        return lambda x: F.gelu(x, approximate="tanh")
    return F.gelu


def sincos_pos_embed(n_position: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table, float64 math then float32, shape
    (1, n_position, dim): angle(pos, j) = pos / 10000^(2*(j//2)/dim), even
    dims sin, odd dims cos."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(dim, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * np.floor(j / 2.0) / dim)
    table = np.empty((n_position, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def trunc_normal(shape, std: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """fp32 CPU sample of std * N(0, 1) truncated to [-2, 2] (inverse CDF)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) * std).float()


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """y = x W^T + b with reference-named ``weight`` (out, in) and ``bias``."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _param((out_dim, in_dim), dtype, device)
        self.bias = _param((out_dim,), dtype, device) if bias else None

    def init_weights(self, generator, std: float = 0.02):
        with torch.no_grad():
            self.weight.copy_(trunc_normal(self.weight.shape, std, generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNormFp32(nn.Module):
    """LayerNorm with fp32 statistics and fp32 ``weight``/``bias``; the
    output is cast to ``dtype``.  Routes through ops/ln.py."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def init_weights(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layernorm(x, self.weight, self.bias, self.eps,
                         out_dtype=self.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU (erf at fp32, tanh at bf16) -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Linear(hidden_dim, dim, dtype=dtype, device=device)
        self.act = gelu_for(dtype)

    def init_weights(self, generator):
        self.fc1.init_weights(generator)
        self.fc2.init_weights(generator)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    """Packed-qkv multi-head attention: one bias-free ``qkv`` projection,
    then ``q_bias | 0 | v_bias`` added in the compute dtype, then
    ops/attention.py, then ``proj``."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 qk_scale=None, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype,
                          device=device)
        if qkv_bias:
            self.q_bias = _param((dim,), dtype, device)
            self.v_bias = _param((dim,), dtype, device)
        else:
            self.q_bias = self.v_bias = None
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    def init_weights(self, generator):
        self.qkv.init_weights(generator)
        self.proj.init_weights(generator)
        if self.q_bias is not None:
            with torch.no_grad():
                self.q_bias.zero_()
                self.v_bias.zero_()

    def forward(self, x):
        qkv = self.qkv(x)
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias])
        out = dot_product_attention_qkv(qkv, num_heads=self.num_heads,
                                        scale=self.scale)
        return self.proj(out)


class Block(nn.Module):
    """Pre-LN block with optional LayerScale (DropPath is identity at eval):
    x = x + gamma_1 * Attn(LN1(x));  x = x + gamma_2 * MLP(LN2(x))."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale=None,
                 init_values: float = 0.0, norm_eps: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.init_values = init_values
        self.norm1 = LayerNormFp32(dim, norm_eps, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, dtype=dtype, device=device)
        self.norm2 = LayerNormFp32(dim, norm_eps, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        if init_values > 0:
            self.gamma_1 = _param((dim,), dtype, device)
            self.gamma_2 = _param((dim,), dtype, device)
        else:
            self.gamma_1 = self.gamma_2 = None

    def init_weights(self, generator):
        self.norm1.init_weights()
        self.norm2.init_weights()
        self.attn.init_weights(generator)
        self.mlp.init_weights(generator)
        if self.gamma_1 is not None:
            with torch.no_grad():
                self.gamma_1.fill_(self.init_values)
                self.gamma_2.fill_(self.init_values)

    def forward(self, x):
        a = self.attn(self.norm1(x))
        if self.gamma_1 is not None:
            a = a * self.gamma_1
        x = x + a
        m = self.mlp(self.norm2(x))
        if self.gamma_2 is not None:
            m = m * self.gamma_2
        return x + m


class PatchEmbed(nn.Module):
    """Tubelet patch embedding as a reshape plus one matmul.

    ``proj.weight`` keeps the reference Conv3d shape (D, C, t, p, p) and
    ``proj.bias`` (D,).  The conv has stride == kernel, so it is exactly a
    projection of non-overlapping (t, p, p) tubelets flattened in
    (t, h, w, c) order: ``matrix()`` is that (t*p*p*c, D) kernel.  Input is
    channels-last (B, T, H, W, C); tokens come out (t-slot, h, w)-ordered.
    """

    def __init__(self, embed_dim: int, patch_size: int = 16,
                 tubelet_size: int = 2, in_chans: int = 3, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.tubelet_size = tubelet_size
        self.dtype = dtype
        self.proj = nn.Module()
        self.proj.weight = _param(
            (embed_dim, in_chans, tubelet_size, patch_size, patch_size),
            dtype, device)
        self.proj.bias = _param((embed_dim,), torch.float32, device)

    def init_weights(self, generator):
        """lecun_normal over fan_in = t*p*p*c (flax's default init)."""
        w = self.proj.weight
        fan_in = w[0].numel()
        with torch.no_grad():
            w.copy_(trunc_normal(w.shape, 1.0 / math.sqrt(fan_in), generator)
                    / 0.87962566103423978)
            self.proj.bias.zero_()

    def matrix(self) -> torch.Tensor:
        """(t*p*p*c, D) kernel over (t, h, w, c)-ordered patch rows."""
        return patch_matrix(self.proj.weight)

    def forward(self, x):
        return embed_tubelets(x, self.matrix(), self.proj.bias,
                              self.patch_size, self.tubelet_size, self.dtype)


def patch_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d patch weight (D, C, t, p, p) -> (t*p*p*c, D) matmul kernel."""
    return weight.permute(2, 3, 4, 1, 0).reshape(-1, weight.shape[0])


def embed_tubelets(x, kernel, bias, patch: int, tubelet: int, dtype):
    """(B, T, H, W, C) -> (B, T/t * H/p * W/p, D): tubelets flattened in
    (t, h, w, c) order, times ``kernel`` (t*p*p*c, D).  Inputs and kernel
    are rounded to ``dtype`` and the product accumulates in fp32 (the
    products of bf16 values are exact in fp32), plus the fp32 bias, then
    one cast to ``dtype``."""
    B, T, H, W, C = x.shape
    p, tb = patch, tubelet
    nt, nh, nw = T // tb, H // p, W // p
    x = x.reshape(B, nt, tb, nh, p, nw, p, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = x.reshape(B, nt * nh * nw, tb * p * p * C).to(dtype)
    y = torch.matmul(x.float(), kernel.to(dtype).float()) + bias.float()
    return y.to(dtype)
