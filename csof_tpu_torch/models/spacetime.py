"""Spatio-temporal attention over cine sequences (port of
``csof_tpu/models/spacetime.py``): factorized time-then-space attention
over (T, H, W) token grids, FinalFlow's ``bottleneck_type="transformer"``.

Tokens are channels last, ``(B, T, H, W, C)``, batched over videos where the
JAX module takes one ``(T, H, W, C)`` video. ``MultiHeadDotProductAttention``
is flax's (``nn.MultiHeadDotProductAttention`` with ``qkv_features=dim``):
``query``/``key``/``value`` projections to (heads, head_dim), the query
divided by sqrt(head_dim) in the dtype, the softmax in the dtype, and the
``out`` projection back, each a ``Dense`` whose flax kernel
:mod:`csof_tpu_torch.compat.flax_import` flattens.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.attention import sine_pos_embed_2d
from csof_tpu_torch.models.blocks import Dense, LayerNorm, scalar_in


@functools.lru_cache(maxsize=None)
def sine_pos_embed_1d(t: int, dim: int, temperature: float = 10000.0,
                      device=None) -> torch.Tensor:
    """(t, dim) fixed 1D sine/cosine embedding, float32, zero-padded to dim
    (cached per shape and device; callers must not modify it)."""
    half = dim // 2
    omega = 1.0 / (temperature ** (np.arange(half) / half))
    ang = np.arange(t)[:, None] * omega[None]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if emb.shape[1] < dim:
        emb = np.pad(emb, ((0, 0), (0, dim - emb.shape[1])))
    return torch.from_numpy(emb.astype(np.float32)).to(device)


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads, self.compute_dtype = num_heads, dtype
        # flax's DenseGeneral kernels split the heads off: (dim, heads, head_dim)
        # and (heads, head_dim, dim); the converter flattens them into these
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim, dtype, generator))

    def forward(self, x, kv=None):
        """Attention from the tokens of x (..., L, C) to those of ``kv``
        (..., S, C), by default x itself -> (..., L, C)."""
        dt = self.compute_dtype
        kv = x if kv is None else kv
        *lead, length, c = x.shape
        nh = self.num_heads

        def heads(t):  # (..., L, C) -> (..., heads, L, hd)
            return t.reshape(*t.shape[:-1], nh, c // nh).transpose(-2, -3)

        q = heads(self.query(x)) / scalar_in(float(np.sqrt(c // nh)), dt)
        k, v = heads(self.key(kv)), heads(self.value(kv))
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), -1).to(dt)
        attn = torch.matmul(weights, v).transpose(-2, -3).reshape(*lead, length, c)
        return self.out(attn)


class SpatioTemporalBlock(nn.Module):
    """One factorized block: temporal MSA -> spatial MSA -> MLP (pre-norm,
    residual)."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.compute_dtype = dtype
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.temporal_attn = MultiHeadDotProductAttention(dim, num_heads, dtype, generator)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.spatial_attn = MultiHeadDotProductAttention(dim, num_heads, dtype, generator)
        self.LayerNorm_2 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, int(dim * mlp_ratio), dtype, generator)
        self.Dense_1 = Dense(int(dim * mlp_ratio), dim, dtype, generator)

    def forward(self, x):
        """x (B, T, H, W, C)."""
        dt = self.compute_dtype
        b, t, h, w, c = x.shape
        y = self.LayerNorm_0(x)
        yt = y.reshape(b, t, h * w, c).transpose(1, 2)  # (B, HW, T, C)
        yt = yt + sine_pos_embed_1d(t, c, device=x.device).to(dt)
        at = self.temporal_attn(yt)
        x = x + at.transpose(1, 2).reshape(b, t, h, w, c)
        y = self.LayerNorm_1(x)
        ys = y.reshape(b, t, h * w, c) + sine_pos_embed_2d(h, w, c, device=x.device).to(dt)
        x = x + self.spatial_attn(ys).reshape(b, t, h, w, c)
        z = F.gelu(self.Dense_0(self.LayerNorm_2(x)), approximate="tanh")
        return x + self.Dense_1(z)


class SpatioTemporalTransformer(nn.Module):
    """(B, T, H, W, C_in) -> (B, T, H, W, dim): a Dense to dim where C_in
    differs, then ``depth`` blocks."""

    def __init__(self, in_dim: int, dim: int, depth: int = 2, num_heads: int = 4,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.depth = depth
        if in_dim != dim:
            self.Dense_0 = Dense(in_dim, dim, dtype, generator)
        for i in range(depth):
            self.add_module(f"SpatioTemporalBlock_{i}",
                            SpatioTemporalBlock(dim, num_heads, dtype=dtype, generator=generator))

    def forward(self, x):
        if hasattr(self, "Dense_0"):
            x = self.Dense_0(x)
        for i in range(self.depth):
            x = getattr(self, f"SpatioTemporalBlock_{i}")(x)
        return x
