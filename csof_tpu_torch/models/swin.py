"""Swin transformer blocks: window attention with a relative position bias,
shifted windows, patch merging (port of ``csof_tpu/models/swin.py``).

Channels last, batched over a leading axis: maps are ``(N, H, W, C)``
where the JAX functions take one ``(H, W, C)`` map and their callers
``vmap`` them. As in JAX:

- the attention logits are float32 (JAX's ``preferred_element_type``: the
  products of the dtype's q and k summed in float32), divided by
  sqrt(head_dim), biased and masked in float32, and the softmax runs in
  float32 before the cast to the dtype;
- a shifted window's mask is additive, -1e9 between tokens of other
  regions (not -inf), and the map is rolled by (-shift, -shift) before the
  attention and by (+shift, +shift) after;
- ``PatchMerging`` concatenates each 2 x 2 patch in the order
  ``reshape(h/2, 2, w/2, 2, c).transpose(0, 2, 1, 3, 4)``: (0, 0), (0, 1),
  (1, 0), (1, 1) by (row, column), which is not torchvision's order;
- the MLP uses the exact (erf) GELU; flax's ``LayerNorm`` has eps 1e-6.

Submodules carry flax's names (``Dense_0``, ``LayerNorm_1``,
``WindowAttention_0``, ``SwinBlock_k``), and ``rel_pos_bias`` is the flax
table itself, ((2w-1)^2, heads), so
:func:`csof_tpu_torch.compat.flax_import.load_flax_params` loads a flax tree.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import _TRUNC_STD, Dense, LayerNorm


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, num_windows, window * window, C), windows in
    row-major order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // window, window, w // window, window, c)
    return x.transpose(2, 3).reshape(n, -1, window * window, c)


def window_unpartition(wins: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    n, c = wins.shape[0], wins.shape[-1]
    x = wins.reshape(n, h // window, w // window, window, window, c)
    return x.transpose(2, 3).reshape(n, h, w, c)


def relative_position_index(window: int) -> np.ndarray:
    """(window^2, window^2) index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(h: int, w: int, window: int, shift: int,
                        device=None) -> torch.Tensor:
    """(num_windows, N, N) float32 additive mask of the shifted windows of
    an (h, w) map: 0 within a region, -1e9 across regions (cached per shape
    and device; callers must not modify it)."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    wins = window_partition(torch.from_numpy(img_mask)[None, :, :, None], window)[0, ..., 0]
    diff = wins[:, :, None] - wins[:, None, :]
    return torch.where(diff == 0, 0.0, -1e9).to(device)


class WindowAttention(nn.Module):
    """Multi-head attention within windows, with the learned relative
    position bias ``rel_pos_bias`` ((2w-1)^2, heads)."""

    def __init__(self, dim: int, num_heads: int, window: int, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.compute_dtype = dtype
        self.Dense_0 = Dense(dim, 3 * dim, dtype, generator)
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * window - 1) ** 2, num_heads))
        std = 0.02 / _TRUNC_STD  # flax's truncated_normal(0.02): cut at 2 stddevs
        with torch.no_grad():
            nn.init.trunc_normal_(self.rel_pos_bias, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        self.Dense_1 = Dense(dim, dim, dtype, generator)
        self.register_buffer("index", torch.from_numpy(
            relative_position_index(window).reshape(-1).astype(np.int64)), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (..., nW, N, C) windows; mask (nW, N, N) additive or None."""
        *lead, nw, n, c = x.shape
        nh, hd = self.num_heads, self.dim // self.num_heads
        qkv = self.Dense_0(x).reshape(*lead, nw, n, 3, nh, hd).movedim(-3, 0)
        q, k, v = (t.transpose(-2, -3) for t in qkv)  # (..., nW, heads, N, hd)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        bias = self.rel_pos_bias[self.index].reshape(n, n, nh).permute(2, 0, 1)
        attn = attn + bias
        if mask is not None:
            attn = attn + mask[:, None]
        attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
        out = torch.matmul(attn, v).transpose(-2, -3).reshape(*lead, nw, n, c)
        return self.Dense_1(out)


class SwinBlock(nn.Module):
    """W-MSA (``shift`` 0) or SW-MSA, then the MLP, each pre-norm with a
    residual; maps (N, H, W, C) with H and W divisible by ``window``."""

    def __init__(self, dim: int, num_heads: int, window: int = 8, shift: int = 0,
                 mlp_ratio: float = 4.0, dtype=torch.float32, generator=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, window, dtype, generator)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, int(dim * mlp_ratio), dtype, generator)
        self.Dense_1 = Dense(int(dim * mlp_ratio), dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        s = self.shift
        y = self.LayerNorm_0(x)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = shifted_window_mask(h, w, self.window, s, x.device)
        wins = self.WindowAttention_0(window_partition(y, self.window), mask)
        y = window_unpartition(wins, self.window, h, w)
        if s > 0:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y
        z = F.gelu(self.Dense_0(self.LayerNorm_1(x)))  # the exact (erf) GELU
        return x + self.Dense_1(z)


class SwinStage(nn.Module):
    """``depth`` blocks, every second one shifted by window // 2."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int = 8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            shift = 0 if i % 2 == 0 else window // 2
            self.add_module(f"SwinBlock_{i}", SwinBlock(dim, num_heads, window, shift,
                                                        dtype=dtype, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"SwinBlock_{i}")(x)
        return x


class PatchMerging(nn.Module):
    """2x downsampling: each 2 x 2 patch concatenated (JAX's order), then
    LayerNorm and a Dense to ``out_dim``."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * in_dim, dtype)
        self.Dense_0 = Dense(4 * in_dim, out_dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(2, 3).reshape(n, h // 2, w // 2, 4 * c)
        return self.Dense_0(self.LayerNorm_0(x))
