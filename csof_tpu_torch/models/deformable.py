"""Deformable attention, Deformable-DETR style (port of
``csof_tpu/models/deformable.py``): each query predicts, per head,
``num_points`` sampling offsets and softmax weights, and sums the values
sampled bilinearly (border padding) at its reference point plus each
offset, O(HW x points) where dense attention is O((HW)^2).

Maps are channels last and batched, ``(N, H, W, C)`` (or one ``(H, W, C)``
map each, as the JAX module takes). ``offsets`` and ``weights`` run in
float32; the reference points are the query's pixel (y, x) scaled to the
value map, ``identity_grid((h, w)) * [hv / h, wv / w]``; the sampler is
the port's ``grid_sample`` (the JAX sampler's four corners, indices
clamped at the border), in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Dense, LayerNorm
from csof_tpu_torch.ops.warp import grid_sample, identity_grid


class DeformableAttention2D(nn.Module):
    """Queries ``dim`` wide (the layer's), values ``value_dim`` wide."""

    def __init__(self, value_dim: int, dim: int, num_heads: int = 4, num_points: int = 4,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dim, self.num_heads, self.num_points = dim, num_heads, num_points
        self.compute_dtype = dtype
        self.Dense_0 = Dense(dim, dim, dtype, generator)
        self.Dense_1 = Dense(value_dim, dim, dtype, generator)
        self.offsets = Dense(dim, num_heads * num_points * 2, torch.float32, generator)
        with torch.no_grad():  # flax: kernel zeros, bias normal(1.0)
            self.offsets.weight.zero_()
            self.offsets.bias.normal_(0.0, 1.0, generator=generator)
        self.weights = Dense(dim, num_heads * num_points, torch.float32, generator)
        self.Dense_2 = Dense(dim, dim, dtype, generator)

    def forward(self, query_map: torch.Tensor, value_map: torch.Tensor) -> torch.Tensor:
        """query_map (N, H, W, Cq), value_map (N, Hv, Wv, Cv) -> (N, H, W, dim)."""
        n, h, w, _ = query_map.shape
        _, hv, wv, _ = value_map.shape
        nh, npt, hd = self.num_heads, self.num_points, self.dim // self.num_heads
        q = self.Dense_0(query_map)
        v = self.Dense_1(value_map)
        off = self.offsets(q.float()).reshape(n, h, w, nh, npt, 2)
        wgt = torch.softmax(self.weights(q.float()).reshape(n, h, w, nh, npt), dim=-1)
        scale = torch.tensor([hv / h, wv / w], dtype=torch.float32, device=q.device)
        ref = identity_grid((h, w), device=q.device) * scale
        pts = ref[None, :, :, None, None, :] + off  # (N, H, W, heads, points, 2)
        # every head's values as one image of the batch: (N * heads, hd, Hv, Wv)
        images = v.float().reshape(n, hv, wv, nh, hd).permute(0, 3, 4, 1, 2).reshape(
            n * nh, hd, hv, wv)
        coords = pts.permute(0, 3, 1, 2, 4, 5).reshape(n * nh, h, w * npt, 2)
        sampled = grid_sample(images, coords, mode="bilinear", padding="border")
        sampled = sampled.reshape(n, nh, hd, h, w, npt)
        out = (sampled * wgt.permute(0, 3, 1, 2, 4)[:, :, None]).sum(-1)  # (N, heads, hd, H, W)
        out = out.permute(0, 3, 4, 1, 2).reshape(n, h, w, self.dim).to(self.compute_dtype)
        return self.Dense_2(out)


class DeformableTransformerLayer(nn.Module):
    """Pre-norm deformable cross-attention and a tanh-GELU FFN, each with a
    residual; a Dense to ``dim`` first where the query's width differs."""

    def __init__(self, query_dim: int, value_dim: int, dim: int, num_heads: int = 4,
                 num_points: int = 4, dim_feedforward: int = 512, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.project = query_dim != dim
        first = 1 if self.project else 0  # flax numbers the projection Dense_0
        if self.project:
            self.Dense_0 = Dense(query_dim, dim, dtype, generator)
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.DeformableAttention2D_0 = DeformableAttention2D(value_dim, dim, num_heads,
                                                             num_points, dtype, generator)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.ffn = (f"Dense_{first}", f"Dense_{first + 1}")
        self.add_module(self.ffn[0], Dense(dim, dim_feedforward, dtype, generator))
        self.add_module(self.ffn[1], Dense(dim_feedforward, dim, dtype, generator))

    def forward(self, query_map: torch.Tensor, value_map: torch.Tensor) -> torch.Tensor:
        """(N, H, W, Cq) queries, (N, Hv, Wv, Cv) values, or one map each."""
        single = query_map.dim() == 3
        if single:
            query_map, value_map = query_map[None], value_map[None]
        x = self.Dense_0(query_map) if self.project else query_map
        x = x + self.DeformableAttention2D_0(self.LayerNorm_0(x), value_map)
        z = F.gelu(getattr(self, self.ffn[0])(self.LayerNorm_1(x)), approximate="tanh")
        x = x + getattr(self, self.ffn[1])(z)
        return x[0] if single else x
