"""Cross-attention bottleneck (port of ``csof_tpu/models/attention.py``).

Maps are NCHW; tokens are the H*W pixels in row-major order, as the JAX
``reshape(-1, C)`` of an (H, W, C) map orders them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Dense, LayerNorm, scalar_in


@functools.lru_cache(maxsize=None)
def sine_pos_embed_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                      device=None) -> torch.Tensor:
    """(h*w, dim) fixed 2D sine/cosine positional embedding, float32 (cached
    per shape and device; callers must not modify it)."""
    if dim % 4:
        raise ValueError("2D sine embedding needs dim % 4 == 0")
    quarter = dim // 4
    omega = 1.0 / (temperature ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for coord in (ys, xs):
        ang = coord.reshape(-1)[:, None] * omega[None, :]
        out.extend([np.sin(ang), np.cos(ang)])
    return torch.from_numpy(np.concatenate(out, axis=1).astype(np.float32)).to(device)


class CrossAttentionLayer(nn.Module):
    """Pre-norm cross-attention + FFN over flattened spatial tokens.

    A map whose width differs from d_model gets a token projection, as in
    flax; those projections take the first ``Dense_k`` names (query, key,
    value order), then the FFN takes the next two. The softmax is written out
    as the JAX code writes it, including its bfloat16 path, so the attention
    weights exist as a tensor: ``return_attn_map=True`` also returns the
    attention mass each key receives, averaged over heads and queries, as an
    (N, H, W) float32 map (the JAX layer's ``attn_weights`` sow).
    """

    def __init__(self, d_model: int, num_heads: int = 4, dim_feedforward: int = 1024,
                 dtype=torch.float32, widths: tuple[int, int, int] | None = None,
                 generator=None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.compute_dtype = dtype
        widths = widths or (d_model,) * 3
        self.proj_names: list[str | None] = []
        k = 0
        for width in widths:
            if width != d_model:
                self.add_module(f"Dense_{k}", Dense(width, d_model, dtype, generator))
                self.proj_names.append(f"Dense_{k}")
                k += 1
            else:
                self.proj_names.append(None)
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.q_proj = Dense(d_model, d_model, dtype, generator)
        self.k_proj = Dense(d_model, d_model, dtype, generator)
        self.v_proj = Dense(d_model, d_model, dtype, generator)
        self.out_proj = Dense(d_model, d_model, dtype, generator)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        self.ffn_names = (f"Dense_{k}", f"Dense_{k + 1}")
        self.add_module(self.ffn_names[0], Dense(d_model, dim_feedforward, dtype, generator))
        self.add_module(self.ffn_names[1], Dense(dim_feedforward, d_model, dtype, generator))

    def _tokens(self, m: torch.Tensor, i: int) -> torch.Tensor:
        t = m.flatten(2).transpose(1, 2).to(self.compute_dtype)  # (N, HW, C)
        name = self.proj_names[i]
        return t if name is None else getattr(self, name)(t)

    def forward(self, query_map, key_map, value_map, return_attn_map: bool = False):
        """(N, C, H, W) maps -> (N, d_model, H, W)."""
        n, _, h, w = query_map.shape
        dt = self.compute_dtype
        nh, hd = self.num_heads, self.d_model // self.num_heads
        pos = sine_pos_embed_2d(h, w, self.d_model, device=query_map.device).to(dt)
        q = self._tokens(query_map, 0) + pos
        k = self._tokens(key_map, 1) + pos
        v = self._tokens(value_map, 2)
        qn = self.LayerNorm_0(q)

        def heads(t):  # (N, L, d) -> (N, heads, L, hd)
            return t.view(n, -1, nh, hd).transpose(1, 2)

        qh, kh, vh = heads(self.q_proj(qn)), heads(self.k_proj(k)), heads(self.v_proj(v))
        if dt == torch.bfloat16:
            # reductions in float32, materialized tensors in bfloat16
            logits = torch.matmul(qh, kh.transpose(-1, -2)) / scalar_in(math.sqrt(hd), dt)
            mx = logits.float().amax(-1, keepdim=True)
            unnorm = torch.exp(logits - mx.to(logits.dtype))
            denom = unnorm.sum(-1, keepdim=True, dtype=torch.float32)
            weights = unnorm * (1.0 / denom).to(unnorm.dtype)
        else:
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            weights = torch.softmax(logits / math.sqrt(hd), dim=-1)
        attn = torch.matmul(weights.to(dt), vh).transpose(1, 2).reshape(n, h * w, self.d_model)
        x = q + self.out_proj(attn)
        y = self.LayerNorm_1(x)
        y = F.gelu(getattr(self, self.ffn_names[0])(y), approximate="tanh")
        x = x + getattr(self, self.ffn_names[1])(y)
        out = x.transpose(1, 2).reshape(n, self.d_model, h, w)
        if return_attn_map:  # the mean rounded to the weights' dtype, as jnp.mean rounds
            amap = weights.mean((1, 2), dtype=torch.float32).to(weights.dtype).float()
            return out, amap.view(n, h, w)
        return out
