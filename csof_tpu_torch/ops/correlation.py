"""Correlation volumes (port of ``csof_tpu/ops/correlation.py``): SegFlow's
local correlation volume, and RAFT's all-pairs volume, its pyramid and the
window lookup.

``local_correlation_volume`` is ``local_correlation_volume`` with
``q_cm=m_cm=out_cm=True``:

    out[b, kk, h, w] = <q[b, :, h, w], m[b, :, h + s*dy, w + s*dx]> / sqrt(C)

over the (2r+1)^2 window, kk = (dy + r)(2r + 1) + (dx + r), zero outside the
image, accumulated in float32 and returned in the input dtype. Differentiable
in q and m.

RAFT's three functions are batched over pairs, where the JAX package takes
one pair: the all-pairs volume is one float32 product (outside any Pallas
kernel in the JAX package, so a library product here), its pyramid 2x2
average pools of the target dims, and the lookup zero-padded bilinear
sampling of a (2r+1)^2 window a level, as ``lookup_correlation_gather``
computes it (a window that leaves the volume in part or in whole reads
zeros), by ``F.grid_sample``. The JAX package's default lookup, the MXU
two-hot selector form, computes the same and is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels.corr import CorrFunction


def local_correlation_volume(
    query: torch.Tensor, memory: torch.Tensor, radius: int = 4, stride: int = 1
) -> torch.Tensor:
    """query, memory: (B, C, H, W) -> (B, (2r+1)^2, H, W).

    CUDA tensors run kernel K1 forward and K2 backward; CPU tensors run their
    plain versions (:class:`CorrFunction`)."""
    return CorrFunction.apply(query, memory, radius, stride)


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) x 2 -> (N, H, W, H, W) float32:
    corr[n, h, w, h', w'] = <f1[n, :, h, w], f2[n, :, h', w']> / sqrt(C)."""
    n, c, h, w = f1.shape
    corr = torch.matmul(f1.float().flatten(2).transpose(1, 2), f2.float().flatten(2))
    return corr.view(n, h, w, h, w) / math.sqrt(c)


def correlation_pyramid(corr: torch.Tensor, num_levels: int = 4) -> list[torch.Tensor]:
    """The (N, H, W, H, W) volume and its target dims average-pooled 2x2
    (floor), num_levels - 1 times: [(N, H, W, H/2^l, W/2^l)]; a level
    pooled below one pixel is empty, as JAX's VALID window gives it."""
    n, h, w = corr.shape[:3]
    levels = [corr]
    cur = corr.reshape(n * h * w, 1, *corr.shape[3:])
    for _ in range(num_levels - 1):
        if min(cur.shape[2:]) >= 2:
            cur = F.avg_pool2d(cur, 2)
        else:
            cur = cur[:, :, :cur.shape[2] // 2, :cur.shape[3] // 2]
        levels.append(cur.reshape(n, h, w, *cur.shape[2:]))
    return levels


def _exact_size(n: int) -> int:
    """2^k + 1 >= n (2 for n <= 2): grid_sample's align_corners=True scale
    (size - 1) / 2 is then a power of two, so that a pixel coordinate goes
    to the normalized one and back exactly, and an integer one keeps its
    floor (and the cell its gradient takes) on every device."""
    return 2 ** max(1, math.ceil(math.log2(max(n - 1, 1)))) + 1 if n > 2 else 2


def lookup_correlation(pyramid: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """Each level sampled in a (2r+1)^2 window around ``coords`` / 2^level:
    pyramid [(N, H, W, Hl, Wl)], coords (N, H, W, 2) in level-0 pixels, (y,
    x) -> (N, L (2r+1)^2, H, W) float32, the window (dy, dx) dy-major within
    a level. One ``F.grid_sample`` a level, each query's volume a one-channel
    image zero-padded to ``_exact_size``, zero padding beyond it."""
    n, h, w = coords.shape[:3]
    q = n * h * w
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[3], corr.shape[4]
        if hl == 0 or wl == 0:  # an empty level: every window reads zeros
            out.append(coords.new_zeros((n, h, w, k * k)))
            continue
        sy, sx = _exact_size(hl), _exact_size(wl)
        vol = F.pad(corr.reshape(q, 1, hl, wl), (0, sx - wl, 0, sy - hl))
        c = coords.reshape(q, 1, 1, 2).float() / (2.0 ** lvl)
        # pixel p -> p * 2 / (size - 1) - 1, in grid_sample's (x, y) order
        gx = (c[..., 1] + d[None, None, :]) * (2.0 / (sx - 1)) - 1.0  # (q, 1, K)
        gy = (c[..., 0] + d[None, :, None]) * (2.0 / (sy - 1)) - 1.0  # (q, K, 1)
        grid = torch.stack(torch.broadcast_tensors(gx, gy), -1)  # (q, K, K, 2)
        val = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        out.append(val.view(n, h, w, k * k))
    return torch.cat(out, -1).permute(0, 3, 1, 2)
