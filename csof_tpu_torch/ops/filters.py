"""Separable Gaussian smoothing over N-D tensors (port of
``csof_tpu/ops/filters.py``).

Each axis is edge-padded by the kernel radius and summed tap by tap
(``sum_j k[j] * x[..., j:j + n]``) in float32: plain elementwise products
and sums, no convolution call, so no device rounds it through TF32; the taps
are computed on the CPU and moved, so the card and the CPU sum the same
taps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> torch.Tensor:
    """The normalized float32 Gaussian of ``2 * radius + 1`` taps (radius
    ``max(1, ceil(3 sigma))`` unless given), on the CPU."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * float(sigma))))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / max(float(sigma), 1e-6)) ** 2)
    return k / torch.sum(k)


def gaussian_smooth(x: torch.Tensor, sigma, axes=None, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of ``x`` along ``axes`` (default: all) with
    edge padding; ``sigma`` a scalar or one per axis. Returns ``x``'s dtype."""
    if axes is None:
        axes = tuple(range(x.ndim))
    sigmas = list(sigma) if isinstance(sigma, (list, tuple)) else [sigma] * len(axes)
    out = x.to(torch.float32)
    for ax, s in zip(axes, sigmas):
        # the taps are made on the CPU, whose exp the card's need not round alike
        k = gaussian_kernel_1d(s, radius).to(x.device)
        r = (k.shape[0] - 1) // 2
        moved = torch.movedim(out, ax, -1)
        shape = moved.shape
        flat = moved.reshape(-1, 1, shape[-1])
        padded = F.pad(flat, (r, r), mode="replicate")[:, 0]
        n = shape[-1]
        acc = k[0] * padded[:, 0:n]
        for j in range(1, 2 * r + 1):
            acc = acc + k[j] * padded[:, j:j + n]
        out = torch.movedim(acc.reshape(shape), -1, ax)
    return out.to(x.dtype)
