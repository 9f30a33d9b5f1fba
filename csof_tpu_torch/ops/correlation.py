"""Local correlation volume (SegFlow's per-level cost volume), channel-major.

Port of ``csof_tpu/ops/correlation.py`` ``local_correlation_volume`` with
``q_cm=m_cm=out_cm=True``:

    out[b, kk, h, w] = <q[b, :, h, w], m[b, :, h + s*dy, w + s*dx]> / sqrt(C)

over the (2r+1)^2 window, kk = (dy + r)(2r + 1) + (dx + r), zero outside the
image, accumulated in float32 and returned in the input dtype. Differentiable
in q and m.
"""

from __future__ import annotations

import torch

from csof_tpu_torch.ops.kernels.corr import CorrFunction


def local_correlation_volume(
    query: torch.Tensor, memory: torch.Tensor, radius: int = 4, stride: int = 1
) -> torch.Tensor:
    """query, memory: (B, C, H, W) -> (B, (2r+1)^2, H, W).

    CUDA tensors run kernel K1 forward and K2 backward; CPU tensors run their
    plain versions (:class:`CorrFunction`)."""
    return CorrFunction.apply(query, memory, radius, stride)
