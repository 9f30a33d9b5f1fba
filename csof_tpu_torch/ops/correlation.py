"""Local correlation volume (SegFlow's per-level cost volume), channel-major.

Port of ``csof_tpu/ops/correlation.py`` ``local_correlation_volume`` with
``q_cm=m_cm=out_cm=True``:

    out[b, kk, h, w] = <q[b, :, h, w], m[b, :, h + s*dy, w + s*dx]> / sqrt(C)

over the (2r+1)^2 window, kk = (dy + r)(2r + 1) + (dx + r), zero outside the
image, accumulated in float32 and returned in the input dtype.
"""

from __future__ import annotations

import torch

from csof_tpu_torch.ops.kernels.corr import corr_cuda, corr_plain, forward_only


def local_correlation_volume(
    query: torch.Tensor, memory: torch.Tensor, radius: int = 4, stride: int = 1
) -> torch.Tensor:
    """query, memory: (B, C, H, W) -> (B, (2r+1)^2, H, W).

    A CUDA tensor runs kernel K1; a CPU tensor runs its plain version."""
    forward_only("local_correlation_volume", query, memory)
    if query.is_cuda:
        return corr_cuda(query, memory, radius, stride)
    if query.device.type == "cpu" and memory.device.type == "cpu":
        return corr_plain(query, memory, radius, stride)
    raise ValueError(f"unsupported devices {query.device}, {memory.device}")
