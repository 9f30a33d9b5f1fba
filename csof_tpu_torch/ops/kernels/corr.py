"""K1: local correlation volume on Hopper (``csrc/corr.cu``), and its plain
PyTorch version.

Replaces ``csof_tpu/ops/pallas/corr.py`` ``local_correlation_volume_pallas_batched``.
Layout is channel-major: q, m ``(B, C, H, W)`` -> ``(B, (2r+1)^2, H, W)`` in the
input dtype, accumulated in float32. Forward only: the backward (K2) is not
ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RADIUS = 4


def corr_plain(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> torch.Tensor:
    """Shifted products of a zero-padded memory: the reference math of K1."""
    _, c, h, w = q.shape
    pad = radius * stride
    qf = q.float()
    mp = F.pad(m.float(), (pad, pad, pad, pad))
    scale = 1.0 / math.sqrt(c)
    outs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            oy, ox = pad + dy * stride, pad + dx * stride
            outs.append((qf * mp[:, :, oy:oy + h, ox:ox + w]).sum(1) * scale)
    return torch.stack(outs, 1).to(q.dtype)


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a backward that is not ported."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its backward kernel is not ported yet. "
            "Run it under torch.no_grad() or torch.inference_mode()."
        )


def check_pair(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> None:
    """The checks K1 and K3 share: device, dtype, shape, contiguity, window."""
    if not (q.is_cuda and m.is_cuda and q.device == m.device):
        raise ValueError(f"q and m must be on one CUDA device, got {q.device} and {m.device}")
    if q.dtype not in _DTYPE_CODES or m.dtype != q.dtype:
        raise TypeError(f"q and m must both be float32 or bfloat16, got {q.dtype}, {m.dtype}")
    if q.dim() != 4 or m.shape != q.shape:
        raise ValueError(f"q and m must be (B, C, H, W) of one shape, "
                         f"got {tuple(q.shape)}, {tuple(m.shape)}")
    if not (q.is_contiguous() and m.is_contiguous()):
        raise ValueError("q and m must be contiguous")
    if not (1 <= radius <= MAX_RADIUS and stride >= 1):
        raise ValueError(f"radius must be in 1..{MAX_RADIUS} and stride >= 1, "
                         f"got {radius}, {stride}")
    if q.shape[0] * (2 * radius + 1) > 65535:
        raise ValueError(f"batch {q.shape[0]} too large for one launch")


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODES[t.dtype]


def corr_cuda(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> torch.Tensor:
    """Launch K1 on the current stream of q's device."""
    global launches
    check_pair(q, m, radius, stride)
    b, c, h, w = q.shape
    out = torch.empty((b, (2 * radius + 1) ** 2, h, w), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.csof_corr_forward(
            q.data_ptr(), m.data_ptr(), out.data_ptr(), b, c, h, w, radius, stride,
            dtype_code(q), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_corr_forward")
    launches += 1
    return out
