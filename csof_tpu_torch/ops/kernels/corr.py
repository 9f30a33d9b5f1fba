"""K1 and K2: the local correlation volume on Hopper (``csrc/corr.cu``) and
its backward (``csrc/corr_bwd.cu``), with their plain PyTorch versions and
the ``torch.autograd.Function`` that joins them.

K1 replaces ``csof_tpu/ops/pallas/corr.py``
``local_correlation_volume_pallas_batched``; K2 replaces ``_corr_bwd_pallas_v2``
(and ``_corr_bwd_pallas``, which computes the same pair). Layout is
channel-major: q, m ``(B, C, H, W)`` -> ``(B, (2r+1)^2, H, W)`` in the input
dtype, accumulated in float32; the backward takes the cotangent in the input
dtype (as the JAX custom VJP casts it) and returns ``(dq, dm)`` in it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build

#: launches of the K1 CUDA kernel since the last reset (set to 0 to reset)
launches = 0
#: launches of the K2 CUDA kernel pair since the last reset, one per backward
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RADIUS = 4


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in its accumulation dtype: float32, or float64 for float64 input."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _offsets(radius: int, stride: int):
    """(kk, row offset, column offset) of each window position, kk order."""
    k = 2 * radius + 1
    return [(i, (i // k - radius) * stride, (i % k - radius) * stride) for i in range(k * k)]


def corr_plain(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> torch.Tensor:
    """Shifted products of a zero-padded memory: the reference math of K1."""
    _, c, h, w = q.shape
    pad = radius * stride
    qf = _acc(q)
    mp = F.pad(_acc(m), (pad, pad, pad, pad))
    scale = 1.0 / math.sqrt(c)
    outs = [(qf * mp[:, :, pad + oy:pad + oy + h, pad + ox:pad + ox + w]).sum(1) * scale
            for _, oy, ox in _offsets(radius, stride)]
    return torch.stack(outs, 1).to(q.dtype)


def corr_bwd_plain(q: torch.Tensor, m: torch.Tensor, g: torch.Tensor, radius: int,
                   stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference math of K2, in the same gather form:
    dq[p] = sum_kk g[kk, p] m[p + d_kk] and dm[p] = sum_kk g[kk, p - d_kk]
    q[p - d_kk], zero outside the image, scaled by 1/sqrt(C)."""
    _, c, h, w = q.shape
    pad = radius * stride
    g = g.to(q.dtype)  # the cotangent in the input dtype, as the kernel takes it
    mp = F.pad(_acc(m), (pad, pad, pad, pad))
    qp = F.pad(_acc(q), (pad, pad, pad, pad))
    gp = F.pad(_acc(g), (pad, pad, pad, pad))
    gf = gp[:, :, pad:pad + h, pad:pad + w]
    dq = torch.zeros_like(mp[:, :, :h, :w])
    dm = torch.zeros_like(dq)
    for kk, oy, ox in _offsets(radius, stride):
        dq = dq + gf[:, kk:kk + 1] * mp[:, :, pad + oy:pad + oy + h, pad + ox:pad + ox + w]
        ys, xs = slice(pad - oy, pad - oy + h), slice(pad - ox, pad - ox + w)
        dm = dm + gp[:, kk:kk + 1, ys, xs] * qp[:, :, ys, xs]
    scale = 1.0 / math.sqrt(c)
    return (dq * scale).to(q.dtype), (dm * scale).to(q.dtype)


def check_pair(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> None:
    """The checks K1, K2 and K3 share: device, dtype, shape, contiguity, window."""
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


def launch_corr(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> torch.Tensor:
    """K1 on checked inputs (``check_pair``), on the current stream, with q's
    device current."""
    global launches
    b, c, h, w = q.shape
    out = torch.empty((b, (2 * radius + 1) ** 2, h, w), dtype=q.dtype, device=q.device)
    err = _build.load_library().csof_corr_forward(
        q.data_ptr(), m.data_ptr(), out.data_ptr(), b, c, h, w, radius, stride,
        dtype_code(q), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "csof_corr_forward")
    launches += 1
    return out


def corr_cuda(q: torch.Tensor, m: torch.Tensor, radius: int, stride: int) -> torch.Tensor:
    """Launch K1 on the current stream of q's device."""
    check_pair(q, m, radius, stride)
    with torch.cuda.device(q.device):
        return launch_corr(q, m, radius, stride)


def corr_bwd_cuda(q: torch.Tensor, m: torch.Tensor, g: torch.Tensor, radius: int,
                  stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (its dq and dm kernels) on the current stream of q's device.
    g must be contiguous ``(B, (2r+1)^2, H, W)`` in the dtype of q."""
    global bwd_launches
    check_pair(q, m, radius, stride)
    b, c, h, w = q.shape
    k2 = (2 * radius + 1) ** 2
    if g.shape != (b, k2, h, w) or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be {(b, k2, h, w)} {q.dtype} on {q.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if b * -(-c // 8) > 65535:
        raise ValueError(f"batch {b} x channels {c} too large for one launch")
    dq = torch.empty_like(q)
    dm = torch.empty_like(m)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.csof_corr_backward(
            q.data_ptr(), m.data_ptr(), g.data_ptr(), dq.data_ptr(), dm.data_ptr(),
            b, c, h, w, radius, stride, dtype_code(q), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_corr_backward")
    bwd_launches += 1
    return dq, dm


class CorrFunction(torch.autograd.Function):
    """Local correlation with K1 forward and K2 backward on CUDA tensors, and
    their plain versions on CPU tensors (so the CPU runs exactly the backward
    the kernel is held against, not autograd of ``corr_plain``).

    ``CorrFunction.apply(q, m, radius, stride)``."""

    @staticmethod
    def forward(ctx, q, m, radius: int, stride: int):
        ctx.save_for_backward(q, m)
        ctx.radius, ctx.stride = radius, stride
        if q.is_cuda:
            return corr_cuda(q, m, radius, stride)
        if q.device.type == "cpu" and m.device.type == "cpu":
            return corr_plain(q, m, radius, stride)
        raise ValueError(f"unsupported devices {q.device}, {m.device}")

    @staticmethod
    def backward(ctx, g):
        q, m = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        bwd = corr_bwd_cuda if q.is_cuda else corr_bwd_plain
        dq, dm = bwd(q, m, g, ctx.radius, ctx.stride)
        return dq, dm, None, None
