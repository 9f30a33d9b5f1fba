"""K3: SegFlow skip fuse on Hopper (``csrc/skipfuse.cu``), and its plain
PyTorch version.

Replaces ``csof_tpu/ops/pallas/skipfuse.py`` ``fused_skip_fuse_batched``:
corr(q, m) -> concat [q, m, corr] -> 3x3 SAME conv + bias -> GroupNorm ->
LeakyReLU, forward only. q, m are ``(B, C, H, W)``; the parameters are the
``ConvNormAct_0`` parameters of the SkipFuse module in torch layout (conv
weight ``(F, 2C + (2r+1)^2, 3, 3)`` and bias, GroupNorm weight and bias, all
float32). The output is ``(B, F, H, W)`` in the input dtype.

The kernel's passes: K1 (``corr.py``) writes the corr volume; the conv
pass, K6's implicit GEMM on the tensor cores reading [q, m, corr] from the
three tensors, writes y and the GroupNorm partials; the apply pass
normalizes. The wrapper packs the conv weight once per call with K6's
``pack_weight`` (the order the kernel's shared-memory descriptors read).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.conv import pack_weight
from csof_tpu_torch.ops.kernels.corr import check_pair, corr_plain, dtype_code, launch_corr

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def partial_tiles(h: int, w: int) -> int:
    """Tiles of the conv pass that the GroupNorm partials buffer must hold:
    a tile is 64 columns x 2 or 4 rows (csrc/igemm3x3.cuh Tiling), so the
    2-row count bounds both."""
    return -(-h // 2) * -(-w // 64)


def forward_only(name: str, *tensors: torch.Tensor,
                 hint: str = "train with corr_fuse='concat' / 'concat_cm'") -> None:
    """Raise when autograd would need a kernel's backward that does not exist
    (K3, K5, K6: their TPU kernels are forward-only on the paths they serve)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: it has no backward kernel. Run it under "
            f"torch.no_grad() or torch.inference_mode(), or {hint}."
        )


def num_groups_for(features: int, num_groups: int = 8) -> int:
    """GroupNorm's group count: num_groups, lowered until it divides F."""
    g = min(num_groups, features)
    while features % g:
        g -= 1
    return g


def skip_fuse_plain(q, m, weight, bias, gn_weight, gn_bias, radius, stride,
                    num_groups=8, eps=1e-5, negative_slope=0.01):
    """The K3 chain in plain PyTorch, with the kernel's rounding points."""
    dtype = q.dtype
    corr = corr_plain(q, m, radius, stride)  # rounded to the dtype
    y = F.conv2d(torch.cat([q, m, corr], 1), weight.to(dtype), padding=1)
    y = y + bias.to(dtype).view(1, -1, 1, 1)
    b, f, h, w = y.shape
    g = num_groups_for(f, num_groups)
    yf = y.float()
    mean_c = yf.sum((2, 3)) / (h * w)
    m2_c = (yf * yf).sum((2, 3)) / (h * w)
    mean = mean_c.view(b, g, f // g).sum(-1) / (f // g)
    m2 = m2_c.view(b, g, f // g).sum(-1) / (f // g)
    inv = torch.rsqrt((m2 - mean * mean).clamp_min(0.0) + eps)
    a = gn_weight.view(g, f // g) * inv[:, :, None]
    c = gn_bias.view(g, f // g) - mean[:, :, None] * a
    out = y * a.to(dtype).view(b, f, 1, 1) + c.to(dtype).view(b, f, 1, 1)
    slope = float(torch.tensor(negative_slope, dtype=dtype))  # rounded like the kernel's
    return torch.where(out.float() >= 0, out, out * slope)


def skip_fuse_cuda(q, m, weight, bias, gn_weight, gn_bias, radius, stride,
                   num_groups=8, eps=1e-5, negative_slope=0.01):
    """Launch K3 (corr, conv+stats, norm+activation passes; the weight packed
    on the way) on the current stream of q's device."""
    global launches
    check_pair(q, m, radius, stride)
    b, c, h, w = q.shape
    k2 = (2 * radius + 1) ** 2
    f = weight.shape[0]
    params = (weight, bias, gn_weight, gn_bias)
    if weight.shape != (f, 2 * c + k2, 3, 3):
        raise ValueError(f"weight must be (F, {2 * c + k2}, 3, 3), got {tuple(weight.shape)}")
    for p in params:
        if p.dtype != torch.float32 or p.device != q.device or not p.is_contiguous():
            raise ValueError("parameters must be contiguous float32 on the device of q")
    for p in params[1:]:
        if p.shape != (f,):
            raise ValueError(f"bias and GroupNorm parameters must be ({f},), got {tuple(p.shape)}")
    if b > 65535 or f > 65535:
        raise ValueError(f"batch {b} or features {f} too large for one launch")
    groups = num_groups_for(f, num_groups)
    y = torch.empty((b, f, h, w), dtype=q.dtype, device=q.device)
    partial = torch.empty((b, partial_tiles(h, w), f, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((b, f, h, w), dtype=q.dtype, device=q.device)
    corr = launch_corr(q, m, radius, stride)  # pass 1: K1, staged in device memory
    packed, nb = pack_weight(weight, q.dtype)
    _build.cuda_call("csof_skipfuse_forward", q.device, q.data_ptr(), m.data_ptr(),
                     corr.data_ptr(), packed.data_ptr(), bias.data_ptr(), gn_weight.data_ptr(),
                     gn_bias.data_ptr(), y.data_ptr(), partial.data_ptr(), out.data_ptr(), b, c,
                     k2, h, w, f, groups, nb, eps, negative_slope, dtype_code(q))
    launches += 1
    return out


def fused_skip_fuse(q, m, weight, bias, gn_weight, gn_bias, radius=4, stride=1,
                    num_groups=8, eps=1e-5, negative_slope=0.01):
    """(B, C, H, W) x 2 -> (B, F, H, W). A CUDA tensor runs kernel K3; a CPU
    tensor runs its plain version."""
    args = (q, m, weight, bias, gn_weight, gn_bias, radius, stride, num_groups, eps,
            negative_slope)
    forward_only("fused_skip_fuse", q, m, weight, bias, gn_weight, gn_bias)
    if q.is_cuda:
        return skip_fuse_cuda(*args)
    if q.device.type == "cpu" and m.device.type == "cpu":
        return skip_fuse_plain(*args)
    raise ValueError(f"unsupported devices {q.device}, {m.device}")
