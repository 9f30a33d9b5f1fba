"""K5: fused InstanceNorm + affine + LeakyReLU on Hopper (``csrc/norm_act.cu``),
and its plain PyTorch version.

Replaces ``csof_tpu/ops/pallas/norm_act.py``
``instance_norm_leaky_relu_pallas``: per-(n, c)-plane statistics as float32
means of x and x^2 (variance ``E[x^2] - mean^2``, no clamp, eps 1e-5), the
affine and the LeakyReLU slope applied in float32, one rounding to x's dtype.
That is neither the port's ``InstanceNorm`` module (two-pass variance in
float32, and a bfloat16 fast path that rounds the affine coefficients) nor
its ``leaky_relu`` (slope rounded to x's dtype). x is ``(N, C, H, W)``
float32 or bfloat16; scale and bias are ``(C,)`` float32. Forward only.
"""

from __future__ import annotations

import torch

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, dtype_code
from csof_tpu_torch.ops.kernels.skipfuse import forward_only

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

_SMALL_MAX = 4096  # planes up to this size take one warp each (csrc/norm_act.cu kSmallMax)
_CHUNK = 4096  # elements per block of the large-plane passes (kChunk)


def norm_act_plain(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """The K5 function in plain PyTorch, with the kernel's rounding points."""
    xf = x.float()
    mean = xf.mean((2, 3), keepdim=True)
    var = (xf * xf).mean((2, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    return torch.where(y >= 0, y, negative_slope * y).to(x.dtype)


def norm_act_cuda(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """Launch K5 on the current stream of x's device."""
    global launches
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be a float32 or bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, C, H, W) tensor, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    for p in (scale, bias):
        if (p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"scale and bias must be contiguous float32 ({c},) on {x.device}")
    planes, hw = n * c, h * w
    if planes == 0 or hw == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    partial = None
    if hw > _SMALL_MAX:
        if planes > 65535:
            raise ValueError(f"{planes} planes too many for one launch")
        partial = torch.empty((planes, -(-hw // _CHUNK), 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.csof_norm_act_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), planes, c, hw, eps,
            negative_slope, dtype_code(x), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_norm_act_forward")
    launches += 1
    return out


def instance_norm_leaky_relu(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """(N, C, H, W) -> the same. A CUDA tensor runs kernel K5; a CPU tensor
    runs its plain version."""
    forward_only("instance_norm_leaky_relu", x, scale, bias,
                 hint="build the U-Net with fused_norm_act=False")
    if x.is_cuda:
        return norm_act_cuda(x, scale, bias, eps, negative_slope)
    if x.device.type == "cpu":
        return norm_act_plain(x, scale, bias, eps, negative_slope)
    raise ValueError(f"unsupported device {x.device}")
