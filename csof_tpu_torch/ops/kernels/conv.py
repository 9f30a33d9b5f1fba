"""K6: stride-1 3x3 SAME convolution on Hopper (``csrc/conv3x3.cu``), and its
plain PyTorch version.

Replaces ``csof_tpu/ops/pallas/conv.py`` ``conv3x3_cols`` /
``_conv3x3_cols_fwd_impl``: x and the weight taken in x's dtype, the taps
summed in float32 with zero padding (1, 1), one rounding to x's dtype (or a
float32 output with ``out_f32``). The optional bias is added afterwards, in
the dtype, as the JAX package's ``PallasConv`` adds it. x is
``(N, Ci, H, W)`` float32 or bfloat16, the weight ``(Co, Ci, 3, 3)`` and the
bias ``(Co,)`` float32 (the module's parameters). Forward only: the backward
(dx through the same kernel with flipped weights) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, dtype_code
from csof_tpu_torch.ops.kernels.skipfuse import forward_only

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def conv3x3_worthwhile(kernel_size, stride, ci: int, co: int, w: int | None = None) -> bool:
    """The JAX package's test for routing a conv to K6
    (``conv3x3_cols_worthwhile``): stride-1 3x3, Co < 128, and an input at
    least 32 wide. ``w`` is the input width, ``x.shape[-1]`` of NCHW."""
    if tuple(kernel_size) != (3, 3) or tuple(stride) != (1, 1):
        return False
    if w is not None and w < 32:
        return False
    return co < 128


def conv3x3_plain(x, weight, bias=None, out_f32=False):
    """The K6 function in plain PyTorch, with the kernel's rounding points."""
    dtype = x.dtype
    y = F.conv2d(x.float(), weight.to(dtype).float(), padding=1)  # float32 sum
    if out_f32:
        return y if bias is None else y + bias.float().view(1, -1, 1, 1)
    y = y.to(dtype)
    return y if bias is None else y + bias.to(dtype).view(1, -1, 1, 1)


def conv3x3_cuda(x, weight, bias=None, out_f32=False):
    """Launch K6 on the current stream of x's device."""
    global launches
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be a float32 or bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, Ci, H, W) tensor, got {tuple(x.shape)}")
    n, ci, h, w = x.shape
    co = weight.shape[0]
    params = (weight,) if bias is None else (weight, bias)
    if weight.shape != (co, ci, 3, 3) or (bias is not None and bias.shape != (co,)):
        raise ValueError(f"weight must be (Co, {ci}, 3, 3) and bias (Co,), got "
                         f"{tuple(weight.shape)}, {None if bias is None else tuple(bias.shape)}")
    for p in params:
        if p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError("weight and bias must be contiguous float32 on the device of x")
    if n == 0 or h == 0 or w == 0 or n > 65535:
        raise ValueError(f"batch {n} out of range for one launch, or an empty input")
    out = torch.empty((n, co, h, w), dtype=torch.float32 if out_f32 else x.dtype,
                      device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.csof_conv3x3_forward(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, ci, h, w, co, dtype_code(x), int(out_f32),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_conv3x3_forward")
    launches += 1
    return out


def conv3x3(x, weight, bias=None, out_f32=False):
    """(N, Ci, H, W) -> (N, Co, H, W). A CUDA tensor runs kernel K6; a CPU
    tensor runs its plain version."""
    forward_only("conv3x3", x, weight, *(() if bias is None else (bias,)),
                 hint="build the U-Net with conv_impl='native'")
    if x.is_cuda:
        return conv3x3_cuda(x, weight, bias, out_f32)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, out_f32)
    raise ValueError(f"unsupported device {x.device}")
