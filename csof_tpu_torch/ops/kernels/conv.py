"""K6: stride-1 3x3 SAME convolution on Hopper (``csrc/conv3x3.cu``), its
plain PyTorch version, and the ``torch.autograd.Function`` that runs it in
both directions.

Replaces ``csof_tpu/ops/pallas/conv.py`` ``conv3x3_cols`` /
``_conv3x3_cols_fwd_impl`` and its custom VJP: x and the weight taken in x's
dtype, the taps summed in float32 with zero padding (1, 1), one rounding to
x's dtype (or a float32 output with ``out_f32``). The optional bias is added
afterwards, in the dtype, as the JAX package's ``PallasConv`` adds it. x is
``(N, Ci, H, W)`` float32 or bfloat16, the weight ``(Co, Ci, 3, 3)`` and the
bias ``(Co,)`` float32 (the module's parameters).

The backward follows ``_conv3x3_cols_vjp_bwd``: the cotangent cast to x's
dtype; dx is the same kernel on the spatially flipped, in/out-transposed
weight (no bias, rounded to x's dtype); dw is the weight gradient of a plain
convolution in x's dtype (left to the library, as the JAX package leaves it
to XLA); db is the cotangent summed in the dtype, then cast to float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, _acc, dtype_code

#: launches of the CUDA kernel as a forward since the last reset (set to 0 to reset)
launches = 0
#: launches of the CUDA kernel as a backward (dx) since the last reset
bwd_launches = 0


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
    """The K6 function in plain PyTorch, with the kernel's rounding points
    (float64 input is summed in float64, for gradient checks)."""
    dtype = x.dtype
    y = F.conv2d(_acc(x), _acc(weight.to(dtype)), padding=1)  # float32 sum
    if out_f32:
        return y if bias is None else y + _acc(bias).view(1, -1, 1, 1)
    y = y.to(dtype)
    return y if bias is None else y + bias.to(dtype).view(1, -1, 1, 1)


def flipped_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) -> (Ci, Co, 3, 3), flipped in both spatial axes: the
    weight whose SAME correlation with dy is dx."""
    return weight.flip(2, 3).transpose(0, 1).contiguous()


def _launch(x, weight, bias, out_f32, dx=False):
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
            out.data_ptr(), n, ci, h, w, co, dtype_code(x), int(out_f32), int(dx),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_conv3x3_forward")
    return out


def conv3x3_cuda(x, weight, bias=None, out_f32=False):
    """Launch K6 on the current stream of x's device."""
    global launches
    out = _launch(x, weight, bias, out_f32)
    launches += 1
    return out


def conv3x3_dx_cuda(dy, weight):
    """dx of K6: K6 launched on dy (in x's dtype) with the flipped weight,
    as ``conv3x3_dx_kernel`` (the same code under its own name)."""
    global bwd_launches
    out = _launch(dy, flipped_weight(weight), None, False, dx=True)
    bwd_launches += 1
    return out


def conv3x3_dx_plain(dy, weight):
    """dx of K6 in plain PyTorch, by the same formula as the kernel's."""
    return conv3x3_plain(dy, flipped_weight(weight))


class Conv3x3Function(torch.autograd.Function):
    """K6 with its backward: the kernel in both directions on CUDA tensors,
    the plain versions on CPU tensors (so the CPU runs exactly the dx formula
    the kernel is held against).

    ``Conv3x3Function.apply(x, weight, bias, out_f32)``; bias may be None."""

    @staticmethod
    def forward(ctx, x, weight, bias, out_f32: bool):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if x.is_cuda:
            return conv3x3_cuda(x, weight, bias, out_f32)
        if x.device.type == "cpu":
            return conv3x3_plain(x, weight, bias, out_f32)
        raise ValueError(f"unsupported device {x.device}")

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (conv3x3_dx_cuda if dy.is_cuda else conv3x3_dx_plain)(dy, weight)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, dy, padding=1).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum((0, 2, 3)).to(weight.dtype)
        return dx, dw, db, None


def conv3x3(x, weight, bias=None, out_f32=False):
    """(N, Ci, H, W) -> (N, Co, H, W), differentiable. A CUDA tensor runs
    kernel K6 (forward and dx); a CPU tensor runs its plain version."""
    return Conv3x3Function.apply(x, weight, bias, out_f32)
