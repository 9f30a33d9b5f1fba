"""Conv/norm building blocks, NCHW (port of ``csof_tpu/models/blocks.py``).

Parameters are float32, as in flax, and cast to the compute dtype at use.
Submodules are named after the flax scopes they mirror (``Conv_0``,
``GroupNorm_0``, ``ConvNormAct_3``, ...) so that
:func:`csof_tpu_torch.compat.flax_import.load_flax_params` maps a flax tree
onto them by name. Each layer takes a ``torch.Generator`` and initializes as
its flax counterpart does.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.ops.kernels.conv import conv3x3, conv3x3_worthwhile
from csof_tpu_torch.ops.kernels.norm_act import instance_norm_leaky_relu
from csof_tpu_torch.ops.kernels.skipfuse import num_groups_for

# flax's truncated-normal initializers divide the stddev by the std of a unit
# normal cut at +-2, so the sample has the variance asked for
_TRUNC_STD = 0.87962566103423978
_INIT_SCALE = {"he_normal": 2.0, "lecun_normal": 1.0}


def init_kernel_(weight: torch.Tensor, fan_in: int, init, generator=None) -> None:
    """Fill a kernel as flax does: "he_normal" / "lecun_normal" (variance
    scaling over fan_in, truncated normal) or ("normal", std)."""
    with torch.no_grad():
        if isinstance(init, tuple):
            weight.normal_(0.0, init[1], generator=generator)
            return
        std = math.sqrt(_INIT_SCALE[init] / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """value rounded to dtype, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """LeakyReLU with the slope rounded to x's dtype, as JAX rounds a Python
    scalar that multiplies a bfloat16 array."""
    return torch.where(x >= 0, x, x * scalar_in(negative_slope, x.dtype))


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW: explicit ((top, bottom), (left, right))
    padding, by default ((k-1)//2, k//2) per axis, the conv rounded to the
    compute dtype and the bias added in it. Kernel and stride are an int or
    a per-axis pair."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=None,
                 bias=True, dtype=torch.float32, init="he_normal", generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, bias=bias)
        kh, kw = self.kernel_size
        self.pads = padding if padding is not None else (((kh - 1) // 2, kh // 2),
                                                         ((kw - 1) // 2, kw // 2))
        self.compute_dtype = dtype
        init_kernel_(self.weight, in_channels * kh * kw, init, generator)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        (top, bottom), (left, right) = self.pads
        x = x.to(self.compute_dtype)
        w = self.weight.to(self.compute_dtype)
        if top == bottom and left == right:
            y = F.conv2d(x, w, None, self.stride, (top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, None, self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype).view(1, -1, 1, 1)
        return y


class Dense(nn.Linear):
    """flax ``nn.Dense``: matmul in the compute dtype, bias added in it."""

    def __init__(self, in_features, out_features, dtype=torch.float32, generator=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        init_kernel_(self.weight, in_features, "lecun_normal", generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics and affine in float32,
    result in the compute dtype."""

    def __init__(self, features, dtype=torch.float32):
        super().__init__(features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def _affine_shape(x: torch.Tensor) -> tuple[int, ...]:
    return (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)


class GroupNorm(nn.Module):
    """GroupNorm over (channels of a group, spatial), eps 1e-5; 8 groups,
    lowered while they do not divide C. bfloat16 input takes the JAX fast
    path: E[x^2] - E[x]^2 from float32 means, then a bfloat16 ``x*a + b``."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups_for(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        g = self.num_groups
        if x.dtype == torch.bfloat16:
            sp = tuple(range(2, x.dim()))
            mean = x.mean(sp, dtype=torch.float32).view(n, g, c // g).mean(-1)
            m2 = x.square().mean(sp, dtype=torch.float32).view(n, g, c // g).mean(-1)
            inv = torch.rsqrt((m2 - mean * mean).clamp_min(0.0) + self.eps)
            a = self.weight.view(g, c // g) * inv[:, :, None]
            b = self.bias.view(g, c // g) - mean[:, :, None] * a
            shape = _affine_shape(x)
            return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        xg = x.float().reshape(n, g, -1)
        mean = xg.mean(-1, keepdim=True)
        var = xg.var(-1, unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).view(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel norm over spatial dims, eps 1e-5, with the
    same bfloat16 fast path as GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        sp = tuple(range(2, x.dim()))
        shape = _affine_shape(x)
        if x.dtype == torch.bfloat16:
            mean = x.mean(sp, dtype=torch.float32)
            m2 = x.square().mean(sp, dtype=torch.float32)
            inv = torch.rsqrt((m2 - mean * mean).clamp_min(0.0) + self.eps)
            a = self.weight * inv
            b = self.bias - mean * a
            return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        xf = x.float()
        mean = xf.mean(sp, keepdim=True)
        var = xf.var(sp, unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        pshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        return (y * self.weight.view(pshape) + self.bias.view(pshape)).to(x.dtype)


def make_norm(kind: str, channels: int) -> nn.Module:
    """``norm`` config value -> module ("batch" is GroupNorm, as in JAX)."""
    if kind in ("group", "batch"):
        return GroupNorm(channels)
    if kind == "instance":
        return InstanceNorm(channels)
    raise ValueError(f"unknown norm kind {kind!r}")


def add_norm(parent: nn.Module, kind: str, channels: int, index: int) -> str:
    """Register a norm under its flax auto-name (``GroupNorm_3``, ...) and
    return that name."""
    norm = make_norm(kind, channels)
    name = f"{type(norm).__name__}_{index}"
    parent.add_module(name, norm)
    return name


#: ``CSOF_CONV2D_IMPL`` values: the library conv, kernel K6, and the JAX
#: package's tap-sum form (the library conv here)
CONV_IMPLS = ("native", "pallas", "tapsum")


class ConvNormAct(nn.Module):
    """conv -> norm -> LeakyReLU (flax ``ConvNormAct`` and
    ``_NCHWConvNormAct``: same params; per-axis kernel and stride with
    ((k-1)//2, k//2) padding, so a stride-2 3x3 conv pads (1, 1)).

    The JAX package's two switches, as explicit arguments (parameters are
    the same either way):

    - ``conv_impl="pallas"`` (``CSOF_CONV2D_IMPL=pallas``) runs the conv as
      kernel K6 where the JAX package runs its Pallas conv: stride-1 3x3,
      Co < 128, an input at least 32 wide; its gradient runs K6 too (dx), as
      ``Conv3x3Function``;
    - ``fused_norm_act=True`` (``CSOF_FUSED_NORM=1``) runs InstanceNorm +
      LeakyReLU as kernel K5 (GroupNorm blocks ignore it, as in JAX).

    ``conv_impl="tapsum"`` (the JAX package's tap-sum form, a TPU
    reformulation of the same conv) runs the native conv.
    """

    def __init__(self, in_channels, features, stride=1, norm="group", dtype=torch.float32,
                 generator=None, kernel_size=3, fused_norm_act=False, conv_impl="native"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} is not one of {CONV_IMPLS}")
        self.Conv_0 = Conv(in_channels, features, kernel_size, stride, dtype=dtype,
                           generator=generator)
        self.norm_name = add_norm(self, norm, features, 0)
        self.fused_norm_act = fused_norm_act and norm == "instance"
        self.conv_impl = conv_impl

    def uses_k6(self, width: int) -> bool:
        """Whether an input ``width`` pixels wide runs the conv as K6."""
        conv = self.Conv_0
        return self.conv_impl == "pallas" and conv3x3_worthwhile(
            conv.kernel_size, conv.stride, conv.in_channels, conv.out_channels, width)

    def forward(self, x):
        conv = self.Conv_0
        if self.uses_k6(x.shape[-1]):
            x = conv3x3(x.to(conv.compute_dtype).contiguous(), conv.weight, conv.bias)
        else:
            x = conv(x)
        norm = getattr(self, self.norm_name)
        if self.fused_norm_act:
            return instance_norm_leaky_relu(x.contiguous(), norm.weight, norm.bias, norm.eps)
        return leaky_relu(norm(x))


class StackedConvs(nn.Module):
    """``num_convs`` ConvNormAct blocks (``ConvNormAct_0`` ...); the first may
    downsample by ``first_stride`` (flax ``StackedConvs``)."""

    def __init__(self, in_channels, features, num_convs, kernel_size=3, first_stride=None,
                 norm="instance", dtype=torch.float32, generator=None, fused_norm_act=False,
                 conv_impl="native"):
        super().__init__()
        for i in range(num_convs):
            stride = first_stride if (i == 0 and first_stride is not None) else 1
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(
                in_channels if i == 0 else features, features, stride, norm, dtype, generator,
                kernel_size, fused_norm_act, conv_impl))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose`` with kernel == stride (an int or a per-axis
    pair), VALID. Torch layout (C_in, C_out, kh, kw); the flax kernel maps
    onto it mirrored."""

    def __init__(self, in_channels, features, kernel=2, dtype=torch.float32, generator=None,
                 init="lecun_normal"):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.kernel = kernel
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, features, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        init_kernel_(self.weight, in_channels * kernel[0] * kernel[1], init, generator)

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), stride=self.kernel)
        return y + self.bias.to(dt).view(1, -1, 1, 1)


def upsample_linear(x: torch.Tensor, factors) -> torch.Tensor:
    """Linear upsampling of NCHW ``x`` by integer ``factors`` (fh, fw), as
    ``jax.image.resize(..., "linear")`` upsamples (half-pixel centres; at the
    edges JAX renormalizes the weights where torch clamps the coordinate,
    which agree for upsampling). One axis at a time in float32, rounded to
    x's dtype after each, in the order XLA's einsum contracts the two weight
    matrices: W first only where that costs fewer multiplies (H < W at equal
    factors), else H first."""
    fh, fw = factors
    h, w = x.shape[-2:]
    h2, w2 = h * fh, w * fw
    w_first = h * w * w2 + h * w2 * h2 < h * w * h2 + h2 * w * w2
    sizes = [(h, w2), (h2, w2)] if w_first else [(h2, w), (h2, w2)]
    dtype = x.dtype
    for size in sizes:
        x = F.interpolate(x.float(), size=size, mode="bilinear", align_corners=False).to(dtype)
    return x
