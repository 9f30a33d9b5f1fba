"""Conv/norm building blocks, NCHW and NCDHW (port of
``csof_tpu/models/blocks.py``).

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
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from csof_tpu_torch.ops.kernels.conv import conv3x3, conv3x3_worthwhile
from csof_tpu_torch.ops.kernels.norm_act import (instance_norm_leaky_relu, native_fits,
                                                 native_norm_act)
from csof_tpu_torch.ops.kernels.skipfuse import num_groups_for
from csof_tpu_torch.utils import profiling

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


def _per_axis(v, nd: int) -> tuple[int, ...]:
    return (v,) * nd if isinstance(v, int) else tuple(v)


def same_pads(sizes, kernel_size, stride) -> tuple[tuple[int, int], ...]:
    """flax's ``padding="SAME"`` per axis: the output ceil(size / stride)
    wide, the total padding split with the odd pixel at the end, so a
    stride-2 conv on an even size pads (2, 3) for 7 taps, (0, 1) for 3 and
    nothing for 1."""
    pads = []
    for n, k, s in zip(sizes, kernel_size, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW or NCDHW: explicit (lo, hi) padding per axis,
    by default ((k-1)//2, k//2), or ``padding="SAME"`` (flax's, from the
    input's size: :func:`same_pads`), the conv rounded to the compute dtype
    and the bias added in it. Kernel and stride are an int (2-D) or a
    per-axis pair or triple; the weight is torch's (Co, Ci, *kernel),
    he_normal over the fan-in Ci * prod(kernel)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=None,
                 bias=True, dtype=torch.float32, init="he_normal", generator=None):
        super().__init__()
        nd = 2 if isinstance(kernel_size, int) else len(kernel_size)
        self.kernel_size = _per_axis(kernel_size, nd)
        self.stride = _per_axis(stride, nd)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.same = padding == "SAME"
        self.pads = (tuple(((k - 1) // 2, k // 2) for k in self.kernel_size)
                     if padding is None or self.same else tuple(tuple(p) for p in padding))
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size))
        init_kernel_(self.weight, in_channels * math.prod(self.kernel_size), init, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        x = x.to(self.compute_dtype)
        w = self.weight.to(self.compute_dtype)
        pads = (same_pads(x.shape[2:], self.kernel_size, self.stride) if self.same
                else self.pads)
        if all(lo == hi for lo, hi in pads):
            y = conv(x, w, None, self.stride, tuple(lo for lo, _ in pads))
        else:
            y = conv(F.pad(x, [p for lo_hi in pads[::-1] for p in lo_hi]), w, None, self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype).view(1, -1, *(1,) * (y.dim() - 2))
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


class KernelSwitches(NamedTuple):
    conv_impl: str
    fused_norm_act: bool
    remat_policy: str


def kernel_switches(ndim: int, conv_impl: str | None = None, fused_norm_act: bool | None = None,
                    remat_policy: str | None = None, remat: bool = False) -> KernelSwitches:
    """Which kernels an ``ndim``-D net runs: each argument as given, and
    where it is None the JAX package's switch, read from the environment as
    it reads it. ``CSOF_CONV2D_IMPL`` (default ``native``) routes the convs;
    a 3-D net runs K6 only in its z taps (``Conv3dVia2D``), which
    ``CSOF_CONV3D_IMPL`` other than ``2d`` (the default) turns off;
    ``CSOF_FUSED_NORM=1`` runs K5; ``CSOF_REMAT_POLICY`` is a U-Net's
    recompute policy (default ``save_conv`` with ``remat``, else ``full``)."""
    if conv_impl is None:
        conv_impl = os.environ.get("CSOF_CONV2D_IMPL", "native")
        if ndim == 3 and os.environ.get("CSOF_CONV3D_IMPL", "2d") != "2d":
            conv_impl = "native"
    if fused_norm_act is None:
        fused_norm_act = os.environ.get("CSOF_FUSED_NORM", "0") == "1"
    if remat_policy is None:
        remat_policy = os.environ.get("CSOF_REMAT_POLICY", "save_conv" if remat else "full")
    return KernelSwitches(conv_impl, fused_norm_act, remat_policy)


class ConvNormAct(nn.Module):
    """conv -> norm -> LeakyReLU (flax ``ConvNormAct`` and
    ``_NCHWConvNormAct``: same params; per-axis kernel and stride with
    ((k-1)//2, k//2) padding, so a stride-2 3x3 conv pads (1, 1)). A 3-D
    kernel makes it the 3D block (NCDHW).

    The JAX package's two switches, as explicit arguments (parameters are
    the same either way):

    - ``conv_impl="pallas"`` (``CSOF_CONV2D_IMPL=pallas``) runs the conv as
      kernel K6 where the JAX package runs its Pallas conv: a stride-1 3x3
      kernel (in y and x for a 3-D one), Co < 128, an input at least 32
      wide; its gradient runs K6 too (dx), as ``Conv3x3Function``. A 3-D
      conv runs as JAX's ``Conv3dVia2D`` runs it there: one K6 launch per z
      tap (:meth:`_k6_taps`). ``CSOF_CONV3D_IMPL=native`` (JAX's plain 3D
      conv) is ``conv_impl="native"`` on a 3D block
      (:func:`kernel_switches`);
    - ``fused_norm_act=True`` (``CSOF_FUSED_NORM=1``) runs InstanceNorm +
      LeakyReLU as kernel K5 on a 2D block (GroupNorm blocks and 3D blocks
      ignore it, as in JAX).

    With K5 off, a 2D InstanceNorm block runs its own norm and activation
    (``leaky_relu(InstanceNorm(z))``, the same numerics) as kernels K7 and
    K7 dx where the conv output is a float32 CUDA tensor whose planes K7 dx
    can hold on chip (:meth:`uses_k7`); elsewhere (the CPU, bfloat16, 3D
    blocks, GroupNorm) it runs the module and the activation as they are.

    ``conv_impl="tapsum"`` (the JAX package's tap-sum form, a TPU
    reformulation of the same conv) runs the native conv. ``remat_norm_act``
    recomputes the norm and activation in the backward pass from the saved
    conv output (``torch.utils.checkpoint``; JAX's ``save_conv`` remat
    policy).

    A 3D block opens two spans of its own while grad is enabled (a train
    step; :func:`csof_tpu_torch.utils.profiling.span`): ``block3d.ztaps``
    around :meth:`_k6_taps` and ``block3d.norm_act`` around the norm and
    activation, again in the recompute inside the backward pass under
    ``remat_norm_act``. A 2D block and an evaluation open none.
    """

    def __init__(self, in_channels, features, stride=1, norm="group", dtype=torch.float32,
                 generator=None, kernel_size=3, fused_norm_act=False, conv_impl="native"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} is not one of {CONV_IMPLS}")
        self.Conv_0 = Conv(in_channels, features, kernel_size, stride, dtype=dtype,
                           generator=generator)
        self.norm_name = add_norm(self, norm, features, 0)
        self.fused_norm_act = (fused_norm_act and norm == "instance"
                               and len(self.Conv_0.kernel_size) == 2)
        self.conv_impl = conv_impl
        self.remat_norm_act = False

    def uses_k6(self, width: int) -> bool:
        """Whether an input ``width`` pixels wide runs the conv as K6 (a 3D
        block: once per z tap)."""
        conv = self.Conv_0
        return self.conv_impl == "pallas" and conv3x3_worthwhile(
            conv.kernel_size[-2:], conv.stride[-2:], conv.in_channels, conv.out_channels, width)

    def uses_k7(self, hw: int, device: torch.device, dtype: torch.dtype) -> bool:
        """Whether a conv output of ``hw`` pixels a plane, on ``device`` in
        ``dtype``, runs the norm and activation as K7 (and K7 dx)."""
        return (not self.fused_norm_act and len(self.Conv_0.kernel_size) == 2
                and isinstance(getattr(self, self.norm_name), InstanceNorm)
                and device.type == "cuda" and dtype == torch.float32 and native_fits(hw))

    def _span3d(self, name: str):
        """The span ``name`` of a 3D block in a train step, else the no-op."""
        if len(self.Conv_0.kernel_size) == 3 and torch.is_grad_enabled():
            return profiling.span(name)
        return profiling.no_span(name)

    def _k6_taps(self, x):
        """The 3D conv as the JAX package's ``Conv3dVia2D`` computes it under
        the Pallas switch: z padded, then for each z tap dz the input's z
        slices (stride sz) folded into the batch, ``(N * D_out, Ci, H, W)``
        contiguous, through K6 without bias (a float32 output where the
        dtype is narrower and kz > 1, JAX's ``acc_t``); the taps summed in dz
        order, rounded to the dtype, unfolded to ``(N, Co, D_out, H, W)``,
        and the bias added in the dtype."""
        with self._span3d("block3d.ztaps"):
            conv = self.Conv_0
            dt = conv.compute_dtype
            kz, sz = conv.kernel_size[0], conv.stride[0]
            out_f32 = kz > 1 and dt != torch.float32
            x = F.pad(x.to(dt), (0, 0, 0, 0, *conv.pads[0]))
            n, ci, d, h, w = x.shape
            d_out = (d - kz) // sz + 1
            y = None
            for dz in range(kz):
                xs = x[:, :, dz:dz + (d_out - 1) * sz + 1:sz]
                xs = xs.transpose(1, 2).contiguous().view(n * d_out, ci, h, w)
                yz = conv3x3(xs, conv.weight[:, :, dz].contiguous(), None, out_f32)
                y = yz if y is None else y + yz
            y = y.view(n, d_out, -1, h, w).transpose(1, 2).contiguous().to(dt)
            if conv.bias is not None:
                y = y + conv.bias.to(dt).view(1, -1, 1, 1, 1)
            return y

    def _norm_act(self, x):
        norm = getattr(self, self.norm_name)
        if self.fused_norm_act:
            return instance_norm_leaky_relu(x.contiguous(), norm.weight, norm.bias, norm.eps)
        if self.uses_k7(x.shape[-2] * x.shape[-1], x.device, x.dtype):
            return native_norm_act(x.contiguous(), norm.weight, norm.bias, norm.eps)
        with self._span3d("block3d.norm_act"):
            return leaky_relu(norm(x))

    def forward(self, x):
        conv = self.Conv_0
        if not self.uses_k6(x.shape[-1]):
            x = conv(x)
        elif len(conv.kernel_size) == 3:
            x = self._k6_taps(x)
        else:
            x = conv3x3(x.to(conv.compute_dtype).contiguous(), conv.weight, conv.bias)
        if self.remat_norm_act and torch.is_grad_enabled():
            return checkpoint(self._norm_act, x, use_reentrant=False)
        return self._norm_act(x)


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
    """flax ``ConvTranspose`` with kernel == stride (an int, or one entry per
    spatial axis: 2-D or 3-D), VALID. Torch layout (C_in, C_out, *kernel);
    the flax kernel maps onto it mirrored in every spatial axis."""

    def __init__(self, in_channels, features, kernel=2, dtype=torch.float32, generator=None,
                 init="lecun_normal"):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.kernel = kernel
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, features, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        init_kernel_(self.weight, in_channels * math.prod(kernel), init, generator)

    def forward(self, x):
        dt = self.compute_dtype
        tconv = F.conv_transpose2d if len(self.kernel) == 2 else F.conv_transpose3d
        y = tconv(x.to(dt), self.weight.to(dt), stride=self.kernel)
        return y + self.bias.to(dt).view(1, -1, *(1,) * len(self.kernel))


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
