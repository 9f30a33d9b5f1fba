"""K5: fused InstanceNorm + affine + LeakyReLU on Hopper (``csrc/norm_act.cu``),
and its plain PyTorch version; K7 and K7 dx: the port's own InstanceNorm +
LeakyReLU, forward and backward (``csrc/inorm_lrelu.cu``).

K5 replaces ``csof_tpu/ops/pallas/norm_act.py``
``instance_norm_leaky_relu_pallas``: per-(n, c)-plane statistics as float32
means of x and x^2 (variance ``E[x^2] - mean^2``, no clamp, eps 1e-5), the
affine and the LeakyReLU slope applied in float32, one rounding to x's dtype.
That is neither the port's ``InstanceNorm`` module (two-pass variance in
float32, and a bfloat16 fast path that rounds the affine coefficients) nor
its ``leaky_relu`` (slope rounded to x's dtype). x is ``(N, C, H, W)``
float32 or bfloat16; scale and bias are ``(C,)`` float32. Forward only.

K7 is the module path itself, fused: ``leaky_relu(InstanceNorm(z))`` of a
float32 ``(N, C, H, W)`` z, with the module's two-pass variance; it writes
each plane's mean and rstd beside y, and K7 dx computes dz and the per-plane
sums that dgamma and dbeta add up over N, in closed form
(``InstanceNormLeakyReLUFunction``; ``native_forward_plain`` and
``native_backward_plain`` are the same formulas in plain PyTorch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, MAX_SMEM_BYTES, _acc, dtype_code
from csof_tpu_torch.ops.kernels.skipfuse import forward_only

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0
#: launches of K7 (the native path's forward) and of K7 dx since the last reset
native_launches = 0
native_bwd_launches = 0

#: planes of at most this many bytes take the warp path (a warp a plane;
#: csrc/norm_act.cu accepts up to kSmallMax = 4096 elements there): at the
#: U-Net's planes it beat a block a plane up to 2.5 KB and lost at 5 KB
#: (``kernel_times --k5-plans``)
SMALL_MAX_BYTES = 4096
#: the most bytes of a plane one block of a cluster holds, where a plane
#: needs more than one (a cluster of 4 beat 2 and 8 at the 320 KB float32
#: plane); a cluster has at most MAX_CLUSTER blocks (the portable size)
SLICE_BYTES = 80 * 1024
MAX_CLUSTER = 8


@dataclass(frozen=True)
class NormActPlan:
    """How K5 covers a plane: ``path`` "warp" (a warp a plane, planes of at
    most SMALL_MAX_BYTES), "block" (a block a plane) or "cluster"
    (``cluster`` blocks a plane); ``slice`` elements and ``smem_bytes`` of
    dynamic shared memory a block (0 on the warp path)."""

    path: str
    cluster: int
    slice: int
    smem_bytes: int


WARP_PLAN = NormActPlan("warp", 0, 0, 0)


def cluster_plan(hw: int, dtype: torch.dtype, cluster: int) -> NormActPlan:
    """A plane of ``hw`` elements split over ``cluster`` blocks: the slice a
    block holds, in whole 16-byte groups, and the shared memory it asks for
    (``plane_smem_bytes`` in csrc/norm_act.cu: the slice plus one group for
    a plane off the 16-byte grid). Raises where a block cannot hold it."""
    group = 16 // dtype.itemsize
    slice_ = -(-hw // cluster)
    slice_ = -(-slice_ // group) * group
    smem = (slice_ // group + 1) * 16
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a plane of {hw} {dtype} elements needs {smem} bytes of shared "
                         f"memory in each of {cluster} blocks, more than {MAX_SMEM_BYTES}")
    return NormActPlan("block" if cluster == 1 else "cluster", cluster, slice_, smem)


@functools.lru_cache(maxsize=None)
def norm_act_plan(n: int, c: int, h: int, w: int, dtype: torch.dtype) -> NormActPlan:
    """K5's plan for ``(n, c, h, w)`` planes of ``dtype``: a warp a plane up
    to SMALL_MAX_BYTES, else the fewest blocks (a power of two, at most
    MAX_CLUSTER) whose slices hold at most SLICE_BYTES each. Raises for a
    plane too large for MAX_CLUSTER blocks."""
    hw = h * w
    if n * c <= 0 or hw <= 0:
        raise ValueError(f"empty input {(n, c, h, w)}")
    nbytes = hw * dtype.itemsize
    if nbytes <= SMALL_MAX_BYTES:
        return WARP_PLAN
    cluster = 1
    while nbytes > cluster * SLICE_BYTES and cluster < MAX_CLUSTER:
        cluster *= 2
    return cluster_plan(hw, dtype, cluster)


def norm_act_plain(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """The K5 function in plain PyTorch, with the kernel's rounding points."""
    xf = x.float()
    mean = xf.mean((2, 3), keepdim=True)
    var = (xf * xf).mean((2, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    return torch.where(y >= 0, y, negative_slope * y).to(x.dtype)


def norm_act_cuda(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """Launch K5 on the current stream of x's device, as ``norm_act_plan``
    says."""
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be a float32 or bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, C, H, W) tensor, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    for p in (scale, bias):
        if (p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"scale and bias must be contiguous float32 ({c},) on {x.device}")
    plan = norm_act_plan(n, c, h, w, x.dtype)
    if n * c * max(plan.cluster, 1) >= 2 ** 31:
        raise ValueError(f"{n * c} planes too many for one launch")
    return launch(x, scale, bias, plan, eps, negative_slope)


def launch(x, scale, bias, plan: NormActPlan, eps=1e-5, negative_slope=0.01):
    """K5 on checked inputs (``norm_act_cuda``) under a given plan."""
    global launches
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.csof_norm_act_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n * c, c, h * w,
            plan.cluster, plan.slice, plan.smem_bytes, eps, negative_slope, dtype_code(x),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "csof_norm_act_forward")
    launches += 1
    return out


def instance_norm_leaky_relu(x, scale, bias, eps=1e-5, negative_slope=0.01):
    """(N, C, H, W) -> the same. A CUDA tensor runs kernel K5; a CPU tensor
    runs its plain version."""
    forward_only("instance_norm_leaky_relu", x, scale, bias,
                 hint="build the model with fused_norm_act=False")
    if x.is_cuda:
        return norm_act_cuda(x, scale, bias, eps, negative_slope)
    if x.device.type == "cpu":
        return norm_act_plain(x, scale, bias, eps, negative_slope)
    raise ValueError(f"unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def native_plan(hw: int, backward: bool = False) -> NormActPlan:
    """K7's plan (with ``backward``, K7 dx's) for float32 planes of ``hw``
    elements, by K5's rule: a warp a plane up to SMALL_MAX_BYTES of z (1024
    elements; a lane holds its 32 in registers), else the fewest blocks (a
    power of two, at most MAX_CLUSTER) whose slices hold at most SLICE_BYTES
    each, of z and, for the backward, of dy beside it. Raises for a plane
    too large for MAX_CLUSTER blocks."""
    if hw <= 0:
        raise ValueError(f"empty plane of {hw} elements")
    if hw * 4 <= SMALL_MAX_BYTES:
        return WARP_PLAN
    arrays = 2 if backward else 1
    cluster = 1
    while hw * 4 * arrays > cluster * SLICE_BYTES and cluster < MAX_CLUSTER:
        cluster *= 2
    plan = cluster_plan(hw, torch.float32, cluster)
    smem = plan.smem_bytes * arrays
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a plane of {hw} float32 elements needs {smem} bytes of shared memory "
                         f"in each of {cluster} blocks, more than {MAX_SMEM_BYTES}")
    return NormActPlan(plan.path, cluster, plan.slice, smem)


@functools.lru_cache(maxsize=None)
def native_fits(hw: int) -> bool:
    """Whether K7 dx can hold z and dy of a plane of ``hw`` elements on chip
    (and so K7 its z)."""
    try:
        native_plan(hw, backward=True)
    except ValueError:
        return False
    return True


def _per_plane(p: torch.Tensor, n: int) -> torch.Tensor:
    """A (C,) parameter as a column over the N * C planes."""
    return _acc(p).repeat(n)[:, None]


def native_forward_plain(z, weight, bias, eps=1e-5, negative_slope=0.01):
    """K7 in plain PyTorch, by the kernel's formulas: (y, mean, rstd), the
    statistics a plane (``(N * C,)``) in z's accumulation dtype (float32, or
    float64 for float64 input)."""
    n, c = z.shape[:2]
    zf = _acc(z).reshape(n * c, -1)
    mean = zf.mean(1)
    rstd = torch.rsqrt((zf - mean[:, None]).square().mean(1) + eps)
    a = (zf - mean[:, None]) * rstd[:, None] * _per_plane(weight, n) + _per_plane(bias, n)
    y = torch.where(a >= 0, a, a * negative_slope)
    return y.view(z.shape).to(z.dtype), mean, rstd


def native_backward_plain(z, dy, mean, rstd, weight, bias, negative_slope=0.01,
                          positive=None):
    """K7 dx in plain PyTorch, by the kernel's formulas: (dz, the sums of da
    a plane, the sums of da * zh a plane). ``positive``, a boolean tensor of
    z's shape, says where the pre-activation counts as >= 0 (by default its
    own sign here; a check of the kernel passes the kernel's, read from its
    y, since a pre-activation within a rounding of 0 may fall either way)."""
    n, c = z.shape[:2]
    zf, d = _acc(z).reshape(n * c, -1), _acc(dy).reshape(n * c, -1)
    g = _per_plane(weight, n)
    zh = (zf - mean[:, None]) * rstd[:, None]
    pos = zh * g + _per_plane(bias, n) >= 0 if positive is None else positive.reshape(n * c, -1)
    da = torch.where(pos, d, d * negative_slope)
    p1, p2 = da.sum(1), (da * zh).sum(1)
    m = zf.shape[1]
    dz = g * rstd[:, None] * (da - p1[:, None] / m - zh * p2[:, None] / m)
    return dz.view(z.shape).to(z.dtype), p1, p2


def _check_native(z, weight, bias):
    if not z.is_cuda or z.dtype != torch.float32:
        raise TypeError(f"z must be a float32 CUDA tensor, got {z.dtype} on {z.device}")
    if z.dim() != 4 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (N, C, H, W) tensor, got {tuple(z.shape)}")
    c = z.shape[1]
    for p in (weight, bias):
        if (p.shape != (c,) or p.dtype != torch.float32 or p.device != z.device
                or not p.is_contiguous()):
            raise ValueError(f"weight and bias must be contiguous float32 ({c},) on {z.device}")


def _native_plan_checked(z, backward: bool) -> NormActPlan:
    n, c, h, w = z.shape
    plan = native_plan(h * w, backward)
    if n * c * max(plan.cluster, 1) >= 2 ** 31:
        raise ValueError(f"{n * c} planes too many for one launch")
    return plan


def native_forward_cuda(z, weight, bias, eps=1e-5, negative_slope=0.01):
    """Launch K7 on the current stream of z's device: (y, mean, rstd)."""
    global native_launches
    _check_native(z, weight, bias)
    plan = _native_plan_checked(z, False)
    n, c, h, w = z.shape
    y = torch.empty_like(z)
    mean, rstd = torch.empty((2, n * c), dtype=torch.float32, device=z.device)
    _build.cuda_call("csof_inorm_lrelu_forward", z.device, z.data_ptr(), weight.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n * c, c,
                     h * w, plan.cluster, plan.slice, plan.smem_bytes, eps, negative_slope)
    native_launches += 1
    return y, mean, rstd


def native_backward_cuda(z, dy, mean, rstd, weight, bias, negative_slope=0.01):
    """Launch K7 dx on the current stream of z's device: (dz, the sums of da
    a plane, the sums of da * zh a plane)."""
    global native_bwd_launches
    _check_native(z, weight, bias)
    if dy.shape != z.shape or dy.dtype != z.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous float32 {tuple(z.shape)}")
    n, c, h, w = z.shape
    for t in (mean, rstd):
        if t.shape != (n * c,) or t.dtype != z.dtype or t.device != z.device:
            raise ValueError(f"mean and rstd must be float32 ({n * c},) on {z.device}")
    plan = _native_plan_checked(z, True)
    dz = torch.empty_like(z)
    pda, pdah = torch.empty((2, n * c), dtype=torch.float32, device=z.device)
    _build.cuda_call("csof_inorm_lrelu_backward", z.device, z.data_ptr(), dy.data_ptr(),
                     mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                     dz.data_ptr(), pda.data_ptr(), pdah.data_ptr(), n * c, c, h * w,
                     plan.cluster, plan.slice, plan.smem_bytes, negative_slope)
    native_bwd_launches += 1
    return dz, pda, pdah


class InstanceNormLeakyReLUFunction(torch.autograd.Function):
    """K7 with its backward K7 dx on CUDA tensors, the plain versions on CPU
    tensors (so the CPU runs exactly the formulas the kernels are held to).
    It saves z and the per-plane mean and rstd; dgamma and dbeta are the
    per-plane sums added up over N, in order.

    ``InstanceNormLeakyReLUFunction.apply(z, weight, bias, eps, negative_slope)``."""

    @staticmethod
    def forward(ctx, z, weight, bias, eps: float, negative_slope: float):
        if z.is_cuda:
            y, mean, rstd = native_forward_cuda(z, weight, bias, eps, negative_slope)
        elif z.device.type == "cpu":
            y, mean, rstd = native_forward_plain(z, weight, bias, eps, negative_slope)
        else:
            raise ValueError(f"unsupported device {z.device}")
        ctx.save_for_backward(z, weight, bias, mean, rstd)
        ctx.negative_slope = negative_slope
        return y

    @staticmethod
    def backward(ctx, dy):
        z, weight, bias, mean, rstd = ctx.saved_tensors
        fn = native_backward_cuda if dy.is_cuda else native_backward_plain
        dz, pda, pdah = fn(z, dy.contiguous(), mean, rstd, weight, bias, ctx.negative_slope)
        n, c = z.shape[:2]
        need = ctx.needs_input_grad
        dw = pdah.view(n, c).sum(0).to(weight.dtype) if need[1] else None
        db = pda.view(n, c).sum(0).to(bias.dtype) if need[2] else None
        return dz if need[0] else None, dw, db, None, None


def native_norm_act(z, weight, bias, eps=1e-5, negative_slope=0.01):
    """``leaky_relu(InstanceNorm(z))`` of a float32 (N, C, H, W) z,
    differentiable. A CUDA tensor runs kernels K7 and K7 dx; a CPU tensor
    runs their plain versions."""
    return InstanceNormLeakyReLUFunction.apply(z, weight, bias, eps, negative_slope)
