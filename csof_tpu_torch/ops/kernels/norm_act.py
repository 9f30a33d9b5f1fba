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

import functools
from dataclasses import dataclass

import torch

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, MAX_SMEM_BYTES, dtype_code
from csof_tpu_torch.ops.kernels.skipfuse import forward_only

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

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
