"""K6: stride-1 3x3 SAME convolution on Hopper's tensor cores
(``csrc/conv3x3.cu``, an implicit GEMM on ``wgmma``: bf16 as it is, float32
as 3xTF32), its plain PyTorch version, and the ``torch.autograd.Function``
that runs it in both directions.

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
convolution in x's dtype, summed in float32 and rounded once to the dtype
(the JAX package leaves it to XLA), which on a CUDA tensor is the kernel
pair K6 dw (``csrc/conv3x3_wgrad.cu``: split over the pixels, then the
splits summed in a fixed order; ``wgrad_plan``); db is the cotangent summed
in the dtype, then cast to float32.

The wrapper packs the weight once per call (``pack_weight``), as tensor ops,
into the order the kernel's shared-memory descriptors read: in x's dtype
(float32 as a tf32-rounded hi part and the exact rest), zero-padded to the
kernel's channel chunk and block width, the dx's flip folded in. It is the
counterpart of the JAX package's ``w2`` transpose outside its kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build
from csof_tpu_torch.ops.kernels.corr import _DTYPE_CODES, _acc, dtype_code

#: launches of the CUDA kernel as a forward since the last reset (set to 0 to reset)
launches = 0
#: launches of the CUDA kernel as a backward (dx) since the last reset
bwd_launches = 0
#: calls of the weight-gradient kernel pair (K6 dw) since the last reset
dw_launches = 0

#: K6 dw's chunk of pixels: output rows x columns of one plane
#: (csrc/conv3x3_wgrad.cu kGTR and kGTW: change the three together)
WGRAD_TILE = (2, 32)


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


def block_n(co: int) -> int:
    """The kernel's block width (its GEMM N) for Co output channels: one
    block covers all of Co up to 128, blocks of 128 tile a larger Co."""
    return 32 if co <= 32 else 64 if co <= 64 else 128


def _tf32_hi(v: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds, into ``out``."""
    torch.bitwise_and(v.view(torch.int32) + 0x1000, ~0x1FFF, out=out.view(torch.int32))
    return out


def pack_weight(weight: torch.Tensor, dtype: torch.dtype, dx: bool = False):
    """(packed weight, block width) for the kernel. weight is the forward's
    (Co, Ci, 3, 3) float32; with ``dx`` the conv is the flipped,
    in/out-transposed weight's (``flipped_weight``). Layout: (Co blocks,
    Ci chunks, [hi, lo for float32,] 9 taps, 2 groups, block width, 16 bytes
    of channels), a chunk being 32 bytes of channels (8 float32, 16 bf16);
    hi + lo is the float32 weight exactly. A few launches: the pad, then the
    split or the cast straight into the packed layout."""
    w = weight.flip(2, 3).transpose(0, 1) if dx else weight
    co, ci = w.shape[:2]
    nb, epc = block_n(co), 16 // torch.empty((), dtype=dtype).element_size()
    nbk, nch = -(-co // nb), -(-ci // (2 * epc))
    wp = F.pad(w, (0, 0, 0, 0, 0, nch * 2 * epc - ci, 0, nbk * nb - co))
    v = wp.view(nbk, nb, nch, 2, epc, 9).permute(0, 2, 5, 3, 1, 4)
    if dtype == torch.bfloat16:
        return torch.empty(v.shape, dtype=dtype, device=w.device).copy_(v), nb
    out = torch.empty((nbk, nch, 2, *v.shape[2:]), dtype=torch.float32, device=w.device)
    hi = _tf32_hi(v, out[:, :, 0])
    torch.sub(v, hi, out=out[:, :, 1])
    return out, nb


def _launch(x, weight, bias, out_f32, dx=False):
    """K6 on x; with ``dx``, x is dy and the conv's weight the flipped
    forward ``weight``."""
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be a float32 or bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, Ci, H, W) tensor, got {tuple(x.shape)}")
    n, ci, h, w = x.shape
    co = weight.shape[1 if dx else 0]
    params = (weight,) if bias is None else (weight, bias)
    want = (ci, co, 3, 3) if dx else (co, ci, 3, 3)
    if weight.shape != want or (bias is not None and bias.shape != (co,)):
        raise ValueError(f"weight must be (Co, {ci}, 3, 3) and bias (Co,), got "
                         f"{tuple(weight.shape)}, {None if bias is None else tuple(bias.shape)}")
    for p in params:
        if p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError("weight and bias must be contiguous float32 on the device of x")
    if n == 0 or h == 0 or w == 0 or n > 65535:
        raise ValueError(f"batch {n} out of range for one launch, or an empty input")
    out = torch.empty((n, co, h, w), dtype=torch.float32 if out_f32 else x.dtype,
                      device=x.device)
    packed, nb = pack_weight(weight, x.dtype, dx)
    _build.cuda_call("csof_conv3x3_forward", x.device, x.data_ptr(), packed.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(), n, ci, h, w,
                     co, nb, dtype_code(x), int(out_f32), int(dx))
    return out


def conv3x3_cuda(x, weight, bias=None, out_f32=False):
    """Launch K6 on the current stream of x's device."""
    global launches
    out = _launch(x, weight, bias, out_f32)
    launches += 1
    return out


def conv3x3_dx_cuda(dy, weight):
    """dx of K6: K6 launched on dy (in x's dtype) with the flipped weight
    (folded into the packing), as ``conv3x3_dx_kernel`` (the same code under
    its own name)."""
    global bwd_launches
    out = _launch(dy, weight, None, False, dx=True)
    bwd_launches += 1
    return out


def conv3x3_dx_plain(dy, weight):
    """dx of K6 in plain PyTorch, by the same formula as the kernel's."""
    return conv3x3_plain(dy, flipped_weight(weight))


class WgradPlan(NamedTuple):
    """How one K6 dw call covers its work: blocks of ``channels`` input
    channels x ``co_block`` output channels, and the ``chunks`` pixel chunks
    (``WGRAD_TILE`` rows x columns of one plane, plane-major, then rows,
    then columns) cut into ``splits`` runs, one a block; ``scratch`` float32
    partial sums (splits x Co x Ci x 9)."""

    channels: int
    co_block: int
    tiles: int
    row_tiles: int
    col_tiles: int
    chunks: int
    splits: int
    scratch: int

    def split_chunks(self, s: int) -> range:
        """The chunks split ``s`` sums, as the kernel computes them."""
        return range(self.chunks * s // self.splits, self.chunks * (s + 1) // self.splits)

    def chunk_origin(self, q):
        """(plane, first row, first column) of chunk ``q`` (an int or an
        integer array), as the kernel decodes it."""
        t = q // self.col_tiles
        return (t // self.row_tiles, t % self.row_tiles * WGRAD_TILE[0],
                q % self.col_tiles * WGRAD_TILE[1])


def wgrad_plan(n: int, ci: int, co: int, h: int, w: int, dtype: torch.dtype,
               sms: int = 132) -> WgradPlan:
    """K6 dw's plan for x (n, ci, h, w) and dy (n, co, h, w): 8 input
    channels a block where Ci <= 8, else 16; 32 output channels where a
    float32 Co <= 32 (dy's hi and lo parts stacked in the 64 rows of one
    wgmma), else 64; the chunks split into as many runs as leave one block
    for each of the ``sms`` multiprocessors (a block fills one), at least
    one and at most one a chunk."""
    if min(n, ci, co, h, w) <= 0:
        raise ValueError(f"empty conv: x ({n}, {ci}, {h}, {w}), Co {co}")
    channels = 8 if ci <= 8 else 16
    co_block = 32 if dtype == torch.float32 and co <= 32 else 64
    tiles = -(-ci // channels) * -(-co // co_block)
    row_tiles, col_tiles = -(-h // WGRAD_TILE[0]), -(-w // WGRAD_TILE[1])
    chunks = n * row_tiles * col_tiles
    splits = max(1, min(sms // tiles, chunks, 65535))
    return WgradPlan(channels, co_block, tiles, row_tiles, col_tiles, chunks, splits,
                     splits * co * ci * 9)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_dw_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K6 dw on the current stream of x's device: x (N, Ci, H, W) and dy
    (N, Co, H, W), contiguous, both float32 or both bfloat16 -> dw (Co, Ci,
    3, 3) float32 (bf16: rounded once to bf16). Two launches: the split
    sums into scratch, then their sum in split order."""
    global dw_launches
    if not x.is_cuda or x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must be float32 or bfloat16 CUDA tensors of one dtype, got "
                        f"{x.dtype} on {x.device} and {dy.dtype}")
    if (x.dim() != 4 or dy.dim() != 4 or not x.is_contiguous() or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError(f"x and dy must be contiguous (N, C, H, W) tensors on one device, got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    n, ci, h, w = x.shape
    co = dy.shape[1]
    if dy.shape != (n, co, h, w) or min(n, ci, co, h, w) <= 0:
        raise ValueError(f"dy must be (N, Co, H, W) of x's N, H, W, nothing empty; got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    plan = wgrad_plan(n, ci, co, h, w, x.dtype, _sm_count(x.device.index))
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    _build.cuda_call("csof_conv3x3_wgrad", x.device, x.data_ptr(), dy.data_ptr(),
                     scratch.data_ptr(), dw.data_ptr(), n, ci, h, w, co, plan.splits,
                     dtype_code(x))
    dw_launches += 1
    return dw


def conv3x3_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K6 dw in plain PyTorch: the weight gradient of the 3x3 conv summed in
    float32 (float64 for float64 input) and rounded once to x's dtype."""
    co, ci = dy.shape[1], x.shape[1]
    return torch.nn.grad.conv2d_weight(_acc(x), (co, ci, 3, 3), _acc(dy), padding=1).to(x.dtype)


class Conv3x3Function(torch.autograd.Function):
    """K6 with its backward: the kernels (K6, K6 dx, K6 dw) on CUDA tensors,
    the plain versions on CPU tensors (so the CPU runs exactly the dx and dw
    formulas the kernels are held against).

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
            dw = (conv3x3_dw_cuda if dy.is_cuda else conv3x3_dw_plain)(x, dy).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum((0, 2, 3)).to(weight.dtype)
        return dx, dw, db, None


def conv3x3(x, weight, bias=None, out_f32=False):
    """(N, Ci, H, W) -> (N, Co, H, W), differentiable. A CUDA tensor runs
    kernel K6 (forward, dx and dw); a CPU tensor runs its plain versions."""
    return Conv3x3Function.apply(x, weight, bias, out_f32)
