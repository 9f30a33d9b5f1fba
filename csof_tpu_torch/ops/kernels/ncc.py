"""K4: the windowed NCC map on Hopper (``csrc/ncc.cu``), its plain PyTorch
version and the NCC loss over it.

Replaces ``csof_tpu/ops/pallas/ncc.py`` ``ncc_map_pallas`` (and
``ncc_loss_pallas`` around it): for planes ``(N, H, W)`` of I and J, five
zero-padded window x window box sums of (I, J, I^2, J^2, IJ), taken along H
then along W, then ``cc = cross^2 / (var_I var_J + eps)``. Any window >= 1:
the box spans offsets ``-(w // 2) ... w - 1 - w // 2``, as the TPU kernel's
padded slices do. It is a standalone op, as in the JAX package, where no
training loss calls it (``ops.losses.ncc_loss`` computes the same map with
another summation order). Forward only, as the TPU kernel.

The kernel has two modes: the float32 map (``ncc_map_cuda``), and the loss
``1 - mean(clamp(cc, 0.001, 0.999))`` over the planes of a channels-last
batch in one launch (``ncc_loss_kernel``), which reads float32, bf16 or fp16
in place and writes no map. ``ncc_plan`` decides how a launch covers the
planes; the kernel refuses any other plan. Where no plan of the one-pass
kernel fits shared memory (a window above 75 on a wide plane), the plan is
the two-pass path: the vertical sums go through a scratch buffer in device
memory (``csof_ncc_forward_wide``), with the same roundings in the same
order, so K4 computes every window the JAX kernel computes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernels since the last reset (set to 0 to reset):
#: one a call on the one-pass path, two on the two-pass path
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: csrc/ncc.cu: chunks in the shared ring, most threads a block, the window
#: compiled with a register ring (its chunks are that many rows), the rows
#: of a chunk for any other window, the most dynamic shared memory a block
#: asks for
STAGES, MAX_THREADS, SPECIAL_WINDOW, GENERIC_CHUNK = 2, 256, 9, 8
MAX_DYNAMIC_SMEM = 226 * 1024
#: blocks a launch aims at: three for each of an H100's 132 multiprocessors
TARGET_BLOCKS = 3 * 132
#: the most chunks of rows a band takes
MAX_BAND_CHUNKS = 8
#: the two-pass path's grid: at most this many blocks, each taking every
#: blocks-th row of the planes
WIDE_MAX_BLOCKS = 32 * 132


def halo_cols(window: int) -> int:
    """Columns a tile reaches on either side: w // 2 rounded up to 4."""
    return -(-(window // 2) // 4) * 4


def chunk_rows(window: int) -> int:
    """Input rows a chunk of the kernel's shared ring holds."""
    return SPECIAL_WINDOW if window == SPECIAL_WINDOW else GENERIC_CHUNK


def smem_bytes(window: int, threads: int, tile_cols: int, itemsize: int) -> int:
    """``ncc_smem_bytes`` in csrc/ncc.cu: the ring of input chunks (I and J
    rows of threads + 32 / itemsize elements), the five vertical sums of a
    chunk's rows over the tile and its halo, and, for a window other than
    9, each column's ring of window x 5 values."""
    chunk = chunk_rows(window)
    out = STAGES * chunk * 2 * (threads + 32 // itemsize) * itemsize
    out += chunk * 5 * (tile_cols + 2 * halo_cols(window)) * 4
    if window != SPECIAL_WINDOW:
        out += window * 5 * threads * 4
    return out


@dataclass(frozen=True)
class NccPlan:
    """How K4 covers ``planes`` planes of ``h x w``. ``path`` "fused": one
    pass, ``threads`` a block (one a column of a tile with its halo), tiles
    of ``tile_cols`` output columns, bands of ``band_rows`` output rows,
    ``smem_bytes`` of dynamic shared memory a block; ``blocks`` = planes x
    bands x tiles. ``path`` "two_pass": the vertical sums through device
    memory, a row at a time (tile_cols = w, band_rows = 1, no shared
    memory), ``blocks`` blocks of ``threads`` taking every blocks-th row."""

    threads: int
    tile_cols: int
    band_rows: int
    tiles: int
    bands: int
    blocks: int
    smem_bytes: int
    path: str = "fused"


def two_pass_plan(planes: int, h: int, w: int) -> NccPlan:
    """The two-pass path's plan: a thread a column (at most MAX_THREADS, in
    whole warps), a block a row, at most WIDE_MAX_BLOCKS blocks."""
    threads = min(MAX_THREADS, -(-w // 32) * 32)
    return NccPlan(threads, w, 1, 1, h, min(planes * h, WIDE_MAX_BLOCKS), 0, "two_pass")


@functools.lru_cache(maxsize=256)
def ncc_plan(planes: int, h: int, w: int, window: int, itemsize: int,
             band_rows: int | None = None) -> NccPlan:
    """K4's plan: one tile across the plane where its width fits a block
    (at most MAX_THREADS columns), else tiles of the widest block whose
    shared memory fits; bands of whole chunks, at least window - 1 rows
    where the plane has them (the halo at most doubles a band's reads), and
    as many as still give TARGET_BLOCKS blocks (at most MAX_BAND_CHUNKS
    chunks). ``band_rows`` (a multiple of the chunk) overrides the bands.
    Where no block's rings fit shared memory, or the planes need more blocks
    than one launch takes, the two-pass path (``two_pass_plan``; it ignores
    ``band_rows``). Raises ValueError only for an empty input, a window
    below 1 and a ``band_rows`` off the chunk."""
    if planes <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"empty input: {planes} planes of {h} x {w}")
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    chunk = chunk_rows(window)
    if band_rows is not None and (band_rows <= 0 or band_rows % chunk):
        raise ValueError(f"band_rows must be a positive multiple of {chunk}, got {band_rows}")
    halo = halo_cols(window)
    candidates = []
    if -(-w // 32) * 32 <= MAX_THREADS:
        candidates.append((-(-w // 32) * 32, -(-w // 4) * 4))
    for threads in (256, 128, 64, 32):
        if (threads - 2 * halo) // 4 >= 1:
            candidates.append((threads, (threads - 2 * halo) // 4 * 4))
    fits = [(t, c) for t, c in candidates
            if smem_bytes(window, t, c, itemsize) <= MAX_DYNAMIC_SMEM]
    if not fits:
        return two_pass_plan(planes, h, w)
    threads, tile_cols = fits[0]
    tiles = -(-w // tile_cols)
    if band_rows is None:
        most = -(-h // chunk)
        least = max(1, min(-(-(window - 1) // chunk), most))
        m = least
        for cand in range(max(least, min(most, MAX_BAND_CHUNKS)), least - 1, -1):
            if planes * -(-h // (cand * chunk)) * tiles >= TARGET_BLOCKS:
                m = cand
                break
        band_rows = m * chunk
    bands = -(-h // band_rows)
    blocks = planes * bands * tiles
    if blocks >= 2 ** 31:
        return two_pass_plan(planes, h, w)
    return NccPlan(threads, tile_cols, band_rows, tiles, bands, blocks,
                   smem_bytes(window, threads, tile_cols, itemsize))


def _box1d(x: torch.Tensor, window: int, axis: int) -> torch.Tensor:
    """Zero-padded box sum along ``axis``: the shifted slices added one
    after another, first to last, as the TPU kernel adds them."""
    pad = window // 2
    pads = [0, 0] * x.dim()
    pads[2 * (x.dim() - 1 - axis)] = pads[2 * (x.dim() - 1 - axis) + 1] = pad
    xp = F.pad(x, pads)
    n = x.shape[axis]
    out = xp.narrow(axis, 0, n)
    for o in range(1, window):
        out = out + xp.narrow(axis, o, n)
    return out


def ncc_map_plain(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                  eps: float = 1e-3) -> torch.Tensor:
    """The K4 function in plain PyTorch, in the kernel's order of operations."""
    i, j = pred.float(), target.float()
    stats = torch.stack([i, j, i * i, j * j, i * j])  # (5, N, H, W)
    i_sum, j_sum, i2, j2, ij = _box1d(_box1d(stats, window, 2), window, 3)
    win = float(window * window)
    i_mu, j_mu = i_sum / win, j_sum / win
    cross = ij - j_mu * i_sum - i_mu * j_sum + i_mu * j_mu * win
    i_var = i2 - 2 * i_mu * i_sum + i_mu * i_mu * win
    j_var = j2 - 2 * j_mu * j_sum + j_mu * j_mu * win
    return (cross * cross) / (i_var * j_var + eps)


def _check(pred: torch.Tensor, target: torch.Tensor, dims: int, layout: str) -> None:
    if not (pred.is_cuda and target.is_cuda) or pred.dtype not in _DTYPE_CODES \
            or target.dtype != pred.dtype:
        raise TypeError(f"pred and target must be CUDA tensors of one dtype (float32, bfloat16 "
                        f"or float16), got {pred.dtype} on {pred.device}, {target.dtype} on "
                        f"{target.device}")
    if pred.dim() != dims or target.shape != pred.shape or target.device != pred.device \
            or not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError(f"pred and target must be contiguous {layout} tensors of one shape "
                         f"on one device, got {tuple(pred.shape)} and {tuple(target.shape)}")


def launch(pred: torch.Tensor, target: torch.Tensor, cc: torch.Tensor | None,
           loss: torch.Tensor | None, planes: int, c: int, window: int, eps: float,
           plan: NccPlan) -> None:
    """K4 on checked inputs under ``plan``: the map into ``cc``, or the loss
    into ``loss[0]`` with one partial a block in ``loss[1:]``. The two-pass
    path takes a scratch buffer of the five vertical sums and counts its
    two kernels as two launches."""
    global launches
    h, w = pred.shape[1], pred.shape[2]
    outs = (0 if cc is None else cc.data_ptr(), 0 if loss is None else loss.data_ptr())
    if plan.path == "two_pass":
        scratch = torch.empty(5 * planes * h * w, dtype=torch.float32, device=pred.device)
        _build.cuda_call("csof_ncc_forward_wide", pred.device, pred.data_ptr(),
                         target.data_ptr(), *outs, scratch.data_ptr(), planes, c, h, w, window,
                         eps, _DTYPE_CODES[pred.dtype], plan.threads, plan.blocks)
        launches += 2  # the vertical pass, then the horizontal pass
    else:
        _build.cuda_call("csof_ncc_forward", pred.device, pred.data_ptr(), target.data_ptr(),
                         *outs, planes, c, h, w, window, eps, _DTYPE_CODES[pred.dtype],
                         plan.threads, plan.tile_cols, plan.band_rows, plan.smem_bytes)
        launches += 1


def ncc_map_cuda(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                 eps: float = 1e-3) -> torch.Tensor:
    """Launch K4 on the current stream of pred's device: (N, H, W) planes of
    float32, bf16 or fp16 -> the float32 cc map."""
    _check(pred, target, 3, "(N, H, W)")
    n, h, w = pred.shape
    plan = ncc_plan(n, h, w, window, pred.element_size())
    out = torch.empty((n, h, w), dtype=torch.float32, device=pred.device)
    launch(pred, target, out, None, n, 1, window, eps, plan)
    return out


def ncc_loss_cuda(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                  eps: float = 1e-3) -> torch.Tensor:
    """Launch K4 in loss mode: channels-last (N, H, W, C) batches read in
    place -> 0-dim float32 ``1 - mean(clamp(cc, 0.001, 0.999))``."""
    _check(pred, target, 4, "(N, H, W, C)")
    n, h, w, c = pred.shape
    plan = ncc_plan(n * c, h, w, window, pred.element_size())
    buf = torch.empty(1 + plan.blocks, dtype=torch.float32, device=pred.device)
    launch(pred, target, None, buf, n * c, c, window, eps, plan)
    return buf[0]


def division_mismatches(window: int = SPECIAL_WINDOW, device="cuda") -> int:
    """How many of the 2^32 float32 values x the kernel's division by
    window^2 without a divide (window 9's path) rounds otherwise than IEEE
    division: 0 where that path is exact."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _build.cuda_call("csof_ncc_check_division", count.device, window, count.data_ptr())
    return int(count.item())


def _kernel_dtype(pred: torch.Tensor, target: torch.Tensor):
    """pred and target contiguous in one dtype the kernel reads (float32
    where they differ or the dtype is another)."""
    if pred.dtype != target.dtype or pred.dtype not in _DTYPE_CODES:
        pred, target = pred.float(), target.float()
    return pred.contiguous(), target.contiguous()


def ncc_map(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
            eps: float = 1e-3) -> torch.Tensor:
    """(N, H, W) planes -> the per-pixel cc map (N, H, W) float32. CUDA
    tensors run kernel K4; CPU tensors run its plain version."""
    if pred.is_cuda:
        return ncc_map_cuda(*_kernel_dtype(pred, target), window, eps)
    if pred.device.type == "cpu":
        return ncc_map_plain(pred, target, window, eps)
    raise ValueError(f"unsupported device {pred.device}")


def ncc_loss_kernel(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                    eps: float = 1e-3) -> torch.Tensor:
    """``ncc_loss_pallas``: 1 - mean(clip(cc, 0.001, 0.999)) over the planes
    of channels-last ``(N, H, W, C)`` batches. CUDA tensors run K4 once, in
    loss mode; CPU tensors run the plain version."""
    if pred.is_cuda:
        return ncc_loss_cuda(*_kernel_dtype(pred, target), window, eps)
    if pred.device.type != "cpu":
        raise ValueError(f"unsupported device {pred.device}")
    n, h, w, c = pred.shape
    flat_p = pred.permute(0, 3, 1, 2).reshape(n * c, h, w)
    flat_t = target.permute(0, 3, 1, 2).reshape(n * c, h, w)
    return 1.0 - ncc_map_plain(flat_p, flat_t, window, eps).clamp(0.001, 0.999).mean()
