"""K4: the windowed NCC map on Hopper (``csrc/ncc.cu``), its plain PyTorch
version and the NCC loss over it.

Replaces ``csof_tpu/ops/pallas/ncc.py`` ``ncc_map_pallas`` (and
``ncc_loss_pallas`` around it): for float32 planes ``(N, H, W)`` of I and J,
five zero-padded window x window box sums of (I, J, I^2, J^2, IJ), taken
along H then along W, then ``cc = cross^2 / (var_I var_J + eps)``. It is a
standalone op, as in the JAX package, where no training loss calls it
(``ops.losses.ncc_loss`` computes the same map with another summation
order). Forward only, as the TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

MAX_WINDOW = 15  # csrc/ncc.cu kMaxR = 7


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


def ncc_map_cuda(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                 eps: float = 1e-3) -> torch.Tensor:
    """Launch K4 on the current stream of pred's device."""
    global launches
    for t in (pred, target):
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"pred and target must be float32 CUDA tensors, got {t.dtype} "
                            f"on {t.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"pred and target must be contiguous (N, H, W), got "
                             f"{tuple(t.shape)}")
    if target.shape != pred.shape or target.device != pred.device:
        raise ValueError(f"pred {tuple(pred.shape)} and target {tuple(target.shape)} differ")
    n, h, w = pred.shape
    if not (window % 2 == 1 and 1 <= window <= MAX_WINDOW):
        raise ValueError(f"window must be odd and at most {MAX_WINDOW}, got {window}")
    if n == 0 or h == 0 or w == 0 or n > 65535 or -(-h // 32) > 65535:
        raise ValueError(f"shape {tuple(pred.shape)} out of range for one launch")
    out = torch.empty_like(pred)
    lib = _build.load_library()
    with torch.cuda.device(pred.device):
        err = lib.csof_ncc_map_forward(pred.data_ptr(), target.data_ptr(), out.data_ptr(), n, h,
                                       w, window, eps, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "csof_ncc_map_forward")
    launches += 1
    return out


def ncc_map(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
            eps: float = 1e-3) -> torch.Tensor:
    """(N, H, W) planes -> the per-pixel cc map (N, H, W) float32. CUDA
    tensors run kernel K4; CPU tensors run its plain version."""
    if pred.is_cuda:
        return ncc_map_cuda(pred.float().contiguous(), target.float().contiguous(), window, eps)
    if pred.device.type == "cpu":
        return ncc_map_plain(pred, target, window, eps)
    raise ValueError(f"unsupported device {pred.device}")


def ncc_loss_kernel(pred: torch.Tensor, target: torch.Tensor, window: int = 9,
                    eps: float = 1e-3) -> torch.Tensor:
    """``ncc_loss_pallas``: 1 - mean(clip(cc, 0.001, 0.999)) over the planes
    of channels-last ``(N, H, W, C)`` batches."""
    n, h, w, c = pred.shape
    flat_p = pred.permute(0, 3, 1, 2).reshape(n * c, h, w)
    flat_t = target.permute(0, 3, 1, 2).reshape(n * c, h, w)
    return 1.0 - ncc_map(flat_p, flat_t, window, eps).clamp(0.001, 0.999).mean()
