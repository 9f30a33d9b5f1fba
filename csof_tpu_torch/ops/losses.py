"""The SegFlow and U-Net training losses (port of ``csof_tpu/ops/losses.py``).

Conventions as in the JAX package: logits are channels-last
``(N, *spatial, C)``; targets are integer label maps ``(N, *spatial)`` unless
stated; reductions return scalars. Ported: the soft confusion statistics,
soft Dice, cross-entropy with an ignore index, nnU-Net's Dice + CE and its
deep-supervision weighting, the windowed NCC (2D and 3D), the spatial and
temporal flow-smoothness penalties, and RAFT's sequence loss.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from csof_tpu_torch.parallel.mesh import Mesh, global_batch_dice_stats


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot; labels outside [0, num_classes) give a zero row, as
    ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def get_tp_fp_fn_tn(probs: torch.Tensor, target: torch.Tensor,
                    axes: Sequence[int] | None = None, mask: torch.Tensor | None = None):
    """Soft confusion-matrix pieces per class, summed over ``axes`` (default:
    the spatial axes). probs ``(N, *spatial, C)``; target ``(N, *spatial)``
    int or ``(N, *spatial, C)`` one-hot; mask broadcasts against probs (a
    mask without the class axis gets one)."""
    c = probs.shape[-1]
    y = one_hot(target, c) if target.dim() == probs.dim() - 1 else target.to(probs.dtype)
    if axes is None:
        axes = tuple(range(1, probs.dim() - 1))
    axes = tuple(axes)
    if mask is not None:
        # the masked tn is no sum identity: each piece is summed directly
        m = mask[..., None] if mask.dim() == probs.dim() - 1 else mask
        probs = probs * m
        y = y * m
        return ((probs * y).sum(axes), (probs * (1 - y)).sum(axes),
                ((1 - probs) * y).sum(axes), ((1 - probs) * (1 - y)).sum(axes))
    tp = (probs * y).sum(axes)
    sp = probs.sum(axes)
    sy = y.sum(axes)
    count = 1
    for a in axes:
        count *= probs.shape[a]
    return tp, sp - tp, sy - tp, count - sp - sy + tp


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, batch_dice: bool = False,
                   do_bg: bool = False, smooth: float = 1e-5, mask: torch.Tensor | None = None,
                   probs_input: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
    """1 - mean soft Dice over the classes (background dropped unless
    ``do_bg``). ``batch_dice`` sums the statistics over the leading axis
    too, and with the ``mesh`` of a process group over the global batch
    (``global_batch_dice_stats``), as the JAX loss sums them over its
    sharded batch; ``probs_input`` takes probabilities instead of logits."""
    probs = logits if probs_input else torch.softmax(logits, -1)
    if batch_dice and mesh is not None and mesh.group is not None:
        tp, fp, fn, _ = get_tp_fp_fn_tn(probs, target, mask=mask)
        tp, fp, fn = global_batch_dice_stats(tp, fp, fn, mesh)
    else:
        first = 0 if batch_dice else 1
        tp, fp, fn, _ = get_tp_fp_fn_tn(probs, target, axes=range(first, probs.dim() - 1),
                                        mask=mask)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    if not do_bg:
        dc = dc[..., 1:]
    return 1 - dc.mean()


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       ignore_index: int | None = None) -> torch.Tensor:
    """Mean cross-entropy, channels-last; with ``ignore_index`` the mean runs
    over the other pixels only (at least one in the divisor)."""
    y = one_hot(target.clamp_min(0), logits.shape[-1]).to(logits.dtype)
    nll = torch.logsumexp(logits, -1) - (logits * y).sum(-1)
    if ignore_index is not None:
        valid = (target != ignore_index).to(logits.dtype)
        return (nll * valid).sum() / valid.sum().clamp_min(1.0)
    return nll.mean()


def dice_and_ce_loss(logits: torch.Tensor, target: torch.Tensor, weight_ce: float = 1.0,
                     weight_dice: float = 1.0, batch_dice: bool = True,
                     smooth: float = 1e-5, mesh: Mesh | None = None) -> torch.Tensor:
    """nnU-Net's Dice + CE: mean cross-entropy plus batch soft Dice
    (the 2D recipe's default, smooth 1e-5, over the global batch of
    ``mesh``), channels-last."""
    return (weight_ce * cross_entropy_loss(logits, target)
            + weight_dice * soft_dice_loss(logits, target, batch_dice=batch_dice, smooth=smooth,
                                           mesh=mesh))


def deep_supervision_weights(num_outputs: int, mask_last: bool = True) -> np.ndarray:
    """Host weights 1/2^i over the deep-supervision scales, full resolution
    first, normalized to sum 1; with ``mask_last`` and more than two scales
    the lowest-resolution scale gets 0."""
    w = np.array([1 / (2 ** i) for i in range(num_outputs)])
    if mask_last and num_outputs > 2:
        w[-1] = 0.0
    return w / np.sum(w)


def deep_supervision_loss(outputs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
                          loss_fn, weights=None) -> torch.Tensor:
    """Weighted sum of ``loss_fn`` over the scales. The weights are host
    values and a zero-weight scale is skipped: its head gets no gradient
    (the optimizer still decays it, as optax does)."""
    if weights is None:
        weights = deep_supervision_weights(len(outputs))
    total = 0.0
    for wt, o, t in zip(np.asarray(weights), outputs, targets):
        if float(wt) != 0.0:
            total = total + float(wt) * loss_fn(o, t)
    return total


def downsample_seg_for_ds(seg: torch.Tensor, pool_kernel_sizes) -> list[torch.Tensor]:
    """An integer seg map ``(N, *spatial)`` at every deep-supervision scale,
    by strided slicing with each pool's strides; one map per head (the
    bottleneck's scale is dropped)."""
    out = [seg]
    for strides in pool_kernel_sizes:
        out.append(out[-1][(slice(None),) + tuple(slice(None, None, s) for s in strides)])
    return out[:-1]


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-padded "SAME" window sums over the spatial axes of ``(N, C, H,
    W)`` or ``(N, C, D, H, W)``: average pooling with a divisor of 1 sums
    each window directly (no convolution, so no TF32 on the card)."""
    nd = x.dim() - 2
    lo = (window - 1) // 2
    x = F.pad(x, (lo, window - 1 - lo) * nd)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, window, stride=1, divisor_override=1)


def ncc_loss(pred: torch.Tensor, target: torch.Tensor, window: int = 9, eps: float = 1e-3,
             clip: tuple[float, float] | None = (0.001, 0.999),
             reduction: str = "mean") -> torch.Tensor:
    """1 - windowed local NCC (squared correlation over a window x window
    box, clipped to ``clip``); ``reduction="none"`` returns the per-pixel
    map. pred, target ``(N, H, W, C)`` or ``(N, D, H, W, C)``, computed in
    float32."""
    win_size = float(window ** (pred.dim() - 2))
    i = pred.float().movedim(-1, 1)
    j = target.float().movedim(-1, 1)
    c = i.shape[1]
    sums = _box_sum(torch.cat([i, j, i * i, j * j, i * j], 1), window)
    i_sum, j_sum, i2_sum, j2_sum, ij_sum = sums.split(c, 1)
    i_mu, j_mu = i_sum / win_size, j_sum / win_size
    cross = ij_sum - j_mu * i_sum - i_mu * j_sum + i_mu * j_mu * win_size
    i_var = i2_sum - 2 * i_mu * i_sum + i_mu * i_mu * win_size
    j_var = j2_sum - 2 * j_mu * j_sum + j_mu * j_mu * win_size
    cc = (cross * cross) / (i_var * j_var + eps)
    if clip is not None:
        cc = cc.clamp(clip[0], clip[1])
    cc = cc.movedim(1, -1)
    if reduction == "none":
        return 1.0 - cc
    return 1.0 - cc.mean()


def _central_gradient(x: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5 * (x[i+1] - x[i-1]) along ``axis`` with replicate padding."""
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], axis)
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def spatial_gradient_penalty(flow: torch.Tensor, order: int = 2, reduction: str = "mean",
                             channel_axis: int = -1) -> torch.Tensor:
    """Mean |central spatial gradient|^order of a flow over its non-batch,
    non-channel axes, averaged over those axes and the flow channels;
    ``reduction="none"`` returns the ``(N, *spatial)`` map."""
    ch = channel_axis % flow.dim()
    spatial_axes = [a for a in range(1, flow.dim()) if a != ch]
    total = 0.0
    for ax in spatial_axes:
        total = total + _central_gradient(flow, ax).abs() ** order
    m = (total / len(spatial_axes)).mean(ch)
    return m if reduction == "none" else m.mean()


def temporal_gradient_penalty(flow_seq: torch.Tensor, order: int = 2, reduction: str = "mean",
                              channel_axis: int = -1) -> torch.Tensor:
    """Mean |central gradient along the leading (time) axis|^order, averaged
    over the flow channels at ``channel_axis``; ``reduction="none"`` returns
    the map without the channel axis."""
    m = (_central_gradient(flow_seq, 0).abs() ** order).mean(channel_axis)
    return m if reduction == "none" else m.mean()


def raft_sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, gamma: float = 0.8,
                       valid: torch.Tensor | None = None,
                       max_flow: float = 400.0) -> torch.Tensor:
    """RAFT's exponentially weighted L1 over the iterations: iteration i of
    n weighs gamma^(n-1-i); pixels whose ground-truth flow is max_flow or
    longer (or outside ``valid``) are left out. flow_preds (iters, N, H, W,
    2), flow_gt (N, H, W, 2)."""
    n = flow_preds.shape[0]
    mag = flow_gt.square().sum(-1).sqrt()
    v = (mag < max_flow).float()
    if valid is not None:
        v = v * valid.float()
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    l1 = (flow_preds - flow_gt[None]).abs().mean(-1)  # (iters, N, H, W)
    per_iter = (l1 * v[None]).sum((1, 2, 3)) / v.sum().clamp_min(1.0)
    return (weights * per_iter).sum()
