"""Perimeter-based tangential strain, LV radial strain and contour tracking
(port of ``csof_tpu/ops/strain.py``).

Labels: 1 = RV, 2 = MYO, 3 = LV cavity. Tangential strain is the relative
change of a structure's perimeter against frame 0, in percent (RV: label 1;
LV: the mean of the endocardial, label 3, and epicardial, 2 or 3, curves).
The perimeter is the weighted border-pixel count behind
``skimage.measure.perimeter`` with the 4-neighbourhood: border pixels
(removed by a 4-cross erosion) are put in categories by
[[10, 2, 10], [2, 1, 2], [10, 2, 10]] over their 3x3 neighbourhood and
weighted 1, sqrt(2) or (1 + sqrt(2)) / 2.

On the device the caller's tensors lie on, with these choices:

- the category pass is nine shifted adds of small integers (no convolution
  call, so no TF32), and the histogram an integer ``bincount``: exact;
- the weighted sum of the histogram is taken in float64, where it is exact
  (every term is an integer multiple of 2^-23 below 2^43), then rounded to
  float32, so every device gives the same bits; the JAX package sums it in
  float32, which may differ from it by an ulp;
- contour points are extracted on the host (data-dependent counts, and
  ``linspace(...).astype(int)`` indices), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from csof_tpu_torch.ops.warp import warp_points
from csof_tpu_torch.utils.device import resolve_device

_SQRT2 = math.sqrt(2.0)
#: category -> weight (float32 values, as the JAX package's table)
_WEIGHTS = np.zeros(50, np.float32)
_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_WEIGHTS[[21, 33]] = _SQRT2
_WEIGHTS[[13, 23]] = (1.0 + _SQRT2) / 2.0
_CATEGORY_KERNEL = ((10, 2, 10), (2, 1, 2), (10, 2, 10))


def perimeter_histogram(binary: torch.Tensor) -> torch.Tensor:
    """(..., H, W) masks -> (..., 50) int64 counts of the border categories
    (category 0 holds every pixel off the border)."""
    b = binary.to(torch.int32)
    bp = F.pad(b, (1, 1, 1, 1))
    h, w = b.shape[-2:]
    eroded = (bp[..., 1:-1, 1:-1] * bp[..., :-2, 1:-1] * bp[..., 2:, 1:-1]
              * bp[..., 1:-1, :-2] * bp[..., 1:-1, 2:])
    border = b - eroded
    pb = F.pad(border, (1, 1, 1, 1))
    cat = torch.zeros_like(border)
    for dy in range(3):
        for dx in range(3):
            cat = cat + _CATEGORY_KERNEL[dy][dx] * pb[..., dy:dy + h, dx:dx + w]
    cat = torch.clamp(cat * border, 0, 49).reshape(*b.shape[:-2], -1).to(torch.int64)
    hist = torch.zeros((*cat.shape[:-1], 50), dtype=torch.int64, device=cat.device)
    return hist.scatter_add_(-1, cat, torch.ones_like(cat))


def perimeter_batch(binary: torch.Tensor) -> torch.Tensor:
    """(..., H, W) masks -> (...,) float32 perimeters."""
    w = torch.from_numpy(_WEIGHTS.astype(np.float64)).to(binary.device)
    return (perimeter_histogram(binary).to(torch.float64) * w).sum(-1).to(torch.float32)


def perimeter(binary: torch.Tensor) -> torch.Tensor:
    """Perimeter of the objects of one (H, W) mask: a 0-dim float32 tensor.
    Exact on 45-degree diamonds, about +4-5 % on circles at any radius (the
    estimator's bias, which a strain ratio against frame 0 cancels)."""
    return perimeter_batch(binary)


def strain_curves(label_seq: torch.Tensor) -> dict[str, torch.Tensor]:
    """Tangential strain from a (T, H, W) label sequence: {'rv': (T,), 'lv':
    (T,)} in percent of frame 0."""
    rv = perimeter_batch(label_seq == 1)
    endo = perimeter_batch(label_seq == 3)
    epi = perimeter_batch((label_seq == 2) | (label_seq == 3))
    eps = 1e-8

    def rel(p):
        return (p - p[0]) / (p[0] + eps) * 100.0

    return {"rv": rel(rv), "lv": (rel(endo) + rel(epi)) / 2.0}


def _mean_nn_distance(a_pts: torch.Tensor, b_pts: torch.Tensor) -> torch.Tensor:
    """Symmetric mean nearest-neighbour distance between (P, 2) and (Q, 2)
    point sets (the tiled sets ``extract_contour_points`` pads with only
    reweight points, which nearest-neighbour minima do not see)."""
    d2 = torch.sum((a_pts[:, None, :] - b_pts[None, :, :]) ** 2, dim=-1)
    ab = torch.mean(torch.sqrt(torch.amin(d2, dim=1)))
    ba = torch.mean(torch.sqrt(torch.amin(d2, dim=0)))
    return (ab + ba) / 2.0


def myocardial_thickness(label_frame: np.ndarray, max_points: int = 256,
                         device: torch.device | str = "cuda") -> float:
    """Mean LV wall thickness of one (H, W) label frame: the symmetric mean
    nearest distance between the endocardial contour (border of label 3)
    and the epicardial one (border of 2 or 3); the contours on the host,
    the distances on ``device`` (the CUDA device unless told otherwise).
    NaN where either contour is empty."""
    device = resolve_device(device)
    frame = np.asarray(label_frame)
    endo = extract_contour_points(frame == 3, max_points)
    epi = extract_contour_points((frame == 2) | (frame == 3), max_points)
    if not endo.any() or not epi.any():
        return float("nan")
    return float(_mean_nn_distance(torch.from_numpy(endo).to(device),
                                   torch.from_numpy(epi).to(device)))


def radial_strain_curve(label_seq: np.ndarray, max_points: int = 256,
                        device: torch.device | str = "cuda") -> np.ndarray:
    """LV radial strain of a (T, H, W) label sequence: the relative change of
    the mean wall thickness against frame 0, in percent (positive while the
    wall thickens in systole)."""
    device = resolve_device(device)
    th = np.array([myocardial_thickness(f, max_points, device) for f in np.asarray(label_seq)])
    eps = 1e-8
    return (th - th[0]) / (th[0] + eps) * 100.0


def track_contour(points0: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Frame-0 contour points (P, 2) advected by each frame's cumulative
    backward flow (T, H, W, 2) -> (T, P, 2)."""
    return torch.stack([warp_points(points0, f) for f in flows])


def contour_tracking_error(tracked: torch.Tensor, gt_points: torch.Tensor) -> torch.Tensor:
    """Symmetric mean nearest-neighbour distance per frame between tracked
    (T, P, 2) and ground-truth (T, Q, 2) contours -> (T,)."""
    return torch.stack([_mean_nn_distance(a, b) for a, b in zip(tracked, gt_points)])


def extract_contour_points(mask: np.ndarray, max_points: int = 256) -> np.ndarray:
    """Host: the border pixels of a binary mask as (max_points, 2) float32
    (y, x), subsampled evenly or tiled to ``max_points``; zeros if empty."""
    from scipy.ndimage import binary_erosion

    border = mask & ~binary_erosion(mask, np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
    pts = np.argwhere(border).astype(np.float32)
    if len(pts) == 0:
        return np.zeros((max_points, 2), np.float32)
    if len(pts) >= max_points:
        return pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]
    reps = int(np.ceil(max_points / len(pts)))
    return np.tile(pts, (reps, 1))[:max_points]
