"""Segmentation metrics: overlap and surface distances, and the normalised
surface Dice (port of ``csof_tpu/evaluation/metrics.py``, numpy and scipy:
the surface metrics through scipy's Euclidean distance transform, with
medpy's definitions), and the structural similarity ``ssim``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import (binary_erosion, distance_transform_edt, generate_binary_structure,
                           uniform_filter)


def confusion_counts(pred: np.ndarray, ref: np.ndarray):
    p, r = pred.astype(bool), ref.astype(bool)
    tp = int(np.count_nonzero(p & r))
    fp = int(np.count_nonzero(p & ~r))
    fn = int(np.count_nonzero(~p & r))
    tn = int(np.count_nonzero(~p & ~r))
    return tp, fp, fn, tn


def dice(pred, ref) -> float:
    tp, fp, fn, _ = confusion_counts(pred, ref)
    denom = 2 * tp + fp + fn
    return float("nan") if denom == 0 else 2 * tp / denom


def jaccard(pred, ref) -> float:
    tp, fp, fn, _ = confusion_counts(pred, ref)
    denom = tp + fp + fn
    return float("nan") if denom == 0 else tp / denom


def precision(pred, ref) -> float:
    tp, fp, _, _ = confusion_counts(pred, ref)
    return float("nan") if tp + fp == 0 else tp / (tp + fp)


def recall(pred, ref) -> float:
    tp, _, fn, _ = confusion_counts(pred, ref)
    return float("nan") if tp + fn == 0 else tp / (tp + fn)


def _surface_mask(binary: np.ndarray, connectivity: int = 1) -> np.ndarray:
    if not binary.any():
        return binary
    conn = generate_binary_structure(binary.ndim, connectivity)
    return binary & ~binary_erosion(binary, conn, border_value=0)


def surface_distances(pred: np.ndarray, ref: np.ndarray, spacing=None, connectivity: int = 1) -> np.ndarray:
    """Distances from pred surface voxels to the ref surface (one direction;
    medpy `__surface_distances` definition)."""
    pred, ref = pred.astype(bool), ref.astype(bool)
    if not pred.any() or not ref.any():
        return np.array([np.inf])
    ref_surface = _surface_mask(ref, connectivity)
    dt = distance_transform_edt(~ref_surface, sampling=spacing)
    return dt[_surface_mask(pred, connectivity)]


def hausdorff_distance(pred, ref, spacing=None) -> float:
    d1 = surface_distances(pred, ref, spacing)
    d2 = surface_distances(ref, pred, spacing)
    return float(max(d1.max(), d2.max()))


def hausdorff_distance_95(pred, ref, spacing=None) -> float:
    d1 = surface_distances(pred, ref, spacing)
    d2 = surface_distances(ref, pred, spacing)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def avg_surface_distance(pred, ref, spacing=None) -> float:
    """ASD (pred -> ref)."""
    return float(surface_distances(pred, ref, spacing).mean())


def avg_symmetric_surface_distance(pred, ref, spacing=None) -> float:
    d1 = surface_distances(pred, ref, spacing)
    d2 = surface_distances(ref, pred, spacing)
    return float((d1.sum() + d2.sum()) / (len(d1) + len(d2)))


def normalized_surface_dice(
    a: np.ndarray, b: np.ndarray, threshold: float, spacing=None, connectivity: int = 1
) -> float:
    """Normalized surface dice (ref: nnunet/evaluation/surface_dice.py:20).

    Symmetric: fraction of surface voxels of each mask whose distance to the
    other mask's surface is <= threshold (threshold in mm when `spacing`
    gives voxel sizes in mm; voxels when spacing is None). Matches the
    reference formula exactly, including its per-direction normalization and
    the 1e-8 div-guard. Returns nan when either mask is empty (the reference
    raises inside medpy there; nan keeps aggregation well-defined)."""
    assert a.shape == b.shape, f"shape mismatch: {a.shape} vs {b.shape}"
    a, b = a.astype(bool), b.astype(bool)
    if not a.any() or not b.any():
        return float("nan")
    a_to_b = surface_distances(a, b, spacing, connectivity)
    b_to_a = surface_distances(b, a, spacing, connectivity)
    tp_a = np.sum(a_to_b <= threshold) / len(a_to_b)
    tp_b = np.sum(b_to_a <= threshold) / len(b_to_a)
    fp = np.sum(a_to_b > threshold) / len(a_to_b)
    fn = np.sum(b_to_a > threshold) / len(b_to_a)
    return float((tp_a + tp_b) / (tp_a + tp_b + fp + fn + 1e-8))


ALL_METRICS = {
    "Dice": dice,
    "Jaccard": jaccard,
    "Precision": precision,
    "Recall": recall,
}
SURFACE_METRICS = {
    "Hausdorff Distance": hausdorff_distance,
    "Hausdorff Distance 95": hausdorff_distance_95,
    "Avg. Surface Distance": avg_surface_distance,
    "Avg. Symmetric Surface Distance": avg_symmetric_surface_distance,
}


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float | None = None,
         win: int = 7) -> float:
    """Structural similarity (Wang et al. 2004) with a uniform ``win`` window
    and the sample covariance, averaged over the pixels a whole window
    covers; float64 on the host."""
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)
    if data_range is None:
        data_range = max(x.max() - x.min(), y.max() - y.min(), 1e-8)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_x = uniform_filter(x, win)
    mu_y = uniform_filter(y, win)
    sxx = uniform_filter(x * x, win) - mu_x**2
    syy = uniform_filter(y * y, win) - mu_y**2
    sxy = uniform_filter(x * y, win) - mu_x * mu_y
    npix = win ** x.ndim
    corr = npix / (npix - 1)  # the sample covariance
    sxx, syy, sxy = sxx * corr, syy * corr, sxy * corr
    s = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2))
    pad = (win - 1) // 2
    return float(s[tuple(slice(pad, dim - pad) for dim in s.shape)].mean())
