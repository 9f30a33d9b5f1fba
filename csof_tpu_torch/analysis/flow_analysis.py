"""Folder-level flow and strain analysis of a prediction tree (port of
``csof_tpu/analysis/flow_analysis.py``).

For each case of the Flow/Registered/Segmentation tree that
``csof_torch_predict_flow`` writes: the jacobian determinant of every
backward flow (|mean J - 1| and % negative J, globally and per structure:
RV = 1, MYO = 2, LV = 3), the perimeter strain curves per depth and their
mean, the LV radial strain, and with ground-truth labels the contour
tracking error of the mid slice; SSIM of registered frames on request.

The array math runs on the ``device`` the caller names, the CUDA device
unless told otherwise (the flows of a case in one jacobian call, the label
sequences of a depth in one perimeter call); files, contour extraction and
SSIM stay on the host.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np
import torch

from csof_tpu_torch.evaluation.metrics import ssim
from csof_tpu_torch.ops.jacobian import jacobian_determinant_batch
from csof_tpu_torch.ops.strain import (
    contour_tracking_error,
    extract_contour_points,
    radial_strain_curve,
    strain_curves,
    track_contour,
)
from csof_tpu_torch.utils.device import resolve_device
from csof_tpu_torch.utils.nifti import load_nifti

STRUCTURES = {1: "RV", 2: "MYO", 3: "LV"}


def jacobian_report(flow: np.ndarray, seg: np.ndarray | None = None,
                    device: torch.device | str = "cuda") -> dict:
    """flow: (T, D, H, W, 2) backward flows; seg: (T, D, H, W) labels or None.
    Per structure (and "global") {abs_mean_j_minus_1, pct_negative_j}."""
    flow_t = torch.from_numpy(np.ascontiguousarray(flow)).to(resolve_device(device))
    det = jacobian_determinant_batch(flow_t, ndim=2).cpu().numpy()

    def stats(mask):
        vals = det[mask]
        if vals.size == 0:
            return {"abs_mean_j_minus_1": float("nan"), "pct_negative_j": float("nan")}
        return {"abs_mean_j_minus_1": float(abs(vals.mean() - 1.0)),
                "pct_negative_j": float(100.0 * (vals < 0).mean())}

    out = {"global": stats(np.ones_like(det, bool))}
    if seg is not None:
        for label, name in STRUCTURES.items():
            out[name] = stats(seg == label)
    return out


def strain_report(seg: np.ndarray, device: torch.device | str = "cuda") -> dict:
    """seg: (T, D, H, W) labels. Tangential (RV, LV) and radial (LV) strain
    curves per depth, and their means over depth."""
    device = resolve_device(device)
    rv, lv, radial = [], [], []
    seg_t = torch.from_numpy(np.array(seg)).to(device)  # load_nifti's arrays are read-only
    for z in range(seg.shape[1]):
        curves = strain_curves(seg_t[:, z])
        rv.append(curves["rv"].cpu().numpy())
        lv.append(curves["lv"].cpu().numpy())
        radial.append(radial_strain_curve(seg[:, z], device=device))
    return {
        "rv_strain_per_depth": np.stack(rv).tolist(),
        "lv_strain_per_depth": np.stack(lv).tolist(),
        "lv_radial_strain_per_depth": np.stack(radial).tolist(),
        "rv_strain_mean": np.stack(rv).mean(0).tolist(),
        "lv_strain_mean": np.stack(lv).mean(0).tolist(),
        "lv_radial_strain_mean": np.nanmean(np.stack(radial), axis=0).tolist(),
    }


def contour_error_report(flows: np.ndarray, gt_segs: np.ndarray, label: int = 3,
                         max_points: int = 128, device: torch.device | str = "cuda") -> dict:
    """Track the frame-0 ground-truth contour of ``label`` through the
    cumulative backward flows and measure it against each frame's own.
    flows: (T, H, W, 2) of one slice; gt_segs: (T, H, W)."""
    device = resolve_device(device)
    pts0 = torch.from_numpy(extract_contour_points(gt_segs[0] == label, max_points)).to(device)
    tracked = track_contour(pts0, torch.from_numpy(np.ascontiguousarray(flows)).to(device))
    gt_pts = np.stack([extract_contour_points(gt_segs[t] == label, max_points)
                       for t in range(len(gt_segs))])
    err = contour_tracking_error(tracked, torch.from_numpy(gt_pts).to(device)).cpu().numpy()
    return {"per_frame_error": err.tolist(),
            "mean_error": float(err[1:].mean() if len(err) > 1 else err.mean())}


def ssim_report(registered: np.ndarray, target: np.ndarray) -> dict:
    """registered, target: (T, D, H, W); SSIM per frame (mean over depth)."""
    t, d = registered.shape[:2]
    vals = [float(np.mean([ssim(registered[ti, z], target[ti, z]) for z in range(d)]))
            for ti in range(t)]
    return {"per_frame_ssim": vals, "mean_ssim": float(np.mean(vals))}


def analyze_prediction_tree(root: str | Path, out_file: str | Path | None = None,
                            gt_seg_dir: str | Path | None = None,
                            device: torch.device | str = "cuda") -> dict:
    """Analyze every case of a Flow/Registered/Segmentation tree; with
    ``gt_seg_dir`` (per-case 4D label NIfTIs) also the contour tracking
    error of the mid slice for LV and RV. Writes ``out_file`` (JSON) if given."""
    device = resolve_device(device)
    root = Path(root)
    results = {}
    for flow_file in sorted((root / "Flow").glob("*.npz")):
        case = flow_file.stem
        flow = np.moveaxis(np.load(flow_file)["flow"], 0, -1)  # (T, D, H, W, 2)
        seg_file = root / "Segmentation" / f"{case}.nii.gz"
        seg = load_nifti(seg_file).data_czyx if seg_file.exists() else None
        entry = {"jacobian": jacobian_report(flow, seg, device)}
        if seg is not None:
            entry["strain"] = strain_report(seg, device)
        if gt_seg_dir is not None:
            gt_file = Path(gt_seg_dir) / f"{case}.nii.gz"
            if gt_file.exists():
                gt = load_nifti(gt_file).data_czyx  # (T, D, H, W)
                mid = gt.shape[1] // 2
                entry["contour_tracking"] = {
                    name: contour_error_report(flow[:, mid], gt[:, mid], label=label,
                                               device=device)
                    for name, label in (("LV", 3), ("RV", 1))}
        results[case] = entry
    if out_file:
        Path(out_file).write_text(json.dumps(results, indent=2))
    return results


def export_strain_curves(report: dict, out_dir: str | Path) -> int:
    """One ``<case>.npz`` of strain curves per case, keys
    ``Sradial_LV_curve``, ``Scirc_LV_curve`` and ``Scirc_RV_curve`` (the
    Medis export's names, which ``strain_curve_metric`` reads). Returns the
    number of files written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for case, entry in report.items():
        s = entry.get("strain")
        if not s:
            continue
        arrays = {dst: np.asarray(s[src], np.float64) for src, dst in (
            ("lv_radial_strain_mean", "Sradial_LV_curve"), ("lv_strain_mean", "Scirc_LV_curve"),
            ("rv_strain_mean", "Scirc_RV_curve")) if src in s}
        if arrays:
            np.savez(out_dir / f"{case}.npz", **arrays)
            n += 1
    return n


def write_strain_csv(report: dict, path: str | Path) -> None:
    """The mean strain curves as CSV rows: case, structure, frame, strain_pct."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case", "structure", "frame", "strain_pct"])
        for case, entry in report.items():
            s = entry.get("strain")
            if not s:
                continue
            for name in ("rv", "lv", "lv_radial"):
                key = f"{name}_strain_mean"
                if key not in s:
                    continue
                for t, v in enumerate(s[key]):
                    w.writerow([case, name.upper(), t, f"{v:.4f}"])
