"""AI-vs-ground-truth strain curve metrics (port of
``csof_tpu/analysis/strain_curves.py``, numpy and scipy).

Per case the ``S{radial,circ}_{LV,RV}_curve`` arrays from a Medis ``.mat``
export (``Structure_ai`` / ``Structure_gt``, through ``scipy.io.loadmat``),
an ``.npz`` with those keys (as ``export_strain_curves`` writes them) or an
``.npy`` (one radial LV curve): the L2 distance of each curve to the ground
truth's (resampled to its length), the ES and ED peaks, and the mean curves
over the cases; written as ``strain_metrics.csv`` and a JSON summary.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np
from scipy import interpolate

CURVE_KEYS = {
    "radial_lv": "Sradial_LV_curve",
    "circ_lv": "Scirc_LV_curve",
    "circ_rv": "Scirc_RV_curve",
}
PEAK_KEYS = {
    "radial_lv": "Sradial_LV_peak",
    "circ_lv": "Scirc_LV_peak",
    "circ_rv": "Scirc_RV_peak",
}


def load_strain_curves(path: str | Path) -> dict:
    """Load one case's strain curves (and peaks when present) from .mat /
    .npz / .npy. Returns {'curves': {kind: (T,) array}, 'peaks': {kind:
    (2, 2) array or None}} with the kinds of CURVE_KEYS that are present."""
    path = Path(path)
    curves: dict[str, np.ndarray] = {}
    peaks: dict[str, np.ndarray | None] = {}
    if path.suffix == ".mat":
        from scipy.io import loadmat

        mat = loadmat(path, simplify_cells=True)
        # Medis exports nest everything under Structure_ai / Structure_gt
        # (ref: compute_strain_curve_metric.py:30-38); accept flat keys too
        struct = mat
        for k in ("Structure_ai", "Structure_gt"):
            if k in mat and isinstance(mat[k], dict):
                struct = mat[k]
                break
        src = struct
    elif path.suffix == ".npz":
        src = dict(np.load(path, allow_pickle=False))
    elif path.suffix == ".npy":
        return {"curves": {"radial_lv": np.asarray(np.load(path)).ravel()}, "peaks": {}}
    else:
        raise ValueError(f"unsupported strain curve file {path}")
    for kind, key in CURVE_KEYS.items():
        if key in src:
            arr = np.asarray(src[key], dtype=np.float64).ravel()
            if arr.size > 1:
                curves[kind] = arr
    for kind, key in PEAK_KEYS.items():
        if key in src:
            p = np.asarray(src[key])
            # Medis writes an int placeholder when the structure is absent
            # (ref: compute_stats_strain.py:60-67 `type(peak) != int` guards)
            peaks[kind] = p if p.ndim == 2 else None
    return {"curves": curves, "peaks": peaks}


def resample_curve(data: np.ndarray, m: int) -> np.ndarray:
    """Linear resample of a (T,) curve to m samples over the same support
    (ref: compute_strain_curve_metric.py:57-62 interp1d + linspace)."""
    data = np.asarray(data, dtype=np.float64).ravel()
    x = np.arange(len(data))
    f1 = interpolate.interp1d(x, data)
    return np.asarray(f1(np.linspace(0, len(data) - 1, m)))


def curve_peaks(curve: np.ndarray) -> np.ndarray:
    """(2, 2) peak table [[ES index, ED index], [ES value, ED value]] from a
    curve, for inputs without precomputed Medis peaks: the ES peak is the
    global extremum (largest |strain|, reached at end-systole) and the ED
    "return" peak is the final-frame value (strain is 0 at ED by
    construction; residual measures drift). Matches the layout the reference
    reads at compute_stats_strain.py:43-58 (peak[0]=indices, peak[1]=values)."""
    curve = np.asarray(curve, dtype=np.float64).ravel()
    es_idx = int(np.argmax(np.abs(curve)))
    ed_idx = len(curve) - 1
    return np.array([[es_idx, ed_idx], [curve[es_idx], curve[ed_idx]]], dtype=np.float64)


def case_curve_metrics(ai: dict, gt: dict) -> dict:
    """Per-case AI-vs-GT metrics for the curve kinds both sides have:
    the L2 curve distance of compute_stats_strain.py:28-37 (GT-length
    resampled when lengths differ) and the ES/ED peak entries."""
    out: dict[str, float] = {}
    for kind in CURVE_KEYS:
        ca, cg = ai["curves"].get(kind), gt["curves"].get(kind)
        if ca is None or cg is None:
            continue
        if len(ca) != len(cg):
            ca = resample_curve(ca, len(cg))
        out[f"distance_{kind}"] = float(np.linalg.norm(ca - cg))
        for side, rec, curve in (("ai", ai, ca), ("gt", gt, cg)):
            peak = rec.get("peaks", {}).get(kind)
            if peak is None:
                peak = curve_peaks(curve)
            out[f"ES_peak_index_{side}_{kind}"] = float(peak[0, 0])
            out[f"ED_peak_index_{side}_{kind}"] = float(peak[0, 1])
            out[f"ES_peak_value_{side}_{kind}"] = float(peak[1, 0])
            out[f"ED_peak_value_{side}_{kind}"] = float(peak[1, 1])
    return out


def mean_curves(records: list[dict]) -> dict[str, list[float]]:
    """Average curves across cases after resampling every curve to the
    longest one (ref: compute_strain_curve_metric.py:46-67)."""
    out: dict[str, list[float]] = {}
    for kind in CURVE_KEYS:
        cs = [r["curves"][kind] for r in records if kind in r["curves"]]
        if not cs:
            continue
        m = max(len(c) for c in cs)
        out[kind] = np.stack([resample_curve(c, m) for c in cs]).mean(0).tolist()
    return out


def aggregate_strain_curve_metrics(
    pairs: list[tuple[str | Path, str | Path]],
    csv_out: str | Path | None = None,
    json_out: str | Path | None = None,
) -> dict:
    """Run the full AI-vs-GT comparison over (ai_path, gt_path) pairs.

    Returns {'cases': [{case, **metrics}], 'mean': {metric: value},
    'mean_curves': {'AI': {...}, 'GT': {...}}} and optionally writes the
    compute_stats_strain-style CSV plus a JSON summary."""
    rows = []
    ai_records, gt_records = [], []
    for ai_path, gt_path in pairs:
        ai = load_strain_curves(ai_path)
        gt = load_strain_curves(gt_path)
        ai_records.append(ai)
        gt_records.append(gt)
        row = {"case": Path(ai_path).stem}
        row.update(case_curve_metrics(ai, gt))
        rows.append(row)
    metric_names = sorted({k for r in rows for k in r if k != "case"})
    mean = {
        name: float(np.nanmean([r[name] for r in rows if name in r]))
        for name in metric_names
        if any(name in r for r in rows)
    }
    result = {
        "cases": rows,
        "mean": mean,
        "mean_curves": {"AI": mean_curves(ai_records), "GT": mean_curves(gt_records)},
    }
    if csv_out:
        with open(csv_out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["case"] + metric_names)
            w.writeheader()
            w.writerows(rows)
    if json_out:
        Path(json_out).write_text(json.dumps(result, indent=2))
    return result
