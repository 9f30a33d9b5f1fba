"""Folder evaluator: per-case and mean metric JSON (port of
``csof_tpu/evaluation/evaluator.py``): ``evaluate_case`` scores one
prediction against its reference per label, ``aggregate_scores`` a list of
NIfTI pairs into ``summary.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.evaluation import metrics as M
from csof_tpu_torch.utils.nifti import load_nifti


def _nsd_name(t: float) -> str:
    return f"Normalized Surface Dice @{t:g}mm"


def evaluate_case(
    pred: np.ndarray, ref: np.ndarray, labels, spacing=None, surface: bool = True,
    nsd_thresholds: tuple[float, ...] = (),
) -> dict:
    out = {}
    for label in labels:
        p, r = pred == label, ref == label
        res = {name: fn(p, r) for name, fn in M.ALL_METRICS.items()}
        if surface:
            if p.any() and r.any():
                res.update({name: fn(p, r, spacing) for name, fn in M.SURFACE_METRICS.items()})
            else:
                res.update({name: float("nan") for name in M.SURFACE_METRICS})
        for t in nsd_thresholds:  # the threshold in mm, through the case spacing
            res[_nsd_name(t)] = M.normalized_surface_dice(p, r, t, spacing)
        out[str(int(label))] = res
    return out


def aggregate_scores(
    pred_ref_pairs: list[tuple[str, str]],
    labels,
    json_output_file: str | Path | None = None,
    json_name: str = "",
    json_task: str = "",
    surface: bool = True,
    num_workers: int = 1,
    nsd_thresholds: tuple[float, ...] = (),
) -> dict:
    """Evaluate (pred, ref) NIfTI path pairs; write summary.json."""
    all_res = []
    for pred_path, ref_path in pred_ref_pairs:
        pi = load_nifti(pred_path)
        ri = load_nifti(ref_path)
        case = evaluate_case(
            pi.data_czyx, ri.data_czyx, labels, spacing=pi.spacing_zyx, surface=surface,
            nsd_thresholds=nsd_thresholds,
        )
        case["test"] = str(pred_path)
        case["reference"] = str(ref_path)
        all_res.append(case)

    mean = {}
    for label in labels:
        key = str(int(label))
        mean[key] = {}
        metric_names = (
            list(M.ALL_METRICS)
            + (list(M.SURFACE_METRICS) if surface else [])
            + [_nsd_name(t) for t in nsd_thresholds]
        )
        for name in metric_names:
            vals = [c[key][name] for c in all_res if not np.isnan(c[key][name]) and np.isfinite(c[key][name])]
            mean[key][name] = float(np.mean(vals)) if vals else float("nan")

    result = {"all": all_res, "mean": mean, "name": json_name, "task": json_task}
    if json_output_file:
        Path(json_output_file).parent.mkdir(parents=True, exist_ok=True)
        Path(json_output_file).write_text(json.dumps(result, indent=2, default=float))
    return result
