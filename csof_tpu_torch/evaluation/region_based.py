"""Region-based evaluation: Dice and HD95 over unions of labels (port of
``csof_tpu/evaluation/region_based.py``), e.g. the whole heart as RV, MYO
and LV together."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.evaluation.metrics import dice, hausdorff_distance_95
from csof_tpu_torch.utils.nifti import load_nifti

CARDIAC_REGIONS = {
    "RV": (1,),
    "MYO": (2,),
    "LV": (3,),
    "whole_heart": (1, 2, 3),
    "LV_epi": (2, 3),
}


def region_mask(seg: np.ndarray, labels) -> np.ndarray:
    return np.isin(seg, list(labels))


def evaluate_regions(pred: np.ndarray, ref: np.ndarray,
                     regions: dict[str, tuple] = CARDIAC_REGIONS, spacing=None
                     ) -> dict[str, dict[str, float]]:
    """{region: {"Dice", "HD95"}}; HD95 is NaN where either mask is empty."""
    out = {}
    for name, labels in regions.items():
        p, r = region_mask(pred, labels), region_mask(ref, labels)
        hd = hausdorff_distance_95(p, r, spacing) if p.any() and r.any() else float("nan")
        out[name] = {"Dice": dice(p, r), "HD95": hd}
    return out


def evaluate_regions_folder(pred_ref_pairs, regions: dict[str, tuple] = CARDIAC_REGIONS,
                            json_output_file: str | Path | None = None) -> dict:
    """Every (prediction, reference) NIfTI pair at the prediction's
    spacing; ``{"all": per case, "mean": per region and metric over the
    finite values}``."""
    all_cases = []
    for pred_path, ref_path in pred_ref_pairs:
        pi, ri = load_nifti(pred_path), load_nifti(ref_path)
        case = evaluate_regions(pi.data_czyx, ri.data_czyx, regions, spacing=pi.spacing_zyx)
        case["test"] = str(pred_path)
        all_cases.append(case)
    mean = {}
    for name in regions:
        for metric in ("Dice", "HD95"):
            vals = [c[name][metric] for c in all_cases if np.isfinite(c[name][metric])]
            mean.setdefault(name, {})[metric] = float(np.mean(vals)) if vals else float("nan")
    result = {"all": all_cases, "mean": mean}
    if json_output_file:
        Path(json_output_file).write_text(json.dumps(result, indent=2, default=float))
    return result
