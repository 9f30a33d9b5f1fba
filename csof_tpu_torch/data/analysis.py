"""Dataset analysis: per-case geometry and foreground intensity statistics
(port of ``csof_tpu/data/analysis.py``, numpy only).

``analyze_dataset`` writes ``dataset_properties.pkl`` beside the cropped
cases with the JAX package's keys, types and values: sizes and spacings as
tuples, the classes, the pooled intensity statistics per modality (keys
int), the size reduction of each case and the case ids.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from csof_tpu_torch.utils.pool import map_in_processes


def analyze_case(npz_path: str | Path, pkl_path: str | Path, num_modalities: int) -> dict:
    """Statistics of one cropped case (data and seg stacked, as
    ``run_cropping`` writes it)."""
    arr = np.load(npz_path)["data"]
    data, seg = arr[:num_modalities], arr[-1]
    with open(pkl_path, "rb") as f:
        props = pickle.load(f)
    fg_mask = seg > 0
    intensities = {}
    for c in range(num_modalities):
        vox = data[c][fg_mask]
        if vox.size == 0:
            vox = data[c].reshape(-1)
        vox = vox[::10] if vox.size > 10_000 else vox  # every 10th voxel of large sets
        intensities[c] = {
            "median": float(np.median(vox)),
            "mean": float(np.mean(vox)),
            "sd": float(np.std(vox)),
            "mn": float(np.min(vox)),
            "mx": float(np.max(vox)),
            "percentile_99_5": float(np.percentile(vox, 99.5)),
            "percentile_00_5": float(np.percentile(vox, 0.5)),
        }
    classes = sorted(int(c) for c in np.unique(seg) if c > 0)
    return {
        "size": tuple(int(s) for s in data.shape[1:]),
        "spacing": tuple(float(s) for s in props["original_spacing"]),
        "classes": classes,
        "size_reduction": float(
            np.prod(data.shape[1:]) / max(np.prod(props["original_size_of_raw_data"]), 1)),
        "intensities": intensities,
    }


def _analyze_job(job) -> dict:
    return analyze_case(*job)


def analyze_dataset(cropped_dir: str | Path, num_modalities: int, num_workers: int = 4) -> dict:
    """Pool the statistics of every case of a cropped-data folder and write
    ``dataset_properties.pkl`` there. ``num_workers`` > 1 analyses the cases
    in that many worker processes (``utils/pool.py``)."""
    cropped_dir = Path(cropped_dir)
    cases = sorted(p.stem for p in cropped_dir.glob("*.npz"))
    if not cases:
        raise FileNotFoundError(f"no cropped cases in {cropped_dir}")
    jobs = [(cropped_dir / f"{c}.npz", cropped_dir / f"{c}.pkl", num_modalities) for c in cases]
    per_case = map_in_processes(_analyze_job, jobs, num_workers)

    intensity_props = {}
    for c in range(num_modalities):
        stats = [p["intensities"][c] for p in per_case]
        intensity_props[c] = {
            "median": float(np.median([s["median"] for s in stats])),
            "mean": float(np.mean([s["mean"] for s in stats])),
            "sd": float(np.mean([s["sd"] for s in stats])),
            "mn": float(np.min([s["mn"] for s in stats])),
            "mx": float(np.max([s["mx"] for s in stats])),
            "percentile_99_5": float(np.mean([s["percentile_99_5"] for s in stats])),
            "percentile_00_5": float(np.mean([s["percentile_00_5"] for s in stats])),
        }
    properties = {
        "all_sizes": [p["size"] for p in per_case],
        "all_spacings": [p["spacing"] for p in per_case],
        "all_classes": sorted({c for p in per_case for c in p["classes"]}),
        "intensityproperties": intensity_props,
        "size_reductions": {c: p["size_reduction"] for c, p in zip(cases, per_case)},
        "case_identifiers": cases,
    }
    with open(cropped_dir / "dataset_properties.pkl", "wb") as f:
        pickle.dump(properties, f)
    return properties
