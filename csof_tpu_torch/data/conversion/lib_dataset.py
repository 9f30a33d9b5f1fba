"""Lib cardiac dataset conversion (port of
``csof_tpu/data/conversion/lib_dataset.py``): the imagesTr/labelsTr layout
plus the strain ground truth (``strain/LV/{radial,tangential}``,
``strain/RV/tangential``) and contour point sets (``contour/{LV,RV}``) of the
strain and contour analyses, and the ED/ES submission layout
(``convert_to_submission``).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

LIB_SUBDIRS = ["imagesTr", "imagesTs", "labelsTr", "strain/LV/radial", "strain/LV/tangential",
               "strain/RV/tangential", "contour/RV", "contour/LV"]


def make_lib_layout(out_dir: str | Path) -> Path:
    out_dir = Path(out_dir)
    for sub in LIB_SUBDIRS:
        (out_dir / sub).mkdir(parents=True, exist_ok=True)
    return out_dir


def convert_lib(source_dir: str | Path, out_dir: str | Path,
                strain_dir: str | Path | None = None,
                contour_dir: str | Path | None = None) -> dict:
    """source_dir: per-patient NIfTIs named <patientid>_frameNN (and
    ``_gt``). Copies them into the task layout, mirrors the strain and
    contour trees when given, and returns the dataset.json."""
    source_dir, out = Path(source_dir), make_lib_layout(out_dir)
    cases = []
    for img in sorted(source_dir.glob("*.nii.gz")):
        if img.name.endswith("_gt.nii.gz"):
            continue
        case = img.name.replace(".nii.gz", "")
        shutil.copy(img, out / "imagesTr" / f"{case}_0000.nii.gz")
        gt = source_dir / f"{case}_gt.nii.gz"
        if gt.exists():
            shutil.copy(gt, out / "labelsTr" / f"{case}.nii.gz")
        cases.append(case)
    for src, sub in ((strain_dir, "strain"), (contour_dir, "contour")):
        if src and Path(src).exists():
            shutil.copytree(src, out / sub, dirs_exist_ok=True)
    dataset_json = {
        "name": "Lib",
        "modality": {"0": "MRI"},
        "labels": {"0": "background", "1": "RV", "2": "MYO", "3": "LV"},
        "numTraining": len(cases),
        "training": [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                     for c in cases],
    }
    (out / "dataset.json").write_text(json.dumps(dataset_json, indent=2))
    return dataset_json


def convert_to_submission(source_dir: str | Path, target_dir: str | Path) -> None:
    """First and second frame of each patient -> <patient>_{ED,ES}.nii.gz."""
    source_dir, target_dir = Path(source_dir), Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    niftis = sorted(p.name for p in source_dir.glob("*.nii.gz"))
    for p in sorted({n[:10] for n in niftis}):
        files = sorted(n for n in niftis if n.startswith(p))
        shutil.copy(source_dir / files[0], target_dir / f"{p}_ED.nii.gz")
        if len(files) > 1:
            shutil.copy(source_dir / files[1], target_dir / f"{p}_ES.nii.gz")
