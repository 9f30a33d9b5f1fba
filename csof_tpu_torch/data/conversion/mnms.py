"""M&Ms (Multi-Centre, Multi-Vendor & Multi-Disease) conversion (port of
``csof_tpu/data/conversion/mnms.py``, numpy only).

Each patient's 4D short-axis cine (``<pat>_sa.nii.gz``) is read once and its
annotated ED and ES frames are written as cases ``<pat>_<ts:04d>_<vendor>_
<centre>``, from the "M&Ms Dataset Information" table; vendor C (the test
vendor) is skipped. ``make_generalization_splits`` appends the three vendor
folds to the standard five (train A, train B, train A+B; validate on the
held-out A+B patients; RandomState(1234), 80/20 per vendor).

The table is read from a .csv with the csv module; an .xlsx goes through
pandas, imported only on that route.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.data.conversion.acdc import _phantom_frame
from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

MNMS_LABELS = {0: "background", 1: "LVBP", 2: "LVM", 3: "RV"}
TEST_VENDOR = "C"


def read_mnms_info(path: str | Path) -> dict[str, dict]:
    """The dataset-information table: patient -> {ed, es, vendor, centre},
    from the official .xlsx (needs pandas) or a .csv with the columns
    'External code', 'ED', 'ES', 'Vendor', 'Centre'."""
    path = Path(path)
    if path.suffix.lower() in (".xlsx", ".xls"):
        import pandas as pd  # optional, only for the xlsx route

        rows = pd.read_excel(path).to_dict("records")
    else:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    info = {}
    for r in rows:
        pid = str(r["External code"]).strip()
        if not pid or pid == "nan":
            continue
        info[pid] = {"ed": int(r["ED"]), "es": int(r["ES"]),
                     "vendor": str(r["Vendor"]).strip(), "centre": str(r["Centre"]).strip()}
    return info


def _find_sa_files(root: Path) -> dict[str, dict]:
    """Walk ``root`` for ``*_sa.nii.gz`` / ``*_sa_gt.nii.gz``: pid -> {img, gt}."""
    out: dict[str, dict] = {}
    for f in sorted(root.rglob("*.nii.gz")):
        name = f.name
        if name.endswith("_sa_gt.nii.gz"):
            out.setdefault(name[: -len("_sa_gt.nii.gz")], {})["gt"] = f
        elif name.endswith("_sa.nii.gz"):
            out.setdefault(name[: -len("_sa.nii.gz")], {})["img"] = f
    return out


def convert_mnms(mnms_root: str | Path, info_path: str | Path, out_task_dir: str | Path,
                 keep_cine: bool = True) -> dict:
    """Write the raw-task layout for M&Ms (imagesTr/<case>_0000.nii.gz and
    labelsTr/<case>.nii.gz for the ED and ES frames of every patient not of
    the test vendor) and return its dataset.json."""
    root, out = Path(mnms_root), Path(out_task_dir)
    info = read_mnms_info(info_path)
    images_tr, labels_tr, cine_dir = out / "imagesTr", out / "labelsTr", out / "cine"
    for d in (images_tr, labels_tr) + ((cine_dir,) if keep_cine else ()):
        d.mkdir(parents=True, exist_ok=True)

    cases, ed_es, vendors = [], {}, {}
    for pid, files in sorted(_find_sa_files(root).items()):
        meta = info.get(pid)
        if meta is None or meta["vendor"] == TEST_VENDOR:
            continue
        img4d = load_nifti(files["img"])
        gt4d = load_nifti(files["gt"]) if "gt" in files else None
        affine = img4d.affine
        for ts in (meta["ed"], meta["es"]):
            case = f"{pid}_{ts:04d}_{meta['vendor']}_{meta['centre']}"
            save_nifti(img4d.data_czyx[ts].astype(np.float32), images_tr / f"{case}_0000.nii.gz",
                       affine=affine, spacing_xyz=img4d.itk_spacing)
            if gt4d is not None:
                save_nifti(gt4d.data_czyx[ts].astype(np.uint8), labels_tr / f"{case}.nii.gz",
                           affine=affine, spacing_xyz=img4d.itk_spacing)
            cases.append(case)
        ed_es[pid] = {"ed": meta["ed"], "es": meta["es"]}
        vendors[pid] = {"vendor": meta["vendor"], "centre": meta["centre"]}
        if keep_cine:
            save_nifti(img4d.data_czyx.astype(np.float32), cine_dir / f"{pid}_4d.nii.gz",
                       affine=affine, spacing_xyz=img4d.itk_spacing)

    dataset_json = {
        "name": "M&Ms",
        "description": "short axis cardiac cine MRI segmentation",
        "tensorImageSize": "4D",
        "modality": {"0": "MRI"},
        "labels": {str(k): v for k, v in MNMS_LABELS.items()},
        "numTraining": len(cases),
        "training": [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                     for c in cases],
        "ed_es_numbers": ed_es,
        "vendors": vendors,
    }
    (out / "dataset.json").write_text(json.dumps(dataset_json, indent=2))
    return dataset_json


def make_generalization_splits(case_ids: list[str], base_splits: list[dict],
                               seed: int = 1234) -> list[dict]:
    """``base_splits`` plus three vendor folds: train vendor A, train B, train
    A+B, each validated on the held-out A+B patients (80/20 per vendor)."""
    splits = list(base_splits)

    def patients_of(vendor):
        return np.unique([c.split("_")[0] for c in case_ids if f"_{vendor}_" in c])

    uniq_a, uniq_b = patients_of("A"), patients_of("B")
    p = np.random.RandomState(seed)
    tr_a = set(uniq_a[p.choice(len(uniq_a), int(round(0.8 * len(uniq_a))), replace=False)]) \
        if len(uniq_a) else set()
    tr_b = set(uniq_b[p.choice(len(uniq_b), int(round(0.8 * len(uniq_b))), replace=False)]) \
        if len(uniq_b) else set()
    val_a = [pid for pid in uniq_a if pid not in tr_a]
    val_b = [pid for pid in uniq_b if pid not in tr_b]

    def cases_of(pids):
        pids = set(pids)
        return [c for c in case_ids if c.split("_")[0] in pids]

    val_cases = cases_of(val_a) + cases_of(val_b)
    splits.append({"train": cases_of(tr_a), "val": val_cases})
    splits.append({"train": cases_of(tr_b), "val": val_cases})
    splits.append({"train": cases_of(tr_b) + cases_of(tr_a), "val": val_cases})
    return splits


def make_synthetic_mnms(root: str | Path, num_patients: int = 4, num_frames: int = 6,
                        shape_zyx=(4, 40, 40), seed: int = 0) -> Path:
    """Write an M&Ms-layout tree of beating phantoms: per patient a 4D
    ``<pid>_sa.nii.gz`` and ``<pid>_sa_gt.nii.gz`` (labels only at ED and
    ES), vendors alternating A/B, and the info CSV, whose path it returns."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    affine = np.diag([1.25, 1.25, 8.0, 1.0])
    rows = []
    for i in range(num_patients):
        pid = f"M{i + 1:03d}"
        vendor = "AB"[i % 2]
        centre = str(i % 3 + 1)
        ed, es = 0, num_frames // 2
        pdir = root / "Training" / "Labeled" / pid
        pdir.mkdir(parents=True, exist_ok=True)
        imgs, gts = [], []
        for t in range(num_frames):
            phase = abs(np.sin(np.pi * t / num_frames))
            img, seg = _phantom_frame(shape_zyx, float(phase), rng)
            imgs.append(img)
            gts.append(seg if t in (ed, es) else np.zeros_like(seg))
        save_nifti(np.stack(imgs), pdir / f"{pid}_sa.nii.gz", affine=affine)
        save_nifti(np.stack(gts).astype(np.uint8), pdir / f"{pid}_sa_gt.nii.gz", affine=affine)
        rows.append({"External code": pid, "ED": ed, "ES": es, "Vendor": vendor,
                     "Centre": centre})
    info_csv = root / "mnms_info.csv"
    with open(info_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["External code", "ED", "ES", "Vendor", "Centre"])
        w.writeheader()
        w.writerows(rows)
    return info_csv
