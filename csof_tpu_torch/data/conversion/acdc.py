"""ACDC (Automated Cardiac Diagnosis Challenge) conversion (port of
``csof_tpu/data/conversion/acdc.py``, numpy only).

Each patient's ``Info.cfg`` names the labeled ED and ES frames; their
``patientXXX_frameYY.nii.gz`` (and ``_gt``) are copied into the raw-task
layout (``imagesTr/<case>_0000.nii.gz``, ``labelsTr/<case>.nii.gz``,
``dataset.json``) with the ED/ES numbers and the whole 4D cine for the video
pipeline. ``make_synthetic_acdc`` writes the same beating-ellipse phantoms,
byte for byte, from the same seed.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

ACDC_LABELS = {0: "background", 1: "RV", 2: "MYO", 3: "LV"}


def read_info_cfg(path: str | Path) -> dict:
    """Parse an ACDC Info.cfg (ED/ES frame numbers, 1-based)."""
    out = {}
    for line in Path(path).read_text().splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            out[k.strip()] = v.strip()
    return out


def convert_acdc(acdc_root: str | Path, out_task_dir: str | Path, no_norm: bool = False,
                 export_unlabeled: bool = False) -> dict:
    """acdc_root: a folder of patientXXX dirs. Writes the raw-task layout and
    returns its dataset.json.

    ``no_norm=True`` names the modality "noNorm", so that the planner picks
    the no-op intensity scheme (the NoNorm task variants).
    ``export_unlabeled=True`` also writes every unannotated cine frame as
    ``<pid>_frame<NN>_u`` into imagesTr and lists them under
    dataset.json["unlabeled"]."""
    acdc_root, out = Path(acdc_root), Path(out_task_dir)
    images_tr, labels_tr, cine_dir = out / "imagesTr", out / "labelsTr", out / "cine"
    for d in (images_tr, labels_tr, cine_dir):
        d.mkdir(parents=True, exist_ok=True)

    ed_es, cases, unlabeled = {}, [], []
    for pdir in sorted(acdc_root.glob("patient*")):
        info = read_info_cfg(pdir / "Info.cfg")
        ed, es = int(info["ED"]), int(info["ES"])
        pid = pdir.name
        ed_es[pid] = {"ed": ed, "es": es}
        for frame in (ed, es):
            src = pdir / f"{pid}_frame{frame:02d}.nii.gz"
            gt = pdir / f"{pid}_frame{frame:02d}_gt.nii.gz"
            case = f"{pid}_frame{frame:02d}"
            if src.exists():
                shutil.copy(src, images_tr / f"{case}_0000.nii.gz")
                cases.append(case)
            if gt.exists():
                shutil.copy(gt, labels_tr / f"{case}.nii.gz")
        cine = pdir / f"{pid}_4d.nii.gz"
        if cine.exists():
            shutil.copy(cine, cine_dir / f"{pid}_4d.nii.gz")
            if export_unlabeled:
                vol4d = load_nifti(cine)
                for t in range(vol4d.data_czyx.shape[0]):
                    fnum = t + 1  # ACDC frame numbers are 1-based
                    if fnum in (ed, es):
                        continue
                    ucase = f"{pid}_frame{fnum:02d}_u"
                    save_nifti(vol4d.data_czyx[t].astype(np.float32),
                               images_tr / f"{ucase}_0000.nii.gz", affine=vol4d.affine,
                               spacing_xyz=vol4d.itk_spacing)
                    unlabeled.append(ucase)

    dataset_json = {
        "name": "ACDCNoNorm" if no_norm else "ACDC",
        "tensorImageSize": "3D",
        "modality": {"0": "noNorm" if no_norm else "MRI"},
        "labels": {str(k): v for k, v in ACDC_LABELS.items()},
        "numTraining": len(cases),
        "training": [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                     for c in cases],
        "ed_es_numbers": ed_es,
    }
    if export_unlabeled:
        dataset_json["numUnlabeled"] = len(unlabeled)
        dataset_json["unlabeled"] = [{"image": f"./imagesTr/{c}.nii.gz"} for c in unlabeled]
    (out / "dataset.json").write_text(json.dumps(dataset_json, indent=2))
    return dataset_json


def _phantom_frame(shape_zyx, phase: float, rng: np.random.RandomState):
    """One cine frame: concentric LV (3) / MYO (2) ellipses and an RV (1)
    crescent that contract with ``phase`` in [0, 1] (0 = ED, 1 = ES)."""
    z, y, x = shape_zyx
    img = np.zeros(shape_zyx, np.float32)
    seg = np.zeros(shape_zyx, np.int16)
    cy, cx = y / 2, x / 2
    contraction = 1.0 - 0.3 * phase
    zz, yy, xx = np.mgrid[:z, :y, :x]
    r_lv = 0.16 * y * contraction
    r_myo = 0.26 * y * (1.0 - 0.12 * phase)
    lv = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r_lv**2
    myo = (((yy - cy) ** 2 + (xx - cx) ** 2) <= r_myo**2) & ~lv
    rv_c = ((yy - cy) ** 2 + (xx - cx - 0.3 * x * contraction) ** 2) <= (0.14 * y * contraction) ** 2
    rv = rv_c & ~lv & ~myo
    seg[lv], seg[myo], seg[rv] = 3, 2, 1
    img += lv * 0.9 + myo * 0.45 + rv * 0.75
    img += rng.rand(*shape_zyx).astype(np.float32) * 0.08 + 0.05
    return img, seg


def make_synthetic_acdc(root: str | Path, num_patients: int = 3, num_frames: int = 8,
                        shape_zyx=(6, 48, 48), seed: int = 0) -> Path:
    """Write an ACDC-layout folder of beating phantoms: per patient the ED
    and ES frames with labels, the 4D cine and Info.cfg."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    affine = np.diag([1.5, 1.5, 5.0, 1.0])  # (x, y, z) spacings
    for p in range(1, num_patients + 1):
        pid = f"patient{p:03d}"
        pdir = root / pid
        pdir.mkdir(parents=True, exist_ok=True)
        ed_frame, es_frame = 1, num_frames // 2 + 1
        frames = []
        for t in range(num_frames):
            phase = np.sin(np.pi * t / (num_frames // 2)) if t <= num_frames // 2 else (
                np.sin(np.pi * (num_frames - t) / (num_frames - num_frames // 2)))
            img, seg = _phantom_frame(shape_zyx, float(np.clip(phase, 0, 1)), rng)
            frames.append(img)
            fnum = t + 1
            if fnum in (ed_frame, es_frame):
                save_nifti(img, pdir / f"{pid}_frame{fnum:02d}.nii.gz", affine=affine)
                save_nifti(seg.astype(np.uint8), pdir / f"{pid}_frame{fnum:02d}_gt.nii.gz",
                           affine=affine)
        save_nifti(np.stack(frames), pdir / f"{pid}_4d.nii.gz", affine=affine)  # (t, z, y, x)
        (pdir / "Info.cfg").write_text(
            f"ED: {ed_frame}\nES: {es_frame}\nGroup: NOR\nHeight: 170\nNbFrame: {num_frames}\n"
            "Weight: 70\n")
    return root
