"""Cardiac cine video datasets for SegFlow (port of
``csof_tpu/data/video_dataset.py``, numpy only): the per-patient video dict
that :class:`csof_tpu_torch.data.loaders.VideoChunkLoader` samples, built
from a converted task folder (``cine/<pid>_4d.nii.gz``, the ED/ES numbers in
``dataset.json`` or a CSV, the ED/ES labels in ``labelsTr``).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

from csof_tpu_torch.data.dataset import do_split
from csof_tpu_torch.utils.nifti import load_nifti


def read_ed_es_csv(csv_file: str | Path) -> dict[str, dict]:
    """{patient: {"ed", "es"}} (1-based frame numbers) from a CSV with the
    columns patient, ed, es (any case)."""
    out: dict[str, dict] = {}
    with open(csv_file, newline="") as f:
        reader = csv.DictReader(f)
        cols = {c.lower(): c for c in reader.fieldnames or []}
        for row in reader:
            pid = row[cols.get("patient", "patient")]
            out[pid] = {"ed": int(float(row[cols.get("ed", "ed")])),
                        "es": int(float(row[cols.get("es", "es")]))}
    return out


def build_video_datasets(task_dir: str | Path,
                         ed_es_csv: str | Path | None = None) -> dict[str, dict]:
    """patient -> {"frames": (T, z, y, x) float32, "seg": (T, z, y, x) int16,
    -1 on the frames without a label (labels at ED and ES only), "ed", "es"}
    (0-based frame indices), for every cine with ED/ES numbers."""
    task_dir = Path(task_dir)
    dj = json.loads((task_dir / "dataset.json").read_text())
    ed_es = dj.get("ed_es_numbers", {})
    if ed_es_csv is not None:
        ed_es = {**ed_es, **read_ed_es_csv(ed_es_csv)}
    videos: dict[str, dict] = {}
    for cine_file in sorted((task_dir / "cine").glob("*_4d.nii.gz")):
        pid = cine_file.name.replace("_4d.nii.gz", "")
        info = ed_es.get(pid)
        if info is None:
            continue
        frames = load_nifti(cine_file).data_czyx.astype(np.float32)  # (T, z, y, x)
        ed, es = int(info["ed"]) - 1, int(info["es"]) - 1
        seg = np.full(frames.shape, -1, np.int16)
        for fnum in (ed, es):
            gt = task_dir / "labelsTr" / f"{pid}_frame{fnum + 1:02d}.nii.gz"
            if gt.exists():
                seg[fnum] = load_nifti(gt).data_czyx.astype(np.int16)
        videos[pid] = {"frames": frames, "seg": seg, "ed": ed, "es": es}
    return videos


def put_ed_first(frames: np.ndarray, ed_idx: int, seg: np.ndarray | None = None):
    """Roll the time axis so that the ED frame is frame 0 (flow inference
    anchors the cumulative field there). Returns (frames, seg, inverse_roll);
    rolling outputs by inverse_roll restores the acquisition order."""
    ed_idx = int(ed_idx) % frames.shape[0]
    rolled = np.roll(frames, -ed_idx, axis=0)
    seg_rolled = np.roll(seg, -ed_idx, axis=0) if seg is not None else None
    return rolled, seg_rolled, ed_idx


def restore_frame_order(arr: np.ndarray, inverse_roll: int) -> np.ndarray:
    return np.roll(arr, inverse_roll, axis=0)


def split_videos(videos: dict[str, dict], fold: int, n_splits: int = 5, seed: int = 12345):
    """(train, val) video dicts of ``fold`` from the 5-fold split of the
    sorted patient ids."""
    tr, va = do_split(sorted(videos), fold, n_splits=n_splits, seed=seed)
    return {k: videos[k] for k in tr}, {k: videos[k] for k in va}
