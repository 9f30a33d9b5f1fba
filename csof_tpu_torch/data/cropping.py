"""Nonzero-bounding-box cropping of raw cases: ``crop_case``, its helpers and
the folder writer ``run_cropping`` from ``csof_tpu/data/cropping.py``
(numpy/scipy), carried here so that the port never imports the JAX package.
``run_cropping`` crops the cases in worker processes (``utils/pool.py``)."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
from scipy.ndimage import binary_fill_holes

from csof_tpu_torch.utils.nifti import load_nifti
from csof_tpu_torch.utils.pool import map_in_processes


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """(c, *spatial) -> union over channels of the filled nonzero regions."""
    if data.ndim not in (3, 4):
        raise ValueError(f"data must be (c, y, x) or (c, z, y, x), got {data.shape}")
    mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    return binary_fill_holes(mask)


def get_bbox_from_mask(mask: np.ndarray, outside_value: float = 0) -> list[list[int]]:
    """Per-axis [min, max + 1] bounds of the non-outside region."""
    coords = np.where(mask != outside_value)
    return [[int(c.min()), int(c.max()) + 1] for c in coords]


def crop_to_bbox(image: np.ndarray, bbox: list[list[int]]) -> np.ndarray:
    return image[tuple(slice(b[0], b[1]) for b in bbox)]


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray | None = None, nonzero_label: int = -1):
    """Crop (c, *sp) data (and seg) to the nonzero bounding box; voxels
    outside the mask that are background in seg get ``nonzero_label``."""
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask, 0)
    data = np.stack([crop_to_bbox(data[c], bbox) for c in range(data.shape[0])])
    if seg is not None:
        seg = np.stack([crop_to_bbox(seg[c], bbox) for c in range(seg.shape[0])])
    mask = crop_to_bbox(nonzero_mask, bbox)
    if seg is not None:
        seg[(seg == 0) & (~mask[None])] = nonzero_label
    else:
        seg = np.where(mask, 0, nonzero_label).astype(np.float32)[None]
    return data, seg, bbox


def crop_case(data_files: list[str | Path], seg_file: str | Path | None = None):
    """Load the NIfTI modalities (and seg), stack to (c, z, y, x), crop to
    nonzero. Returns (data, seg, properties)."""
    images = [load_nifti(f) for f in data_files]
    data = np.stack([im.data_czyx for im in images]).astype(np.float32)
    properties = {
        "original_size_of_raw_data": np.array(data.shape[1:]),
        "original_spacing": np.array(images[0].spacing_zyx, dtype=float),
        "list_of_data_files": [str(f) for f in data_files],
        "seg_file": str(seg_file) if seg_file else None,
        "itk_origin": images[0].origin,
        "itk_spacing": images[0].itk_spacing,
        "itk_direction": images[0].direction,
        "nifti_affine": images[0].affine,
    }
    seg = None
    if seg_file is not None:
        seg = load_nifti(seg_file).data_czyx[None].astype(np.float32)
    data, seg, bbox = crop_to_nonzero(data, seg, nonzero_label=-1)
    properties["crop_bbox"] = bbox
    properties["classes"] = np.unique(seg)
    properties["size_after_cropping"] = data[0].shape
    seg[seg < -1] = 0
    return data, seg, properties


def _crop_one(job) -> str:
    """Crop one case into ``<case_id>.npz`` (data and seg stacked, float32)
    and ``<case_id>.pkl`` (properties); an existing pair is kept unless
    ``overwrite``."""
    case_id, data_files, seg_file, out_dir, overwrite = job
    out_npz, out_pkl = Path(out_dir) / f"{case_id}.npz", Path(out_dir) / f"{case_id}.pkl"
    if out_npz.exists() and out_pkl.exists() and not overwrite:
        return case_id
    data, seg, props = crop_case(data_files, seg_file)
    np.savez_compressed(out_npz, data=np.vstack([data, seg]).astype(np.float32))
    with open(out_pkl, "wb") as f:
        pickle.dump(props, f)
    return case_id


def run_cropping(cases: list[tuple[str, list[str], str | None]], out_dir: str | Path,
                 num_workers: int = 8, overwrite: bool = False) -> list[str]:
    """Crop each (case_id, modality files, seg file) into ``out_dir`` in
    ``num_workers`` processes (one: in this process). Returns the case ids."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(cid, files, seg, out_dir, overwrite) for cid, files, seg in cases]
    return map_in_processes(_crop_one, jobs, num_workers)
