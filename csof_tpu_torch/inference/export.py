"""Segmentation export: resample the softmax back to the cropped grid, argmax,
embed in the original field of view and write NIfTI.

``resample_to_shape`` and ``save_segmentation_from_softmax`` of
``csof_tpu/inference/export.py`` (numpy/scipy), carried here so that the port
never imports the JAX package. The region-based export
(``region_class_order``) is not carried.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from csof_tpu_torch.ops.resample import get_do_separate_z, get_lowres_axis, resample_data_or_seg
from csof_tpu_torch.utils.nifti import save_nifti


def resample_to_shape(data: np.ndarray, new_shape, is_seg: bool = False, spacing_current=None,
                      spacing_target=None, order: int = 1, order_z: int = 0,
                      force_separate_z=None) -> np.ndarray:
    """(c, *spatial) -> (c, *new_shape), with the separate-z decision
    preprocessing made."""
    if np.all(np.array(data.shape[1:]) == np.array(new_shape)):
        return data
    if force_separate_z is None:
        do_sep, axis = False, None
        if spacing_current is not None and get_do_separate_z(spacing_current):
            do_sep, axis = True, get_lowres_axis(spacing_current)
        elif spacing_target is not None and get_do_separate_z(spacing_target):
            do_sep, axis = True, get_lowres_axis(spacing_target)
    else:
        do_sep = force_separate_z
        axis = (get_lowres_axis(spacing_current)
                if (do_sep and spacing_current is not None) else None)
    if axis is not None and len(axis) != 1:
        do_sep, axis = False, None
    return resample_data_or_seg(data, new_shape, is_seg, axis=axis, order=order,
                                do_separate_z=do_sep, order_z=order_z)


def save_segmentation_from_softmax(softmax: np.ndarray, out_file: str | Path, properties: dict,
                                   order: int = 1, force_separate_z=None,
                                   interpolation_order_z: int = 0, save_npz: bool = False) -> None:
    """softmax: (C, *size_after_resampling). Writes ``out_file`` as NIfTI in
    the original image geometry (and the resampled softmax as .npz with
    ``save_npz``)."""
    out_file = Path(out_file)
    shape_original = tuple(int(s) for s in properties["original_size_of_raw_data"])
    shape_after_cropping = tuple(int(s) for s in properties.get("size_after_cropping",
                                                                 shape_original))
    softmax = resample_to_shape(
        softmax.astype(np.float32), shape_after_cropping, is_seg=False,
        spacing_current=properties.get("spacing_after_resampling"),
        spacing_target=properties.get("original_spacing"), order=order,
        order_z=interpolation_order_z, force_separate_z=force_separate_z)
    if save_npz:
        np.savez_compressed(out_file.with_suffix("").with_suffix(".npz"), softmax=softmax)

    seg_cropped = softmax.argmax(0)
    bbox = properties.get("crop_bbox")
    if bbox is not None:
        seg = np.zeros(shape_original, dtype=np.uint8)
        seg[tuple(slice(b[0], b[0] + s) for b, s in zip(bbox, seg_cropped.shape))] = seg_cropped
    else:
        seg = seg_cropped.astype(np.uint8)
    save_nifti(seg, out_file, affine=properties.get("nifti_affine"),
               spacing_xyz=tuple(properties["original_spacing"][::-1]))
