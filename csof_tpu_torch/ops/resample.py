"""Spacing resampling with nnU-Net's separate-z semantics (numpy/scipy).

The host part of ``csof_tpu/ops/resample.py``, carried here so that the port
never imports the JAX package (``tests/test_torch_unet.py`` holds the two to
identical arrays). The coordinate map is skimage ``resize``'s
``scale * (i + 0.5) - 0.5``, evaluated with ``scipy.ndimage.map_coordinates``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.ndimage import map_coordinates

ANISO_THRESHOLD = 3


def _half_pixel_coords(old_shape, new_shape) -> np.ndarray:
    scales = [o / n for o, n in zip(old_shape, new_shape)]
    grids = np.meshgrid(*[s * (np.arange(n) + 0.5) - 0.5 for s, n in zip(scales, new_shape)],
                        indexing="ij")
    return np.stack(grids)


def spline_resize(data: np.ndarray, new_shape: Sequence[int], order: int = 3,
                  mode: str = "nearest") -> np.ndarray:
    """skimage ``resize(anti_aliasing=False, mode='edge')`` equivalent."""
    new_shape = tuple(int(s) for s in new_shape)
    if tuple(data.shape) == new_shape:
        return data.copy()
    coords = _half_pixel_coords(data.shape, new_shape)
    return map_coordinates(data.astype(float), coords, order=order, mode=mode)


def resize_segmentation(seg: np.ndarray, new_shape: Sequence[int], order: int = 1) -> np.ndarray:
    """Label-safe resize: order-0 nearest, or a per-label one-hot spline
    resize thresholded at 0.5."""
    dtype = seg.dtype
    if order == 0:
        return spline_resize(seg, new_shape, order=0).astype(dtype)
    out = np.zeros(tuple(new_shape), dtype=dtype)
    for label in np.unique(seg):
        mask = (seg == label).astype(float)
        out[spline_resize(mask, new_shape, order=order) >= 0.5] = label
    return out


def get_do_separate_z(spacing, threshold: float = ANISO_THRESHOLD) -> bool:
    return (np.max(spacing) / np.min(spacing)) > threshold


def get_lowres_axis(spacing) -> np.ndarray:
    return np.where(max(spacing) / np.array(spacing) == 1)[0]


def compute_new_shape(shape, original_spacing, target_spacing) -> np.ndarray:
    return np.round(
        (np.array(original_spacing) / np.array(target_spacing)).astype(float) * np.array(shape)
    ).astype(int)


def resample_data_or_seg(data: np.ndarray, new_shape: Sequence[int], is_seg: bool,
                         axis: np.ndarray | None = None, order: int = 3,
                         do_separate_z: bool = False, order_z: int = 0) -> np.ndarray:
    """(c, x, y, z) resample; with ``do_separate_z``, each slice along the
    anisotropic ``axis`` in-plane with ``order``, then across the axis with
    ``order_z``."""
    if data.ndim != 4:
        raise ValueError(f"data must be (c, x, y, z), got {data.shape}")
    new_shape = np.array([int(s) for s in new_shape])
    shape = np.array(data.shape[1:])
    dtype_data = data.dtype
    if np.all(shape == new_shape):
        return data

    resize_fn = resize_segmentation if is_seg else spline_resize
    data = data.astype(float)
    if not do_separate_z:
        return np.stack([resize_fn(data[c], new_shape, order).astype(dtype_data)
                         for c in range(data.shape[0])])
    if axis is None or len(axis) != 1:
        raise ValueError("only one anisotropic axis is supported")
    ax = int(axis[0])
    new_shape_2d = np.delete(new_shape, ax)
    out_channels = []
    for c in range(data.shape[0]):
        slices = [resize_fn(np.take(data[c], s, axis=ax), new_shape_2d, order).astype(dtype_data)
                  for s in range(shape[ax])]
        stacked = np.stack(slices, axis=ax)
        if shape[ax] == new_shape[ax]:
            out_channels.append(stacked[None])
            continue
        coords = _half_pixel_coords(stacked.shape, new_shape)
        if not is_seg or order_z == 0:
            out_channels.append(map_coordinates(stacked, coords, order=order_z,
                                                mode="nearest")[None].astype(dtype_data))
        else:
            reshaped = np.zeros(tuple(new_shape), dtype=dtype_data)
            for label in np.unique(stacked):
                mask = (stacked == label).astype(float)
                up = np.round(map_coordinates(mask, coords, order=order_z, mode="nearest"))
                reshaped[up > 0.5] = label
            out_channels.append(reshaped[None])
    return np.vstack(out_channels)


def resample_patient(data: np.ndarray | None, seg: np.ndarray | None, original_spacing,
                     target_spacing, order_data: int = 3, order_seg: int = 0,
                     force_separate_z: bool | None = False, order_z_data: int = 0,
                     order_z_seg: int = 0,
                     separate_z_anisotropy_threshold: float = ANISO_THRESHOLD):
    """Joint data + seg resample of (c, x, y, z) arrays to the target spacing."""
    if data is None and seg is None:
        raise ValueError("data or seg must be given")
    ref_arr = data if data is not None else seg
    if ref_arr.ndim != 4:
        raise ValueError(f"data/seg must be (c, x, y, z), got {ref_arr.shape}")
    new_shape = compute_new_shape(np.array(ref_arr[0].shape), original_spacing, target_spacing)

    if force_separate_z is not None:
        do_separate_z = force_separate_z
        axis = get_lowres_axis(original_spacing) if force_separate_z else None
    elif get_do_separate_z(original_spacing, separate_z_anisotropy_threshold):
        do_separate_z, axis = True, get_lowres_axis(original_spacing)
    elif get_do_separate_z(target_spacing, separate_z_anisotropy_threshold):
        do_separate_z, axis = True, get_lowres_axis(target_spacing)
    else:
        do_separate_z, axis = False, None
    if axis is not None and len(axis) != 1:
        do_separate_z = False  # all-axes or in-plane anisotropy: joint resampling

    data_out = None if data is None else resample_data_or_seg(
        data, new_shape, False, axis, order_data, do_separate_z, order_z=order_z_data)
    seg_out = None if seg is None else resample_data_or_seg(
        seg, new_shape, True, axis, order_seg, do_separate_z, order_z=order_z_seg)
    return data_out, seg_out
