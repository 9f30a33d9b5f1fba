"""``pad_nd_image`` of ``csof_tpu/ops/padcrop.py`` (numpy), carried here so
that the port never imports the JAX package. Only what the predictor uses:
a zero pad to a shape, returned with its slicer."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_nd_image(image: np.ndarray, new_shape: Sequence[int]) -> tuple[np.ndarray, tuple]:
    """Symmetric zero pad of the trailing axes up to ``new_shape`` (never
    crops): leading axes untouched, the extra voxel of an odd pad at the
    end. Returns the padded array and the slicer that recovers the original."""
    num_lead = image.ndim - len(new_shape)
    old = np.array(image.shape)
    target = list(image.shape[:num_lead]) + [
        max(int(n), int(o)) for n, o in zip(new_shape, image.shape[num_lead:])]
    diff = np.array(target) - old
    below = diff // 2
    padded = np.pad(image, [(int(b), int(d - b)) for b, d in zip(below, diff)])
    return padded, tuple(slice(int(b), int(b + o)) for b, o in zip(below, old))
