"""Heart-ROI processor: mask -> centroid -> fixed crop -> uncrop.

The part of ``csof_tpu/inference/processor.py`` that flow serving uses,
carried here so that the port never imports the JAX package
(``tests/test_torch_serving.py`` holds the two to the same results).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def mask_centroid(mask: np.ndarray) -> tuple[float, float]:
    """Center of the mask's bounding box (image center for an empty mask)."""
    if not mask.any():
        return (mask.shape[0] / 2, mask.shape[1] / 2)
    ys, xs = np.where(mask)
    return ((ys.min() + ys.max()) / 2.0, (xs.min() + xs.max()) / 2.0)


def adjust_cropping_window(center_y: float, center_x: float, image_hw, crop_size: int):
    """Clamp a crop window center so the window fits inside the image."""
    h, w = image_hw
    half = crop_size / 2.0
    cy = min(max(center_y, half), max(h - half, half))
    cx = min(max(center_x, half), max(w - half, half))
    y0 = int(round(cy - half))
    x0 = int(round(cx - half))
    y0 = max(0, min(y0, max(h - crop_size, 0)))
    x0 = max(0, min(x0, max(w - crop_size, 0)))
    return y0, x0


class Processor:
    """crop_size-square heart ROI cropping around a mask centroid."""

    def __init__(self, crop_size: int = 128,
                 cropping_network: Callable[[np.ndarray], np.ndarray] | None = None):
        self.crop_size = crop_size
        self.cropping_network = cropping_network

    def get_mask(self, image: np.ndarray) -> np.ndarray:
        """image (H, W) -> binary heart mask: the cropping network's
        argmax > 0, or without one, pixels above mean + std."""
        if self.cropping_network is None:
            return image > image.mean() + image.std()
        return np.asarray(self.cropping_network(image)) > 0

    def crop(self, frames: np.ndarray, mask: np.ndarray | None = None):
        """frames (T, H, W) or (H, W) -> (cropped, window record); the window
        comes from `mask` (or the first frame's mask) and is shared by all
        frames."""
        single = frames.ndim == 2
        if single:
            frames = frames[None]
        h, w = frames.shape[-2:]
        cs = self.crop_size
        if mask is None:
            mask = self.get_mask(frames[0])
        cy, cx = mask_centroid(np.asarray(mask, bool))
        y0, x0 = adjust_cropping_window(cy, cx, (h, w), cs)
        padded = np.pad(frames, ((0, 0), (0, max(cs - h, 0)), (0, max(cs - w, 0))))
        out = padded[:, y0 : y0 + cs, x0 : x0 + cs]
        record = {"y0": y0, "x0": x0, "orig_hw": (h, w), "crop_size": cs}
        return (out[0] if single else out), record

    def uncrop(self, cropped: np.ndarray, record: dict, fill=0.0) -> np.ndarray:
        """Pad a (..., cs, cs) prediction back to the full FOV."""
        h, w = record["orig_hw"]
        cs = record["crop_size"]
        out_shape = (*cropped.shape[:-2], max(h, record["y0"] + cs), max(w, record["x0"] + cs))
        out = np.full(out_shape, fill, dtype=cropped.dtype)
        out[..., record["y0"] : record["y0"] + cs, record["x0"] : record["x0"] + cs] = cropped
        return out[..., :h, :w]
