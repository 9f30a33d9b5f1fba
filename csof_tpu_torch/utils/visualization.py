"""Flow colour wheels and segmentation overlays (port of the numpy part of
``csof_tpu/utils/visualization.py``): ``flow_to_image`` and
``seg_overlay``, bit for bit the JAX package's."""

from __future__ import annotations

import numpy as np


def flow_to_image(flow: np.ndarray, max_norm: float | None = None) -> np.ndarray:
    """(H, W, 2) flow, channel 0 along y -> (H, W, 3) uint8 colour wheel
    (Middlebury convention): hue the direction, saturation the magnitude
    over ``max_norm`` (the largest by default)."""
    fy, fx = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx**2 + fy**2)
    ang = np.arctan2(fy, fx)
    if max_norm is None:
        max_norm = max(float(mag.max()), 1e-6)
    hue = (ang + np.pi) / (2 * np.pi)
    sat = np.clip(mag / max_norm, 0, 1)
    val = np.ones_like(hue)
    i = np.floor(hue * 6).astype(int) % 6
    f = hue * 6 - np.floor(hue * 6)
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    rgb = np.zeros((*hue.shape, 3))
    for k, (r, g, b) in enumerate([(val, t, p), (q, val, p), (p, val, t), (p, q, val),
                                   (t, p, val), (val, p, q)]):
        m = i == k
        rgb[m, 0], rgb[m, 1], rgb[m, 2] = r[m], g[m], b[m]
    return (rgb * 255).astype(np.uint8)


_SEG_COLORS = np.array(
    [[0, 0, 0], [230, 60, 60], [60, 180, 75], [60, 100, 230], [255, 225, 25],
     [145, 30, 180], [70, 240, 240]], np.float32,
)


def seg_overlay(image: np.ndarray, seg: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """(H, W) image in [0, 1] and (H, W) integer labels -> (H, W, 3) uint8:
    each labelled pixel blended with its class colour."""
    img = np.clip(image, 0, 1)[..., None] * 255
    rgb = np.repeat(img, 3, axis=-1)
    colors = _SEG_COLORS[np.clip(seg, 0, len(_SEG_COLORS) - 1)]
    mask = (seg > 0)[..., None]
    out = np.where(mask, (1 - alpha) * rgb + alpha * colors, rgb)
    return out.astype(np.uint8)
