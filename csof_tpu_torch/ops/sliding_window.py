"""Sliding-window tiling math, Gaussian importance map, and the tile gather
and Gaussian scatter-add on the device.

The host math (``compute_steps``, ``step_grid``, ``gaussian_importance_map``,
``bucket_image_shape``) is that of ``csof_tpu/ops/sliding_window.py``,
carried here so that the port never imports the JAX package; the Gaussian
map is the same scipy computation, bit for bit. ``extract_tiles`` and
``add_tiles`` are the torch side of the JAX predictor's ``dynamic_slice``
gather and ``fori_loop`` scatter-add.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def compute_steps(patch_size: Sequence[int], image_size: Sequence[int],
                  step_size: float) -> list[list[int]]:
    """Per-axis tile starts: ``ceil((image - patch) / (patch * step_size)) + 1``
    steps spread evenly (rounded), the first at 0 and the last at
    ``image - patch``."""
    if not all(i >= j for i, j in zip(image_size, patch_size)):
        raise ValueError(
            f"image size {tuple(image_size)} must be >= patch size {tuple(patch_size)}")
    if not 0 < step_size <= 1:
        raise ValueError("step_size must be in (0, 1]")
    target = [p * step_size for p in patch_size]
    num_steps = [int(np.ceil((i - p) / t)) + 1 for i, t, p in zip(image_size, target, patch_size)]
    steps = []
    for dim, n in enumerate(num_steps):
        if n > 1:
            actual = (image_size[dim] - patch_size[dim]) / (n - 1)
            steps.append([int(np.round(actual * k)) for k in range(n)])
        else:
            steps.append([0])
    return steps


def step_grid(patch_size: Sequence[int], image_size: Sequence[int],
              step_size: float) -> np.ndarray:
    """All tile starts as an (n_tiles, ndim) int32 array, row-major."""
    per_axis = compute_steps(patch_size, image_size, step_size)
    mesh = np.meshgrid(*[np.asarray(s) for s in per_axis], indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def gaussian_importance_map(patch_size: tuple[int, ...],
                            sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Gaussian tile-importance map, max-normalized to 1, zeros replaced by
    the smallest nonzero value: scipy ``gaussian_filter`` of a center delta."""
    tmp = np.zeros(patch_size)
    tmp[tuple(i // 2 for i in patch_size)] = 1
    g = gaussian_filter(tmp, [i * sigma_scale for i in patch_size], 0, mode="constant", cval=0)
    g = (g / np.max(g)).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def bucket_image_shape(image_size: Sequence[int], patch_size: Sequence[int], step_size: float,
                       bucket: int = 32) -> tuple[int, ...]:
    """Each axis larger than the patch rounded up to a multiple of ``bucket``;
    an axis no larger than the patch padded to the patch. The tile grid, and
    so the result, depends on it."""
    out = []
    for i, p in zip(image_size, patch_size):
        i = max(i, p)
        out.append(int(math.ceil(i / bucket) * bucket) if i > p else i)
    return tuple(out)


def extract_tiles(image: torch.Tensor, starts: np.ndarray,
                  patch_size: Sequence[int]) -> torch.Tensor:
    """image (C, *spatial), starts (n, ndim) -> tiles (n, C, *patch)."""
    return torch.stack([
        image[(slice(None),) + tuple(slice(int(s), int(s) + p) for s, p in zip(st, patch_size))]
        for st in starts
    ])


def add_tiles(out: torch.Tensor, wsum: torch.Tensor, weighted: torch.Tensor,
              weight_map: torch.Tensor, starts: np.ndarray) -> None:
    """Scatter-add, in place: ``out[:, tile] += weighted[i]`` and
    ``wsum[tile] += weight_map`` for each start in order. out is (C, *spatial),
    weighted (n, C, *tile), starts (n, ndim) over the trailing axes of wsum
    (a tile of fewer axes than wsum is one voxel deep in the leading ones).
    One tile at a time, in order, so that every voxel sums its overlapping
    tiles in the order of the JAX predictor's loop: no atomics, the same
    result on the CPU and the card."""
    patch = weight_map.shape
    lead = len(starts[0]) - len(patch)
    for st, w in zip(starts, weighted):
        sl = tuple(slice(int(s), int(s) + 1) for s in st[:lead]) + tuple(
            slice(int(s), int(s) + p) for s, p in zip(st[lead:], patch))
        tile_shape = (1,) * lead + tuple(patch)
        out[(slice(None),) + sl] += w.reshape(w.shape[0], *tile_shape)
        wsum[sl] += weight_map.reshape(tile_shape)
