"""The model FLOPs of a 3-D U-Net training step, counted on the plain 3-D
reference as ``flops.py`` counts the 2-D one: ``FlopCounterMode`` over the
reference's loss and backward at the cell's shapes, on the meta device."""

from __future__ import annotations

import functools

import torch

from portbench.reference import unet3d as ref_unet3d
from portbench.yardstick.flops import _counted


@functools.lru_cache(maxsize=None)
def unet3d_step_flops(base: int, cap: int, pools: tuple, kernels: tuple, classes: int,
                      batch: int, patch: tuple) -> int:
    """FLOPs of one training step's forward and backward (data gradient of
    every conv but the first, weight gradients of all) at ``batch`` x patch
    (D, H, W); ``pools`` and ``kernels`` per-axis tuples a level."""
    model = ref_unet3d.UNet3d(base, cap, pools, kernels, classes, device="meta")
    data = torch.empty((batch, 1, *patch), device="meta")
    seg = torch.zeros((batch, *patch), dtype=torch.long, device="meta")
    return _counted(lambda: ref_unet3d.loss(model, data, seg).backward())
