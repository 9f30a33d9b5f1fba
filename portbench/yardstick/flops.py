"""The model FLOPs a cell's inputs need, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the products of the
reference (convolutions, transposed convolutions, matrix products and their
gradients) at the cell's shapes, on the meta device, so no work runs and the
count is the same whatever implements the work in the program. It does not
see elementwise products, so SegFlow's local correlation, which the
reference writes as shifted products, is added from its shapes: a
multiply-add per channel, window position and pixel of each level.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import segflow as ref_segflow
from portbench.reference import unet as ref_unet


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def segflow_forward_flops(cfg_items: tuple, classes: int, slices: int, frames: int,
                          crop: int) -> int:
    """FLOPs of one serving forward of ``slices`` cines of ``frames`` frames
    at crop x crop; ``cfg_items`` is the model configuration as sorted
    (key, value) pairs."""
    cfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg_items}
    model = ref_segflow.SegFlow(cfg, classes, device="meta")
    video = torch.empty((slices, frames, crop, crop, 1), device="meta")
    with torch.no_grad():
        flops = _counted(lambda: model(video))
    # the correlation at each level: the prime step runs the last level only
    dims, corr = cfg["out_encoder_dims"], 0
    for lvl, c in enumerate(dims):
        px = (crop >> lvl) ** 2
        calls = frames if lvl == len(dims) - 1 else frames - 1
        corr += 2 * (2 * cfg["corr_radius"][lvl] + 1) ** 2 * c * px * slices * calls
    return flops + corr


@functools.lru_cache(maxsize=None)
def unet_step_flops(base: int, cap: int, pools: int, classes: int, batch: int,
                    patch: tuple) -> int:
    """FLOPs of one training step's forward and backward (data gradient of
    every conv but the first, weight gradients of all) at ``batch`` x patch."""
    model = ref_unet.UNet2d(base, cap, pools, classes, device="meta")
    data = torch.empty((batch, 1, *patch), device="meta")
    seg = torch.zeros((batch, *patch), dtype=torch.long, device="meta")
    return _counted(lambda: ref_unet.loss(model, data, seg).backward())
