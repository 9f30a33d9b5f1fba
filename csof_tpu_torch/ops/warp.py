"""Dense-flow backward warping on ``F.grid_sample``.

Port of ``csof_tpu/ops/warp.py`` ``warp_image_cm``: warped(x) = image(x + flow(x)),
bilinear, with the flow channel-major in voxels, channel 0 along H (dy) and
channel 1 along W (dx). ``padding="border"`` clamps the sample coordinates to
the image, which is what the JAX sampler's index clamp computes;
``padding="zeros"`` samples zero outside it. The gradient with respect to the
flow is autograd's through ``grid_sample``; it agrees with ``jax.grad`` of the
JAX sampler off the integer coordinates of the border (there the two pick
other one-sided derivatives). A non-finite flow gives NaN where it is
non-finite, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_image_cm(image: torch.Tensor, flow_cm: torch.Tensor,
                  padding: str = "zeros") -> torch.Tensor:
    """image (B, C, H, W), flow (B, 2, H, W) -> (B, C, H, W) in the image dtype."""
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    _, _, h, w = image.shape
    ys = torch.arange(h, device=flow_cm.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=flow_cm.device, dtype=torch.float32).view(1, 1, w)
    flow = flow_cm.float()
    # voxel coordinates -> grid_sample's normalized (x, y), align_corners=True
    gx = (xs + flow[:, 1]) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + flow[:, 0]) * (2.0 / max(h - 1, 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    # grid_sample clamps a NaN coordinate to a finite one under "border" (and
    # its CPU backward then reads out of bounds): sample a stand-in there and
    # put the NaN back in the result
    finite = torch.isfinite(grid).all(-1)
    grid = torch.where(finite[..., None], grid, -2.0)
    out = F.grid_sample(image.float(), grid, mode="bilinear", padding_mode=padding,
                        align_corners=True)
    out = torch.where(finite[:, None], out, float("nan"))
    return out.to(image.dtype)
