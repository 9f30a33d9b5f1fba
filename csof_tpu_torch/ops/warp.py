"""Dense-flow backward warping (port of ``csof_tpu/ops/warp.py``).

``identity_grid``, ``grid_sample`` and ``compose_flows`` are the JAX
package's: sampling at pixel coordinates (channel 0 along H, 1 along W),
bilinear as the sum of the four corners' weighted values in the JAX order,
nearest by ``round`` (half to even), ``"zeros"`` padding per corner or
``"border"`` clamping; they serve the augmentation's spatial warp and the
sliding-window flow predictor. ``warp_points`` advects contour points
through a flow with that sampler (bilinear, border).

``warp_batch``, on ``F.grid_sample``: warped(x) = image(x + flow(x)),
bilinear or trilinear, channels last, for 2D and 3D: images
``(N, *spatial, C)``, flows ``(N, *spatial, ndim)`` in voxels with channel d
along spatial axis d. ``padding="border"`` clamps the sample coordinates to
the image, which is what the JAX sampler's index clamp computes;
``padding="zeros"`` samples zero outside it. The gradient with respect to the
flow is autograd's through ``grid_sample``; it agrees with ``jax.grad`` of the
JAX sampler off the integer coordinates of the border (there the two pick
other one-sided derivatives). A non-finite flow gives NaN where it is
non-finite, as in JAX. ``warp_image`` takes one image without the batch
axis; ``warp_image_cm`` is the same warp for a channel-major 2D batch,
``(B, C, H, W)`` by ``(B, 2, H, W)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_image_cm(image: torch.Tensor, flow_cm: torch.Tensor,
                  padding: str = "zeros") -> torch.Tensor:
    """image (B, C, H, W), flow (B, 2, H, W) -> (B, C, H, W) in the image dtype."""
    return warp_batch(image.movedim(1, -1), flow_cm.movedim(1, -1), padding).movedim(-1, 1)


def identity_grid(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """(*shape, ndim) pixel-coordinate identity grid."""
    ranges = [torch.arange(s, dtype=dtype, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*ranges, indexing="ij"), dim=-1)


def grid_sample(image: torch.Tensor, coords: torch.Tensor, mode: str = "bilinear",
                padding: str = "zeros") -> torch.Tensor:
    """Sample ``image`` (N, C, H, W) at pixel ``coords`` (N, Ho, Wo, 2), (y, x)
    in pixels, -> (N, C, Ho, Wo) in the image dtype. ``mode`` "bilinear" or
    "nearest"; ``padding`` "zeros" (a corner outside contributes nothing) or
    "border" (indices clamped)."""
    if mode not in ("bilinear", "nearest") or padding not in ("zeros", "border"):
        raise ValueError(f"mode {mode!r} / padding {padding!r}")
    n, c, h, w = image.shape
    flat = image.reshape(n, c, h * w)
    out_shape = coords.shape[1:3]

    def gather(iy, ix):
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, -1)
        return flat.gather(2, idx.expand(n, c, idx.shape[-1])).reshape(n, c, *out_shape)

    def inside(iy, ix):
        return ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).to(image.dtype)[:, None]

    if mode == "nearest":
        idx = torch.round(coords).long()
        out = gather(idx[..., 0], idx[..., 1])
        return out * inside(idx[..., 0], idx[..., 1]) if padding == "zeros" else out
    floor = torch.floor(coords)
    frac = (coords - floor).to(image.dtype)
    base = floor.long()
    out = torch.zeros((n, c, *out_shape), dtype=image.dtype, device=image.device)
    for corner in range(4):
        oy, ox = corner & 1, (corner >> 1) & 1
        iy, ix = base[..., 0] + oy, base[..., 1] + ox
        wgt = (frac[..., 0] if oy else 1 - frac[..., 0]) * (frac[..., 1] if ox else
                                                           1 - frac[..., 1])
        wgt = wgt[:, None]
        if padding == "zeros":
            wgt = wgt * inside(iy, ix)
        out = out + wgt * gather(iy, ix)
    return out


def compose_flows(flow_ab: torch.Tensor, flow_bc: torch.Tensor) -> torch.Tensor:
    """Compose two backward displacement fields, channels last (N, H, W, 2):
    result(x) = flow_bc(x) + flow_ab(x + flow_bc(x)), so that warping by the
    result warps by flow_ab, then by flow_bc."""
    grid = identity_grid(flow_bc.shape[1:3], flow_bc.dtype, flow_bc.device) + flow_bc
    sampled = grid_sample(flow_ab.permute(0, 3, 1, 2), grid, mode="bilinear", padding="border")
    return flow_bc + sampled.permute(0, 2, 3, 1)


def warp_points(points: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Advect points through a dense 2D flow: points + flow sampled at the
    points (bilinear, border padding). points: (P, 2) pixel (y, x); flow:
    (H, W, 2) displacement in pixels, channels last -> (P, 2)."""
    if points.shape[-1] != 2 or flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"2D points and flow expected, got {tuple(points.shape)} and "
                         f"{tuple(flow.shape)}")
    sampled = grid_sample(flow.permute(2, 0, 1)[None], points[None, None], mode="bilinear",
                          padding="border")
    return points + sampled[0, :, 0].T


def warp_batch(images: torch.Tensor, flows: torch.Tensor,
               padding: str = "zeros") -> torch.Tensor:
    """images (N, *spatial, C), flows (N, *spatial, ndim), ndim 2 or 3 ->
    (N, *spatial, C) in the image dtype: warped(x) = image(x + flow(x))."""
    if padding not in ("border", "zeros"):
        raise ValueError(f"padding must be 'border' or 'zeros', got {padding!r}")
    nd = flows.shape[-1]
    spatial = flows.shape[1:-1]
    if nd not in (2, 3) or len(spatial) != nd or tuple(images.shape[1:-1]) != tuple(spatial):
        raise ValueError(f"images {tuple(images.shape)} and flows {tuple(flows.shape)}: "
                         "2D or 3D, one flow channel per spatial axis")
    flow = flows.float()
    axes = []
    for d, size in enumerate(spatial):  # pixel coordinates -> align_corners=True units
        shape = [1] * (nd + 1)
        shape[d + 1] = size
        pos = torch.arange(size, device=flow.device, dtype=torch.float32).view(shape)
        axes.append((pos + flow[..., d]) * (2.0 / max(size - 1, 1)) - 1.0)
    grid = torch.stack(axes[::-1], dim=-1)  # grid_sample's (x, y[, z]) order
    # grid_sample clamps a NaN coordinate to a finite one under "border" (and
    # its CPU backward then reads out of bounds): sample a stand-in there and
    # put the NaN back in the result
    finite = torch.isfinite(grid).all(-1)
    grid = torch.where(finite[..., None], grid, -2.0)
    out = F.grid_sample(images.float().movedim(-1, 1), grid, mode="bilinear",
                        padding_mode=padding, align_corners=True)
    out = torch.where(finite[:, None], out, float("nan"))
    return out.movedim(1, -1).to(images.dtype)


def warp_image(image: torch.Tensor, flow: torch.Tensor,
               padding: str = "zeros") -> torch.Tensor:
    """One image (*spatial, C) warped by flow (*spatial, ndim)."""
    return warp_batch(image[None], flow[None], padding)[0]
