"""Jacobian determinant of displacement fields (port of
``csof_tpu/ops/jacobian.py``).

phi = disp + the identity grid; its derivatives along each axis are
``jnp.gradient``'s: central differences (f[i+1] - f[i-1]) * 0.5 inside,
one-sided at the edges; then the 2D or 3D determinant. The batched form
takes any leading axes, so a whole (depth x time) stack of fields is one
call on the device the tensor lies on.
"""

from __future__ import annotations

import torch

from csof_tpu_torch.ops.warp import identity_grid


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient(a, axis=dim)`` at unit spacing (a needs >= 2 samples)."""
    n = a.shape[dim]
    upper = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    lower = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([upper, inner, lower], dim)


def jacobian_determinant_batch(disp: torch.Tensor, ndim: int | None = None) -> torch.Tensor:
    """disp: (..., *vol_shape, ndim) displacement -> (..., *vol_shape) det J,
    the volume the trailing ``ndim`` axes before the last (default: the
    size of the last axis, 2 or 3)."""
    ndim = disp.shape[-1] if ndim is None else ndim
    if ndim not in (2, 3) or disp.shape[-1] != ndim:
        raise ValueError(f"flow must be 2D or 3D with one channel per axis, got {tuple(disp.shape)}")
    volshape = disp.shape[-ndim - 1:-1]
    phi = disp + identity_grid(volshape, disp.dtype, disp.device)
    grads = [_gradient(phi, disp.ndim - 1 - ndim + d) for d in range(ndim)]
    if ndim == 3:
        dx, dy, dz = grads
        return (dx[..., 0] * (dy[..., 1] * dz[..., 2] - dy[..., 2] * dz[..., 1])
                - dx[..., 1] * (dy[..., 0] * dz[..., 2] - dy[..., 2] * dz[..., 0])
                + dx[..., 2] * (dy[..., 0] * dz[..., 1] - dy[..., 1] * dz[..., 0]))
    dfdx, dfdy = grads
    return dfdx[..., 0] * dfdy[..., 1] - dfdy[..., 0] * dfdx[..., 1]


def jacobian_determinant(disp: torch.Tensor) -> torch.Tensor:
    """disp: (*vol_shape, ndim), ndim = len(vol_shape) in (2, 3) -> (*vol_shape,) det J."""
    if disp.ndim - 1 != disp.shape[-1]:
        raise ValueError(f"flow must be (*vol_shape, ndim), got {tuple(disp.shape)}")
    return jacobian_determinant_batch(disp)


def jacobian_stats(disp: torch.Tensor, mask: torch.Tensor | None = None) -> dict:
    """|mean(J) - 1| and the percentage of negative J, within ``mask`` if
    given; 0-dim tensors on ``disp``'s device."""
    det = jacobian_determinant(disp)
    m = torch.ones_like(det) if mask is None else mask.to(det.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mean_j = torch.sum(det * m) / n
    pct_neg = 100.0 * torch.sum((det < 0).to(det.dtype) * m) / n
    return {"abs_mean_j_minus_1": torch.abs(mean_j - 1.0), "pct_negative_j": pct_neg}
