"""Diffeomorphic integration by scaling and squaring (port of
``csof_tpu/ops/integrate.py``): a stationary velocity field v becomes the
displacement flow_n, flow_0 = v / 2^n, flow_{k+1} = flow_k + warp(flow_k,
flow_k) with border padding; n = 7 by default."""

from __future__ import annotations

import torch

from csof_tpu_torch.ops.warp import warp_batch


def vecint_batch(velocity: torch.Tensor, num_steps: int = 7) -> torch.Tensor:
    """velocity (N, *spatial, ndim), channels last -> displacement, float32."""
    flow = velocity.float() / (2.0 ** num_steps)
    for _ in range(num_steps):
        flow = flow + warp_batch(flow, flow, padding="border")
    return flow


def vecint(velocity: torch.Tensor, num_steps: int = 7) -> torch.Tensor:
    """One field (*spatial, ndim) -> its displacement."""
    return vecint_batch(velocity[None], num_steps)[0]
