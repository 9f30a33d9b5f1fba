"""Shared pieces of the plain references: the precision of their products.

The references compute in float32 with TF32 off. ``Precision`` is the one
switch they have: ``"fp32"`` leaves every operand of a product as it is;
``"fp8"`` rounds each operand of every convolution, transposed convolution,
linear layer and attention product to float8 e4m3 with one scale per tensor
(its absolute maximum onto 448, e4m3's largest finite value), then computes
in float32. That is the control of a bfloat16 configuration: the precision a
later change would be tempted to step down to.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Precision:
    """Rounds the operands of products; ``mode`` is "fp32" or "fp8"."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision mode must be fp32 or fp8, got {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32" or x.device.type == "meta":
            return x
        scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def tf32_off() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
