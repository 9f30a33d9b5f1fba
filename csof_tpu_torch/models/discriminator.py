"""The patch discriminator and the GAN losses (port of
``csof_tpu/models/discriminator.py``).

Images are channels last, ``(N, H, W, C)``, as the JAX module takes them,
and NCHW inside. Each ``ConvNormAct`` is a 4x4 conv padded ((k-1)//2, k//2)
= (1, 2) per axis, the first at stride 1 and the others at stride 2, then
group norm and LeakyReLU, in ``dtype``; the last 4x4 conv to one channel
runs in float32 on the float32 input, padded as flax's ``"SAME"`` pads it at
stride 1, (1, 2). No conv of it is a stride-1 3x3 one, so it never runs K6.
The losses are the non-saturating ones on the patch logits, through
softplus.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvNormAct


class PatchDiscriminator(nn.Module):
    """PatchGAN discriminator: ``(N, H, W, C)`` -> ``(N, h', w', 1)``
    float32 patch logits."""

    def __init__(self, in_channels: int, features=(64, 128, 256), norm: str = "group",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.features = tuple(features)
        prev = in_channels
        for i, f in enumerate(self.features):
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(
                prev, f, 2 if i > 0 else 1, norm, dtype, generator, kernel_size=4))
            prev = f
        self.Conv_0 = Conv(prev, 1, 4, padding="SAME", init="lecun_normal", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.movedim(-1, 1)
        for i in range(len(self.features)):
            h = getattr(self, f"ConvNormAct_{i}")(h)
        return self.Conv_0(h.float()).movedim(1, -1)


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating discriminator loss: mean softplus(-real) + mean
    softplus(fake)."""
    return F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()


def generator_adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """The generator's side: mean softplus(-fake)."""
    return F.softplus(-fake_logits).mean()
