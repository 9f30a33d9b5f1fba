"""Convolutional GRU cell (port of ``csof_tpu/models/convgru.py``), NCHW."""

from __future__ import annotations

import torch
from torch import nn

from csof_tpu_torch.models.blocks import Conv


class ConvGRUCell(nn.Module):
    """z = sigma(Wz*[x,h]); r = sigma(Wr*[x,h]); q = tanh(Wq*[x, r.h]);
    h' = (1-z).h + z.q, with 3x3 SAME convs (flax default lecun_normal)."""

    def __init__(self, in_channels: int, hidden_dim: int, dtype=torch.float32, generator=None):
        super().__init__()
        cin = in_channels + hidden_dim
        self.Conv_0 = Conv(cin, 2 * hidden_dim, 3, dtype=dtype, init="lecun_normal",
                           generator=generator)
        self.Conv_1 = Conv(cin, hidden_dim, 3, dtype=dtype, init="lecun_normal",
                           generator=generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        zr = torch.sigmoid(self.Conv_0(torch.cat([x, h], 1)))
        z, r = zr.chunk(2, dim=1)
        q = torch.tanh(self.Conv_1(torch.cat([x, r * h], 1)))
        return (1 - z) * h + z * q
