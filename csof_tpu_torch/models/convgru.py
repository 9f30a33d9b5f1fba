"""Convolutional GRU cells (port of ``csof_tpu/models/convgru.py``), NCHW:
``ConvGRUCell`` (SegFlow's and FinalFlow's, 3x3) and RAFT's
``SepConvGRUCell``."""

from __future__ import annotations

import torch
from torch import nn

from csof_tpu_torch.models.blocks import Conv


class ConvGRUCell(nn.Module):
    """z = sigma(Wz*[x,h]); r = sigma(Wr*[x,h]); q = tanh(Wq*[x, r.h]);
    h' = (1-z).h + z.q, with SAME convs of ``kernel_size`` (an int or a
    (kh, kw) pair; flax default lecun_normal)."""

    def __init__(self, in_channels: int, hidden_dim: int, dtype=torch.float32, generator=None,
                 kernel_size=3):
        super().__init__()
        cin = in_channels + hidden_dim
        self.Conv_0 = Conv(cin, 2 * hidden_dim, kernel_size, dtype=dtype, init="lecun_normal",
                           generator=generator)
        self.Conv_1 = Conv(cin, hidden_dim, kernel_size, dtype=dtype, init="lecun_normal",
                           generator=generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        zr = torch.sigmoid(self.Conv_0(torch.cat([x, h], 1)))
        z, r = zr.chunk(2, dim=1)
        q = torch.tanh(self.Conv_1(torch.cat([x, r * h], 1)))
        return (1 - z) * h + z * q


class SepConvGRUCell(nn.Module):
    """RAFT's separable GRU: a (1, 5) GRU, then a (5, 1) GRU, both on x."""

    def __init__(self, in_channels: int, hidden_dim: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.ConvGRUCell_0 = ConvGRUCell(in_channels, hidden_dim, dtype, generator, (1, 5))
        self.ConvGRUCell_1 = ConvGRUCell(in_channels, hidden_dim, dtype, generator, (5, 1))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.ConvGRUCell_1(self.ConvGRUCell_0(h, x), x)
