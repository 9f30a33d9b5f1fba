"""RAFT optical flow (port of ``csof_tpu/models/raft.py``), NCHW inside.

Batched over pairs, where the JAX package takes one pair and its trainer
``vmap``s: images ``(N, H, W, C)`` channels last in (H and W multiples of
8), every iteration's full-resolution flow ``(iters, N, H, W, 2)`` out, in
the JAX package's order (the trainer's ``swapaxes`` of its ``vmap``).
InstanceNorm is per sample, so the two are the same math.

Convs are flax ``nn.Conv`` with ``padding="SAME"`` (asymmetric at stride 2:
the stem pads (2, 3), a stride-2 3x3 (0, 1), the 1x1 shortcut nothing) in
``cfg.dtype``; InstanceNorm takes its bfloat16 path there. The
correlation volume and its pyramid are float32 from the feature maps cast
to float32, ``dflow`` and ``mask`` come back float32 and the flow
accumulates in float32. The refinement loop is a Python loop of the one
shared update step (the JAX ``nn.scan`` with broadcast parameters, scope
``Scan_RaftUpdateStep_0``): ``scan_unroll`` is a program form and changes
nothing here, -1 included (ROADMAP fault F4: ``lax.scan`` refuses -1).
Plain convs in JAX, so the library's convs here: RAFT runs no kernel of
the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.config.experiment import RaftModelConfig
from csof_tpu_torch.models.blocks import Conv, InstanceNorm
from csof_tpu_torch.models.convgru import SepConvGRUCell
from csof_tpu_torch.ops.correlation import (
    all_pairs_correlation,
    correlation_pyramid,
    lookup_correlation,
)
from csof_tpu_torch.ops.warp import identity_grid

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _conv(cin, cout, k, stride=1, dtype=torch.float32, generator=None):
    """flax ``nn.Conv(cout, (k, k), strides, padding="SAME")``: lecun_normal."""
    return Conv(cin, cout, k, stride, padding="SAME", dtype=dtype, init="lecun_normal",
                generator=generator)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels, features, stride=1, dtype=torch.float32, generator=None):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, 3, stride, dtype, generator)
        self.InstanceNorm_0 = InstanceNorm(features)
        self.Conv_1 = _conv(features, features, 3, 1, dtype, generator)
        self.InstanceNorm_1 = InstanceNorm(features)
        self.shortcut = stride != 1 or in_channels != features
        if self.shortcut:
            self.Conv_2 = _conv(in_channels, features, 1, stride, dtype, generator)
            self.InstanceNorm_2 = InstanceNorm(features)

    def forward(self, x):
        y = torch.relu(self.InstanceNorm_0(self.Conv_0(x)))
        y = self.InstanceNorm_1(self.Conv_1(y))
        if self.shortcut:
            x = self.InstanceNorm_2(self.Conv_2(x))
        return torch.relu(x + y)


class FeatureEncoder(nn.Module):
    """1/8-resolution feature extractor (RAFT 'large' shape)."""

    def __init__(self, in_channels, out_dim=256, dtype=torch.float32, generator=None):
        super().__init__()
        self.Conv_0 = _conv(in_channels, 64, 7, 2, dtype, generator)
        self.InstanceNorm_0 = InstanceNorm(64)
        cin = 64
        for i, (feats, stride) in enumerate(((64, 1), (64, 1), (96, 2), (96, 1), (128, 2),
                                             (128, 1))):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(cin, feats, stride, dtype, generator))
            cin = feats
        self.Conv_1 = _conv(cin, out_dim, 1, 1, dtype, generator)

    def forward(self, x):
        x = torch.relu(self.InstanceNorm_0(self.Conv_0(x)))
        for i in range(6):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return self.Conv_1(x)


class MotionEncoder(nn.Module):
    """Encode (correlation lookup, current flow) into 128 motion channels."""

    def __init__(self, corr_channels, dtype=torch.float32, generator=None):
        super().__init__()
        self.Conv_0 = _conv(corr_channels, 256, 1, 1, dtype, generator)
        self.Conv_1 = _conv(256, 192, 3, 1, dtype, generator)
        self.Conv_2 = _conv(2, 128, 7, 1, dtype, generator)
        self.Conv_3 = _conv(128, 64, 3, 1, dtype, generator)
        self.Conv_4 = _conv(192 + 64, 126, 3, 1, dtype, generator)

    def forward(self, corr, flow):
        c = torch.relu(self.Conv_1(torch.relu(self.Conv_0(corr))))
        f = torch.relu(self.Conv_3(torch.relu(self.Conv_2(flow))))
        m = torch.relu(self.Conv_4(torch.cat([c, f], 1)))
        return torch.cat([m, flow], 1)


class UpdateBlock(nn.Module):
    def __init__(self, corr_channels, context_dim, hidden_dim=128, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.MotionEncoder_0 = MotionEncoder(corr_channels, dtype, generator)
        self.SepConvGRUCell_0 = SepConvGRUCell(context_dim + 128, hidden_dim, dtype, generator)
        self.Conv_0 = _conv(hidden_dim, 256, 3, 1, dtype, generator)
        self.Conv_1 = _conv(256, 2, 3, 1, dtype, generator)
        self.Conv_2 = _conv(hidden_dim, 256, 3, 1, dtype, generator)
        self.Conv_3 = _conv(256, 64 * 9, 1, 1, dtype, generator)

    def forward(self, hidden, context, corr, flow):
        motion = self.MotionEncoder_0(corr, flow)
        hidden = self.SepConvGRUCell_0(hidden, torch.cat([context, motion], 1))
        dflow = self.Conv_1(torch.relu(self.Conv_0(hidden)))
        mask = self.Conv_3(torch.relu(self.Conv_2(hidden))) * 0.25
        return hidden, dflow.float(), mask.float()


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(N, 2, h, w) flow -> (N, h*8, w*8, 2): each fine pixel a convex
    combination (softmax of the mask) of the 3x3 coarse neighbourhood of the
    flow scaled by 8, zero-padded. The JAX layout: mask channel k*64 + u*8 +
    v for neighbour k = dy*3 + dx and fine offset (u, v); output row h*8 + u,
    column w*8 + v."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 9, factor, factor, h, w), dim=1)
    fpad = F.pad(flow * factor, (1, 1, 1, 1))
    neigh = torch.stack([fpad[:, :, dy:dy + h, dx:dx + w] for dy in range(3)
                         for dx in range(3)], 1)  # (N, 9, 2, h, w)
    up = torch.einsum("nkuvhw,nkchw->nhuwvc", m, neigh)
    return up.reshape(n, h * factor, w * factor, 2)


class RaftUpdateStep(nn.Module):
    """One refinement iteration (the JAX ``_RaftUpdateStep``)."""

    def __init__(self, cfg: RaftModelConfig, dtype, generator=None):
        super().__init__()
        self.corr_radius = cfg.corr_radius
        self.compute_dtype = dtype
        corr_channels = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.UpdateBlock_0 = UpdateBlock(corr_channels, cfg.context_dim, cfg.hidden_dim, dtype,
                                         generator)

    def forward(self, hidden, flow, pyramid, context, coords0):
        """flow (N, 2, h, w) float32, coords0 (h, w, 2) -> (hidden, flow, up)."""
        dt = self.compute_dtype
        coords = coords0 + flow.permute(0, 2, 3, 1)
        corr = lookup_correlation(pyramid, coords, self.corr_radius)
        hidden, dflow, mask = self.UpdateBlock_0(hidden, context, corr.to(dt), flow.to(dt))
        flow = flow + dflow
        return hidden, flow, convex_upsample(flow, mask)


class RAFT(nn.Module):
    """RAFT over a batch of pairs. Build on the CPU (parameters drawn from
    ``generator`` as flax initializes them), then ``.to(device)``."""

    def __init__(self, cfg: RaftModelConfig = RaftModelConfig(), in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
        self.cfg = cfg
        dt = self.compute_dtype = _DTYPES[cfg.dtype]
        self.FeatureEncoder_0 = FeatureEncoder(in_channels, cfg.feature_dim, dt, generator)
        self.FeatureEncoder_1 = FeatureEncoder(in_channels, cfg.feature_dim, dt, generator)
        self.context_encoder = FeatureEncoder(in_channels, cfg.hidden_dim + cfg.context_dim, dt,
                                              generator)
        self.Scan_RaftUpdateStep_0 = RaftUpdateStep(cfg, dt, generator)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int | None = None) -> torch.Tensor:
        """image1, image2 (N, H, W, C) -> flows (iters, N, H, W, 2) float32."""
        cfg = self.cfg
        iters = iters or cfg.iters
        if image1.shape[1] % 8 or image1.shape[2] % 8:
            raise ValueError(f"RAFT needs H and W divisible by 8, got {tuple(image1.shape)}")
        x1 = image1.movedim(-1, 1)
        fmap1 = self.FeatureEncoder_0(x1)
        fmap2 = self.FeatureEncoder_1(image2.movedim(-1, 1))
        ctx = self.context_encoder(x1)
        hidden = torch.tanh(ctx[:, :cfg.hidden_dim])
        context = torch.relu(ctx[:, cfg.hidden_dim:])
        pyramid = correlation_pyramid(all_pairs_correlation(fmap1.float(), fmap2.float()),
                                      cfg.corr_levels)
        n, _, h8, w8 = fmap1.shape
        coords0 = identity_grid((h8, w8), device=fmap1.device)
        flow = torch.zeros((n, 2, h8, w8), dtype=torch.float32, device=fmap1.device)
        step = self.Scan_RaftUpdateStep_0
        ups = []
        for _ in range(iters):
            hidden, flow, up = step(hidden, flow, pyramid, context, coords0)
            ups.append(up)
        return torch.stack(ups)
