"""FinalFlow: the two-encoder flow model with a pluggable temporal
bottleneck (port of ``csof_tpu/models/finalflow.py``).

A current-frame encoder over every frame and a past-state encoder over the
[frame 0, frame t] pairs (SegFlow's ``Encoder``), a ``fuse_{l}``
``ConvNormAct`` per level over [current, past], a bottleneck over the
frames chosen by ``bottleneck_type`` (``gru``: the ``ConvGRUCell`` scanned
over T from zeros, scope ``Scan_GRUStep_0``; ``3d``: two 3x3x3 convs with
tanh-GELU between them, T a spatial axis; ``transformer``: the
``SpatioTemporalTransformer``), SegFlow's ``Decoder`` (``flow_decoder``)
once a frame, optional scaling-and-squaring integration (``diffeomorphic``,
``int_steps``), frame 0's flows zeroed and the frames warped (border) by
their flows.

The JAX module takes one video ``(T, H, W, 1)``; this one takes that or a
batch ``(B, T, H, W, 1)`` and returns each output with the same leading
axes: ``flow`` (backward, t -> 0), ``flow_forward`` (its negation, or the
integral of -v), ``cum_flow`` (= ``flow``), all ``(..., T, H, W, 2)``
float32, ``registered`` ``(..., T, H, W, 1)`` and ``velocity`` (the fields
under ``diffeomorphic``, else None). Frames run T-major inside, so the
decoder's per-frame batch is contiguous.

The JAX package's two kernel switches, read from the environment unless
given, route exactly the blocks it routes: ``CSOF_CONV2D_IMPL=pallas`` runs
each ``ConvNormAct``'s conv (both encoders, the ``fuse_{l}`` convs, the
decoder's two convs a level) as kernel K6 where ``conv3x3_worthwhile``
holds (stride 1, Co < 128, an input at least 32 wide); ``CSOF_FUSED_NORM=1``
runs their InstanceNorm + LeakyReLU as kernel K5 (``norm="instance"``; the
decoder's per-frame input is 4-D in JAX too). The ConvGRU, the 3D convs,
the transposed convs and the heads never route.
:meth:`FinalFlow.kernel_launches` counts both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvNormAct, kernel_switches
from csof_tpu_torch.models.convgru import ConvGRUCell
from csof_tpu_torch.models.segflow import Decoder, Encoder, level_widths, routed_launches
from csof_tpu_torch.models.spacetime import SpatioTemporalTransformer
from csof_tpu_torch.ops.integrate import vecint_batch
from csof_tpu_torch.ops.warp import warp_batch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BOTTLENECKS = ("gru", "3d", "transformer")


@dataclass(frozen=True)
class FinalFlowConfig:
    out_encoder_dims: tuple[int, ...] = (32, 64, 128)
    bottleneck_type: Literal["gru", "3d", "transformer"] = "gru"
    bottleneck_heads: int = 4
    bottleneck_depth: int = 1
    norm: str = "group"
    diffeomorphic: bool = False
    int_steps: int = 7
    dtype: str = "bfloat16"


class GRUStep(nn.Module):
    """The JAX ``_GRUStep``: one 3x3 ``ConvGRUCell`` step."""

    def __init__(self, hidden_dim: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.ConvGRUCell_0 = ConvGRUCell(hidden_dim, hidden_dim, dtype, generator)

    def forward(self, h, x):
        return self.ConvGRUCell_0(h, x)


class FinalFlow(nn.Module):
    """Build on the CPU (parameters drawn from ``generator`` as flax
    initializes them), then ``.to(device)``. ``conv_impl`` and
    ``fused_norm_act``: the module docstring's switches (``None`` reads the
    environment)."""

    def __init__(self, cfg: FinalFlowConfig = FinalFlowConfig(),
                 generator: torch.Generator | None = None, conv_impl: str | None = None,
                 fused_norm_act: bool | None = None):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
        if cfg.bottleneck_type not in BOTTLENECKS:
            raise ValueError(f"bottleneck_type {cfg.bottleneck_type!r} is not one of "
                             f"{BOTTLENECKS}")
        conv_impl, fused_norm_act, _ = kernel_switches(2, conv_impl, fused_norm_act)
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        self.cfg = cfg
        dt = self.compute_dtype = _DTYPES[cfg.dtype]
        dims = cfg.out_encoder_dims
        d = dims[-1]
        self.current_encoder = Encoder(1, dims, cfg.norm, dt, generator, **routed)
        self.past_encoder = Encoder(2, dims, cfg.norm, dt, generator, **routed)
        for lvl, c in enumerate(dims):
            self.add_module(f"fuse_{lvl}", ConvNormAct(2 * c, c, 1, cfg.norm, dt, generator,
                                                       **routed))
        if cfg.bottleneck_type == "transformer":
            self.st_transformer = SpatioTemporalTransformer(
                d, d, cfg.bottleneck_depth, cfg.bottleneck_heads, dt, generator)
        elif cfg.bottleneck_type == "3d":
            for name in ("conv3d_1", "conv3d_2"):
                self.add_module(name, Conv(d, d, (3, 3, 3), dtype=dt, init="lecun_normal",
                                           generator=generator))
        else:
            self.Scan_GRUStep_0 = GRUStep(d, dt, generator)
        self.flow_decoder = Decoder(d, dims, 2, cfg.norm, dt, generator=generator, **routed)

    def _bottleneck(self, x, t: int, b: int):
        """x (T*B, d, hb, wb), T-major -> the same layout."""
        cfg = self.cfg
        _, d, hb, wb = x.shape
        if cfg.bottleneck_type == "transformer":
            tokens = x.view(t, b, d, hb, wb).permute(1, 0, 3, 4, 2)  # (B, T, hb, wb, d)
            y = self.st_transformer(tokens)
            return y.permute(1, 0, 4, 2, 3).reshape(t * b, d, hb, wb)
        if cfg.bottleneck_type == "3d":
            y = x.view(t, b, d, hb, wb).permute(1, 2, 0, 3, 4)  # (B, d, T, hb, wb)
            y = self.conv3d_2(F.gelu(self.conv3d_1(y), approximate="tanh"))
            return y.permute(2, 0, 1, 3, 4).reshape(t * b, d, hb, wb)
        h = torch.zeros((b, d, hb, wb), dtype=self.compute_dtype, device=x.device)
        outs = []
        for i in range(t):
            h = self.Scan_GRUStep_0(h, x[i * b:(i + 1) * b])
            outs.append(h)
        return torch.cat(outs)

    def forward(self, video: torch.Tensor) -> dict:
        """video (T, H, W, 1) or (B, T, H, W, 1) -> the output dict."""
        cfg, dt = self.cfg, self.compute_dtype
        single = video.dim() == 4
        if single:
            video = video[None]
        b, t, h, w, _ = video.shape
        frames = video.permute(1, 0, 4, 2, 3).reshape(t * b, 1, h, w)  # T-major
        cur = self.current_encoder(frames.to(dt))
        x0 = frames[:b].repeat(t, 1, 1, 1)
        past = self.past_encoder(torch.cat([x0, frames], 1).to(dt))
        fused = [getattr(self, f"fuse_{lvl}")(torch.cat([c, p], 1))
                 for lvl, (c, p) in enumerate(zip(cur, past))]
        bottleneck = self._bottleneck(fused[-1], t, b)
        fields = torch.stack([
            self.flow_decoder(bottleneck[i * b:(i + 1) * b],
                              [s[i * b:(i + 1) * b] for s in fused])[0]
            for i in range(t)], 1).permute(0, 1, 3, 4, 2)  # (B, T, H, W, 2) float32
        if cfg.diffeomorphic:
            flat = fields.reshape(b * t, h, w, 2)
            flows = vecint_batch(flat, cfg.int_steps).view(b, t, h, w, 2)
            neg_flows = vecint_batch(-flat, cfg.int_steps).view(b, t, h, w, 2)
        else:
            flows, neg_flows = fields, -fields
        mask = (torch.arange(t, device=video.device) > 0).to(flows.dtype)
        mask = mask.view(1, t, 1, 1, 1)
        flows, neg_flows = flows * mask, neg_flows * mask
        registered = warp_batch(video.reshape(b * t, h, w, 1), flows.reshape(b * t, h, w, 2),
                                padding="border").view(b, t, h, w, 1)
        out = {"flow": flows, "flow_forward": neg_flows, "cum_flow": flows,
               "registered": registered,
               "velocity": fields if cfg.diffeomorphic else None}
        if single:
            out = {k: None if v is None else v[0] for k, v in out.items()}
        return out

    def kernel_launches(self, t: int, width: int) -> dict[str, int]:
        """K5 and K6 launches of one forward of ``t`` frames ``width`` pixels
        wide (any batch: the encoders and the fuses run once over all
        frames, the decoder once a frame), counted from the modules."""
        widths = level_widths(width, len(self.cfg.out_encoder_dims))
        return routed_launches([
            *self.current_encoder.routed_blocks(width), *self.past_encoder.routed_blocks(width),
            *((getattr(self, f"fuse_{lvl}"), w, 1) for lvl, w in enumerate(widths)),
            *self.flow_decoder.routed_blocks(width, t)])
