"""Joint segmentation of a whole cine (port of
``csof_tpu/models/temporal.py``): a per-frame conv encoder (SegFlow's
``Encoder``), the factorized time-then-space transformer over the
bottleneck (``SpatioTemporalTransformer``), a learned per-frame memory bus
read back into each frame's tokens by cross-attention, and one per-frame
decoder (SegFlow's ``Decoder``) over all frames.

Videos are channels last, ``(B, T, H, W, C)`` (or one ``(T, H, W, C)``
video, as the JAX module takes) -> logits ``(..., T, H, W, num_classes)``
float32. The bus ``memory_bus`` (video_length, d_model) is sliced to the
first T slots where T <= video_length and zero-padded to T above it, then
gets the 1D sine embedding; ``bus_read`` is flax's multi-head attention
from each frame's tokens (with the 2D sine embedding) to the T bus tokens.
JAX maps the decoder over frames with ``nn.vmap`` and one unbatched copy of
its parameters; here the frames are one batch of the same decoder (its
GroupNorm is per sample, so the math is the same).

The JAX package's kernel switches route the encoder's and the decoder's
``ConvNormAct`` blocks as in ``MTLModel``: ``CSOF_CONV2D_IMPL=pallas`` (K6,
dx) and ``CSOF_FUSED_NORM=1`` with ``norm="instance"`` (K5; the vmapped
decoder's per-frame input is 4-D in JAX too).
:meth:`TemporalVideoSegModel.kernel_launches` counts both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.attention import sine_pos_embed_2d
from csof_tpu_torch.models.blocks import kernel_switches
from csof_tpu_torch.models.segflow import Decoder, Encoder, routed_launches
from csof_tpu_torch.models.spacetime import (
    MultiHeadDotProductAttention,
    SpatioTemporalTransformer,
    sine_pos_embed_1d,
)


class TemporalVideoSegModel(nn.Module):
    """Build on the CPU (parameters drawn from ``generator`` as flax
    initializes them), then ``.to(device)``. ``conv_impl`` /
    ``fused_norm_act``: the module docstring's switches (``None`` reads the
    environment)."""

    def __init__(self, out_encoder_dims=(16, 32, 64), d_model: int = 64, num_classes: int = 4,
                 num_heads: int = 4, depth: int = 1, video_length: int = 8, norm: str = "group",
                 dtype=torch.float32, in_channels: int = 1,
                 generator: torch.Generator | None = None, conv_impl: str | None = None,
                 fused_norm_act: bool | None = None):
        super().__init__()
        conv_impl, fused_norm_act, _ = kernel_switches(2, conv_impl, fused_norm_act)
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        self.dims, self.d_model, self.video_length = tuple(out_encoder_dims), d_model, video_length
        self.compute_dtype = dtype
        self.encoder = Encoder(in_channels, self.dims, norm, dtype, generator, **routed)
        self.bottleneck = SpatioTemporalTransformer(self.dims[-1], d_model, depth, num_heads,
                                                    dtype, generator)
        self.memory_bus = nn.Parameter(torch.empty(video_length, d_model))
        with torch.no_grad():
            self.memory_bus.normal_(0.0, 0.02, generator=generator)
        self.bus_read = MultiHeadDotProductAttention(d_model, num_heads, dtype, generator)
        self.decoder = Decoder(d_model, self.dims, num_classes, norm, dtype,
                               generator=generator, **routed)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, T, H, W, C) or (T, H, W, C) -> logits, channels last."""
        dt = self.compute_dtype
        single = video.dim() == 4
        if single:
            video = video[None]
        b, t, h, w, c = video.shape
        frames = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2).to(dt)
        skips = self.encoder(frames)
        _, ce, hb, wb = skips[-1].shape
        x = self.bottleneck(skips[-1].permute(0, 2, 3, 1).reshape(b, t, hb, wb, ce))
        d = self.d_model
        bus = self.memory_bus.to(dt)
        bus = bus[:t] if t <= self.video_length else F.pad(bus, (0, 0, 0, t - self.video_length))
        bus = bus + sine_pos_embed_1d(t, d, device=video.device).to(dt)
        tokens = x.reshape(b, t, hb * wb, d)
        tokens = tokens + sine_pos_embed_2d(hb, wb, d, device=video.device).to(dt)
        read = self.bus_read(tokens, bus.expand(b, t, t, d))
        x = (tokens + read).reshape(b * t, hb, wb, d).permute(0, 3, 1, 2)
        logits, _ = self.decoder(x, skips)
        logits = logits.permute(0, 2, 3, 1).reshape(b, t, h, w, -1)
        return logits[0] if single else logits

    def kernel_launches(self, width: int) -> dict[str, int]:
        """K5 and K6 launches of one forward of frames ``width`` pixels wide
        (any batch and frame count: the encoder and the decoder each run
        once over all frames), counted from the modules."""
        return routed_launches([*self.encoder.routed_blocks(width),
                                *self.decoder.routed_blocks(width)])
