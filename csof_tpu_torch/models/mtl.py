"""The 2D multi-task segmentation model: a conv or Swin encoder, a
transformer bottleneck, the segmentation decoder and optionally a
reconstruction decoder and a directional-field head (port of
``csof_tpu/models/mtl.py``).

Images are channels last and batched, ``(N, H, W, C)`` (or one ``(H, W,
C)`` image, as the JAX module takes), and each output keeps the input's
leading axes: ``seg_logits`` ``(..., H, W, num_classes)`` float32,
``reconstruction`` ``(..., H, W, C)`` float32 and ``directional_field``
``(..., H, W, 2)`` float32 (its 1x1 head runs in float32, as in JAX). The
conv encoder and both decoders are SegFlow's ``Encoder`` and ``Decoder``;
the bottleneck's MLP uses flax's default tanh GELU; the Swin encoder clamps
its window to the map's height at each level.

The JAX package's kernel switches route exactly the blocks it routes, read
from the environment unless given: ``CSOF_CONV2D_IMPL=pallas`` runs each
encoder and decoder ``ConvNormAct`` conv as kernel K6 where
``conv3x3_worthwhile`` holds (stride 1, Co < 128, an input at least 32
wide), its gradient K6 dx; ``CSOF_FUSED_NORM=1`` runs their InstanceNorm +
LeakyReLU as kernel K5 (``norm="instance"``). The Swin encoder, the
bottleneck and the heads never route. :meth:`MTLModel.kernel_launches`
counts both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.attention import sine_pos_embed_2d
from csof_tpu_torch.models.blocks import Conv, Dense, LayerNorm, kernel_switches
from csof_tpu_torch.models.segflow import Decoder, Encoder, routed_launches
from csof_tpu_torch.models.spacetime import MultiHeadDotProductAttention
from csof_tpu_torch.models.swin import PatchMerging, SwinStage

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MTLConfig:
    out_encoder_dims: tuple[int, ...] = (32, 64, 128)
    encoder: str = "conv"  # 'conv' | 'swin'
    swin_depths: tuple[int, ...] = (2, 2, 2)
    swin_heads: tuple[int, ...] = (2, 4, 8)
    window: int = 8
    bottleneck_layers: int = 2
    bottleneck_heads: int = 4
    dim_feedforward: int = 512
    reconstruction: bool = False
    directional_field: bool = False
    norm: str = "group"
    dtype: str = "float32"


class TransformerBottleneck(nn.Module):
    """Pre-norm self-attention layers over the flattened tokens of a map
    (N, h, w, dim), with the 2D sine embedding added. (The JAX module also
    projects a map of another width; MTL gives it its own width.)"""

    def __init__(self, dim: int, num_layers: int, num_heads: int, dim_feedforward: int,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dim, self.num_layers, self.compute_dtype = dim, num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(dim, dtype))
            self.add_module(f"MultiHeadDotProductAttention_{i}",
                            MultiHeadDotProductAttention(dim, num_heads, dtype, generator))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(dim, dtype))
            self.add_module(f"Dense_{2 * i}", Dense(dim, dim_feedforward, dtype, generator))
            self.add_module(f"Dense_{2 * i + 1}", Dense(dim_feedforward, dim, dtype, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        dt = self.compute_dtype
        tokens = x.reshape(n, h * w, c).to(dt)
        tokens = tokens + sine_pos_embed_2d(h, w, self.dim, device=x.device).to(dt)
        for i in range(self.num_layers):
            y = getattr(self, f"LayerNorm_{2 * i}")(tokens)
            tokens = tokens + getattr(self, f"MultiHeadDotProductAttention_{i}")(y)
            z = getattr(self, f"LayerNorm_{2 * i + 1}")(tokens)
            z = F.gelu(getattr(self, f"Dense_{2 * i}")(z), approximate="tanh")
            tokens = tokens + getattr(self, f"Dense_{2 * i + 1}")(z)
        return tokens.reshape(n, h, w, self.dim)


class SwinEncoder(nn.Module):
    """A Dense embedding, then per level a ``PatchMerging`` (after the
    first) and a ``SwinStage`` at ``min(window, h)``; (N, H, W, C) -> the
    per-level skips, channels last."""

    def __init__(self, in_channels: int, out_dims, depths, heads, window: int,
                 input_hw: tuple[int, int], dtype=torch.float32, generator=None):
        super().__init__()
        self.levels = len(out_dims)
        h = input_hw[0]
        prev = in_channels
        for i, (dim, depth, head) in enumerate(zip(out_dims, depths, heads)):
            if i == 0:
                self.Dense_0 = Dense(prev, dim, dtype, generator)
            else:
                self.add_module(f"PatchMerging_{i - 1}",
                                PatchMerging(prev, dim, dtype, generator))
                h //= 2
            self.add_module(f"SwinStage_{i}",
                            SwinStage(dim, depth, head, min(window, h), dtype, generator))
            prev = dim

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        skips = []
        for i in range(self.levels):
            x = self.Dense_0(x) if i == 0 else getattr(self, f"PatchMerging_{i - 1}")(x)
            x = getattr(self, f"SwinStage_{i}")(x)
            skips.append(x)
        return skips


class MTLModel(nn.Module):
    """Build on the CPU (parameters drawn from ``generator`` as flax
    initializes them), then ``.to(device)``. ``in_channels`` is the
    image's channel count (JAX reads it from the input; the reconstruction
    head has as many); ``input_hw`` the (H, W) the Swin encoder is built for
    (its windows depend on H). ``conv_impl`` / ``fused_norm_act``: the
    module docstring's switches (``None`` reads the environment)."""

    def __init__(self, cfg: MTLConfig = MTLConfig(), num_classes: int = 4,
                 in_channels: int = 1, input_hw: tuple[int, int] = (256, 224),
                 generator: torch.Generator | None = None, conv_impl: str | None = None,
                 fused_norm_act: bool | None = None):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
        if cfg.encoder not in ("conv", "swin"):
            raise ValueError(f"encoder must be 'conv' or 'swin', got {cfg.encoder!r}")
        conv_impl, fused_norm_act, _ = kernel_switches(2, conv_impl, fused_norm_act)
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        self.cfg, self.num_classes = cfg, num_classes
        dt = self.compute_dtype = _DTYPES[cfg.dtype]
        dims = cfg.out_encoder_dims
        if cfg.encoder == "swin":
            self.SwinEncoder_0 = SwinEncoder(in_channels, dims, cfg.swin_depths, cfg.swin_heads,
                                             cfg.window, input_hw, dt, generator)
        else:
            self.Encoder_0 = Encoder(in_channels, dims, cfg.norm, dt, generator, **routed)
        self.TransformerBottleneck_0 = TransformerBottleneck(
            dims[-1], cfg.bottleneck_layers, cfg.bottleneck_heads, cfg.dim_feedforward, dt,
            generator)
        self.seg_decoder = Decoder(dims[-1], dims, num_classes, cfg.norm, dt,
                                   generator=generator, **routed)
        if cfg.reconstruction:
            self.rec_decoder = Decoder(dims[-1], dims, in_channels, cfg.norm, dt,
                                       generator=generator, **routed)
        if cfg.directional_field:
            self.df_head = Conv(dims[0], 2, 1, dtype=torch.float32, init="lecun_normal",
                                generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        """x (N, H, W, C) or (H, W, C) -> the output dict."""
        cfg, dt = self.cfg, self.compute_dtype
        single = x.dim() == 3
        if single:
            x = x[None]
        if cfg.encoder == "swin":
            skips = [s.permute(0, 3, 1, 2) for s in self.SwinEncoder_0(x.to(dt))]
        else:
            skips = self.Encoder_0(x.permute(0, 3, 1, 2).to(dt))
        bott = self.TransformerBottleneck_0(skips[-1].permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        logits, feat = self.seg_decoder(bott, skips)
        out = {"seg_logits": logits.permute(0, 2, 3, 1)}
        if cfg.reconstruction:
            out["reconstruction"] = self.rec_decoder(bott, skips)[0].permute(0, 2, 3, 1)
        if cfg.directional_field:
            out["directional_field"] = self.df_head(feat.float()).permute(0, 2, 3, 1)
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    def kernel_launches(self, width: int) -> dict[str, int]:
        """K5 and K6 launches of one forward of images ``width`` pixels wide
        (any batch), counted from the modules without running them."""
        blocks = [*self.seg_decoder.routed_blocks(width)]
        if self.cfg.encoder == "conv":
            blocks += self.Encoder_0.routed_blocks(width)
        if self.cfg.reconstruction:
            blocks += self.rec_decoder.routed_blocks(width)
        return routed_launches(blocks)


class ModelWrap(nn.Module):
    """Two models on one input: ``{"model1": ..., "model2": ...}``."""

    def __init__(self, model1: nn.Module, model2: nn.Module):
        super().__init__()
        self.model1, self.model2 = model1, model2

    def forward(self, x):
        return {"model1": self.model1(x), "model2": self.model2(x)}
