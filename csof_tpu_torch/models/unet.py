"""The plans-driven 2D U-Net of nnU-Net, NCHW (port of
``csof_tpu/models/unet.py`` ``GenericUNet`` / ``unet_from_plans``).

Strided-conv pooling, transposed-conv upsampling, InstanceNorm + LeakyReLU
0.01, a bias-free 1x1 deep-supervision head at every decoder level, features
doubled per level and capped at 480. Submodules carry the flax scope names
(``StackedConvs_0`` .. ``StackedConvs_{2 * num_pool}`` in call order:
encoder, bottleneck, decoder; ``ConvTranspose_{u}``; ``seg_head_{level}``),
so :func:`csof_tpu_torch.compat.flax_import.load_flax_params` fills it from a
flax tree. Deep supervision returns the heads full resolution first, in
float32. 3D plans are not ported.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.models.blocks import Conv, ConvTranspose, StackedConvs

MAX_FILTERS_2D = 480
MAX_FILTERS_3D = 320


class GenericUNet(nn.Module):
    """x ``(N, in_channels, H, W)`` -> logits ``(N, num_classes, H, W)``, or
    the tuple of deep-supervision logits. ``fused_norm_act`` and
    ``conv_impl`` select kernels K5 and K6 (see ``ConvNormAct``)."""

    def __init__(self, num_classes: int, in_channels: int = 1, base_num_features: int = 32,
                 pool_kernel_sizes: Sequence[Sequence[int]] = ((2, 2),) * 5,
                 conv_kernel_sizes: Sequence[Sequence[int]] = ((3, 3),) * 6,
                 conv_per_stage: int = 2, max_features: int | None = None,
                 norm: str = "instance", deep_supervision: bool = True,
                 dtype: torch.dtype = torch.float32, fused_norm_act: bool = False,
                 conv_impl: str = "native", generator: torch.Generator | None = None):
        super().__init__()
        if any(len(k) != 2 for k in (*pool_kernel_sizes, *conv_kernel_sizes)):
            raise ValueError("only the 2D U-Net is ported: kernels and pools must be 2D")
        if len(conv_kernel_sizes) != len(pool_kernel_sizes) + 1:
            raise ValueError("conv_kernel_sizes needs one entry per level (num_pool + 1)")
        self.num_pool = num_pool = len(pool_kernel_sizes)
        self.pool_kernel_sizes = [tuple(p) for p in pool_kernel_sizes]
        self.conv_kernel_sizes = [tuple(k) for k in conv_kernel_sizes]
        self.base_num_features = base_num_features
        self.max_features = max_features
        self.deep_supervision = deep_supervision
        stack = dict(norm=norm, dtype=dtype, generator=generator,
                     fused_norm_act=fused_norm_act, conv_impl=conv_impl)
        feats = [self.features_at(level) for level in range(num_pool + 1)]
        for d in range(num_pool + 1):  # encoder levels, then the bottleneck
            self.add_module(f"StackedConvs_{d}", StackedConvs(
                in_channels if d == 0 else feats[d - 1], feats[d], conv_per_stage,
                self.conv_kernel_sizes[d],
                first_stride=None if d == 0 else self.pool_kernel_sizes[d - 1], **stack))
        for u in range(num_pool):
            level = num_pool - 1 - u
            self.add_module(f"ConvTranspose_{u}", ConvTranspose(
                feats[level + 1], feats[level], self.pool_kernel_sizes[level], dtype, generator,
                init="he_normal"))
            self.add_module(f"StackedConvs_{num_pool + 1 + u}", StackedConvs(
                2 * feats[level], feats[level], conv_per_stage, self.conv_kernel_sizes[level + 1],
                **stack))
            self.add_module(f"seg_head_{level}", Conv(
                feats[level], num_classes, 1, bias=False, dtype=dtype, init="lecun_normal",
                generator=generator))

    def features_at(self, level: int) -> int:
        return min(self.base_num_features * (2 ** level), self.max_features or MAX_FILTERS_2D)

    def forward(self, x):
        n = self.num_pool
        skips = []
        for d in range(n):
            x = getattr(self, f"StackedConvs_{d}")(x)
            skips.append(x)
        x = getattr(self, f"StackedConvs_{n}")(x)
        seg_outputs = []
        for u in range(n):
            level = n - 1 - u
            x = getattr(self, f"ConvTranspose_{u}")(x)
            x = torch.cat([x, skips[level]], 1)
            x = getattr(self, f"StackedConvs_{n + 1 + u}")(x)
            seg_outputs.append(getattr(self, f"seg_head_{level}")(x).float())
        seg_outputs = seg_outputs[::-1]  # full resolution first
        return tuple(seg_outputs) if self.deep_supervision else seg_outputs[0]

    def kernel_launches(self, width: int) -> dict[str, int]:
        """K5 and K6 launches of one forward of an input ``width`` pixels
        wide, counted from the modules without running them."""
        n = self.num_pool
        widths = [width]  # per level; level d's first conv has stride pool[d-1]
        for d in range(1, n + 1):
            widths.append((widths[-1] - 1) // self.pool_kernel_sizes[d - 1][1] + 1)
        stages = [(f"StackedConvs_{d}", widths[max(d - 1, 0)], widths[d]) for d in range(n + 1)]
        stages += [(f"StackedConvs_{n + 1 + u}", widths[n - 1 - u], widths[n - 1 - u])
                   for u in range(n)]
        k5 = k6 = 0
        for name, w_in, w_out in stages:
            for i, block in enumerate(getattr(self, name).children()):
                k5 += block.fused_norm_act
                k6 += block.uses_k6(w_in if i == 0 else w_out)
        return {"K5": k5, "K6": k6}


def unet_from_plans(plans: Plans, stage: int | None = None, deep_supervision: bool = True,
                    dtype: torch.dtype = torch.float32, fused_norm_act: bool | None = None,
                    conv_impl: str | None = None,
                    generator: torch.Generator | None = None) -> GenericUNet:
    """Build the network the plans prescribe (the fullres stage unless
    ``stage`` is given). ``fused_norm_act`` and ``conv_impl`` default to the
    JAX package's switches, read the same way: ``CSOF_FUSED_NORM=1`` and
    ``CSOF_CONV2D_IMPL`` (default ``native``), so one setting selects the same
    path in both packages."""
    sp = plans.stage(stage) if stage is not None else plans.fullres_stage()
    if fused_norm_act is None:
        fused_norm_act = os.environ.get("CSOF_FUSED_NORM", "0") == "1"
    if conv_impl is None:
        conv_impl = os.environ.get("CSOF_CONV2D_IMPL", "native")
    return GenericUNet(
        num_classes=plans.num_classes_with_background, in_channels=plans.num_modalities,
        base_num_features=plans.base_num_features,
        pool_kernel_sizes=[tuple(p) for p in sp.pool_op_kernel_sizes],
        conv_kernel_sizes=[tuple(k) for k in sp.conv_kernel_sizes],
        conv_per_stage=plans.conv_per_stage, deep_supervision=deep_supervision, dtype=dtype,
        fused_norm_act=fused_norm_act, conv_impl=conv_impl, generator=generator)
