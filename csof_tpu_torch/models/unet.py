"""The plans-driven U-Net of nnU-Net, 2D (NCHW) and 3D (NCDHW) (port of
``csof_tpu/models/unet.py`` ``GenericUNet`` / ``unet_from_plans``).

Strided-conv pooling, transposed-conv upsampling, InstanceNorm + LeakyReLU
0.01, a bias-free 1x1 deep-supervision head at every decoder level, features
doubled per level and capped at 480 (2D) or 320 (3D). Submodules carry the
flax scope names (``StackedConvs_0`` .. ``StackedConvs_{2 * num_pool}`` in
call order: encoder, bottleneck, decoder; ``ConvTranspose_{u}``;
``seg_head_{level}``), so
:func:`csof_tpu_torch.compat.flax_import.load_flax_params` fills it from a
flax tree. Deep supervision returns the heads full resolution first, in
float32. ``remat`` recomputes activations in the backward pass as JAX's
``nn.remat`` does, with ``torch.utils.checkpoint``: policy ``full``
recomputes a whole conv stack, ``save_conv`` only each norm + activation
from its saved conv output; the parameters are the same either way.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.models.blocks import Conv, ConvTranspose, StackedConvs, kernel_switches

MAX_FILTERS_2D = 480
MAX_FILTERS_3D = 320
REMAT_POLICIES = ("full", "save_conv")


class GenericUNet(nn.Module):
    """x ``(N, in_channels, *spatial)`` -> logits ``(N, num_classes,
    *spatial)``, or the tuple of deep-supervision logits; 2-D or 3-D by the
    kernels' length. ``fused_norm_act`` and ``conv_impl`` select kernels K5
    and K6 (see ``ConvNormAct``); ``remat`` / ``remat_levels`` /
    ``remat_policy`` as the JAX module's (levels below ``remat_levels``,
    all if None)."""

    def __init__(self, num_classes: int, in_channels: int = 1, base_num_features: int = 32,
                 pool_kernel_sizes: Sequence[Sequence[int]] = ((2, 2),) * 5,
                 conv_kernel_sizes: Sequence[Sequence[int]] = ((3, 3),) * 6,
                 conv_per_stage: int = 2, max_features: int | None = None,
                 norm: str = "instance", deep_supervision: bool = True,
                 dtype: torch.dtype = torch.float32, fused_norm_act: bool = False,
                 conv_impl: str = "native", remat: bool = False, remat_levels: int | None = None,
                 remat_policy: str = "full", generator: torch.Generator | None = None):
        super().__init__()
        ndim = len(conv_kernel_sizes[0])
        if ndim not in (2, 3) or any(len(k) != ndim
                                     for k in (*pool_kernel_sizes, *conv_kernel_sizes)):
            raise ValueError("kernels and pools must all be 2-D or all 3-D")
        if len(conv_kernel_sizes) != len(pool_kernel_sizes) + 1:
            raise ValueError("conv_kernel_sizes needs one entry per level (num_pool + 1)")
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of {REMAT_POLICIES}")
        self.num_pool = num_pool = len(pool_kernel_sizes)
        self.pool_kernel_sizes = [tuple(p) for p in pool_kernel_sizes]
        self.conv_kernel_sizes = [tuple(k) for k in conv_kernel_sizes]
        self.base_num_features = base_num_features
        self.max_features = max_features
        self.deep_supervision = deep_supervision
        self.remat, self.remat_levels, self.remat_policy = remat, remat_levels, remat_policy
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
                feats[level], num_classes, (1,) * ndim, bias=False, dtype=dtype,
                init="lecun_normal", generator=generator))
        if remat and remat_policy == "save_conv":
            for name, level in self._stages():
                if self._remat_at(level):
                    for block in getattr(self, name).children():
                        block.remat_norm_act = True

    def features_at(self, level: int) -> int:
        cap = self.max_features or (MAX_FILTERS_3D if len(self.conv_kernel_sizes[0]) == 3
                                    else MAX_FILTERS_2D)
        return min(self.base_num_features * (2 ** level), cap)

    def _stages(self) -> list[tuple[str, int]]:
        """(StackedConvs name, resolution level) in call order."""
        n = self.num_pool
        return ([(f"StackedConvs_{d}", d) for d in range(n + 1)]
                + [(f"StackedConvs_{n + 1 + u}", n - 1 - u) for u in range(n)])

    def _remat_at(self, level: int) -> bool:
        return self.remat and (self.remat_levels is None or level < self.remat_levels)

    def _stack(self, name: str, level: int, x):
        stack = getattr(self, name)
        if self.remat_policy == "full" and self._remat_at(level) and torch.is_grad_enabled():
            return checkpoint(stack, x, use_reentrant=False)
        return stack(x)

    def forward(self, x):
        n = self.num_pool
        skips = []
        for d in range(n):
            x = self._stack(f"StackedConvs_{d}", d, x)
            skips.append(x)
        x = self._stack(f"StackedConvs_{n}", n, x)
        seg_outputs = []
        for u in range(n):
            level = n - 1 - u
            x = getattr(self, f"ConvTranspose_{u}")(x)
            x = torch.cat([x, skips[level]], 1)
            x = self._stack(f"StackedConvs_{n + 1 + u}", level, x)
            seg_outputs.append(getattr(self, f"seg_head_{level}")(x).float())
        seg_outputs = seg_outputs[::-1]  # full resolution first
        return tuple(seg_outputs) if self.deep_supervision else seg_outputs[0]

    def kernel_launches(self, patch_size: Sequence[int],
                        backward: bool = False) -> dict[str, int]:
        """K5, K6 and K7 launches of one forward of an input of spatial shape
        ``patch_size`` ((H, W), or (D, H, W) for a 3D net), counted from the
        modules without running them: a routed 2D conv launches K6 once, a
        routed 3D conv once per z tap; a block whose norm and activation run
        as K7 (``ConvNormAct.uses_k7`` at its output's H x W plane on the
        model's device) launches K7 once. With ``backward``, also ``K6_dx``,
        ``K6_dw`` and ``K7_dx``: one dx for each K6 launch whose input needs
        a gradient (every one but a first conv on the data), one dw call for
        each K6 launch (every weight has a gradient), one K7 dx for each
        block on K7; under ``remat`` the backward runs the norm and
        activation again (policy ``full`` the remat levels' convs too),
        which counts in ``K7`` (and ``K6``)."""
        if len(patch_size) != len(self.conv_kernel_sizes[0]):
            raise ValueError(f"patch_size {tuple(patch_size)} is not "
                             f"{len(self.conv_kernel_sizes[0])}-D")
        n = self.num_pool
        widths, heights = [patch_size[-1]], [patch_size[-2]]  # per level
        for d in range(1, n + 1):  # level d's first conv has stride pool[d-1]
            widths.append((widths[-1] - 1) // self.pool_kernel_sizes[d - 1][-1] + 1)
            heights.append((heights[-1] - 1) // self.pool_kernel_sizes[d - 1][-2] + 1)
        device = next(self.parameters()).device
        k5 = k6 = dx = dw = k7 = k7_dx = 0
        for name, level in self._stages():
            stack = getattr(self, name)
            w_in = widths[max(level - 1, 0)] if name == f"StackedConvs_{level}" else widths[level]
            again = backward and self.remat_policy == "full" and self._remat_at(level)
            for i, block in enumerate(stack.children()):
                k5 += block.fused_norm_act
                taps = block.uses_k6(w_in if i == 0 else widths[level]) * (
                    block.Conv_0.kernel_size[0] if len(block.Conv_0.kernel_size) == 3 else 1)
                k6 += taps * (2 if again else 1)
                dx += taps * ((name, i) != ("StackedConvs_0", 0))
                dw += taps
                native = block.uses_k7(widths[level] * heights[level], device,
                                       block.Conv_0.compute_dtype)
                k7 += native * (2 if backward and self._remat_at(level) else 1)
                k7_dx += native
        counts = {"K5": k5, "K6": k6, "K7": k7}
        return {**counts, "K6_dx": dx, "K6_dw": dw, "K7_dx": k7_dx} if backward else counts


def unet_from_plans(plans: Plans, stage: int | None = None, deep_supervision: bool = True,
                    dtype: torch.dtype = torch.float32, fused_norm_act: bool | None = None,
                    conv_impl: str | None = None, remat: bool | None = None,
                    remat_policy: str | None = None, in_channels: int | None = None,
                    generator: torch.Generator | None = None) -> GenericUNet:
    """Build the network the plans prescribe (the fullres stage unless
    ``stage`` is given). ``fused_norm_act``, ``conv_impl`` and
    ``remat_policy`` default to the JAX package's switches, read the same
    way (:func:`~csof_tpu_torch.models.blocks.kernel_switches`), so one
    setting selects the same path in both packages. ``remat`` defaults to on
    for 3-D plans, where the policy defaults to ``save_conv`` (else
    ``full``), as in JAX. ``in_channels`` overrides the plans' modality
    count (the cascade's fullres stage takes the previous stage's one-hot
    channels beside them)."""
    sp = plans.stage(stage) if stage is not None else plans.fullres_stage()
    ndim = len(sp.conv_kernel_sizes[0])
    if remat is None:
        remat = ndim == 3
    conv_impl, fused_norm_act, remat_policy = kernel_switches(ndim, conv_impl, fused_norm_act,
                                                              remat_policy, remat)
    return GenericUNet(
        num_classes=plans.num_classes_with_background,
        in_channels=plans.num_modalities if in_channels is None else in_channels,
        base_num_features=plans.base_num_features,
        pool_kernel_sizes=[tuple(p) for p in sp.pool_op_kernel_sizes],
        conv_kernel_sizes=[tuple(k) for k in sp.conv_kernel_sizes],
        conv_per_stage=plans.conv_per_stage, deep_supervision=deep_supervision, dtype=dtype,
        fused_norm_act=fused_norm_act, conv_impl=conv_impl, remat=remat,
        remat_policy=remat_policy, generator=generator)
