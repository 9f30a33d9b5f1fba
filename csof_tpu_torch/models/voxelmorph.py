"""VoxelMorph registration (port of ``csof_tpu/models/voxelmorph.py``), 2D
and 3D.

The public layouts are the JAX package's, channels last: ``moving`` and
``fixed`` ``(N, *spatial, C)`` in; ``flow`` (and with ``diffeomorphic``
``velocity`` and ``flow_inverse``) ``(N, *spatial, ndim)`` float32 and
``registered`` ``(N, *spatial, C)`` out. ``VxmUNet`` runs NC(D)HW inside:
flax ``nn.Conv`` 3^ndim convs with ``padding="SAME"`` (a stride-2 conv on
an even size pads (0, 1)), LeakyReLU 0.2, nearest x2 upsampling (the JAX
``jnp.repeat``) and skip concats; the spatial sizes must be multiples of
2^(levels - 1), as in JAX. One class for both ranks: ``ndim`` (2 or 3) sets
the kernels' rank, as the JAX module's input sets it at ``init``. Plain
convs in JAX, so the library's convs here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.config.experiment import VoxelMorphModelConfig
from csof_tpu_torch.models.blocks import Conv, leaky_relu
from csof_tpu_torch.ops.integrate import vecint_batch
from csof_tpu_torch.ops.warp import warp_batch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VxmUNet(nn.Module):
    """The flow U-Net: encoder convs (stride 2 after the first), then per
    level a conv, x2 nearest upsampling and the skip concat, then the
    remaining decoder convs (``Conv_0 .. Conv_k`` in call order, as flax
    numbers them)."""

    def __init__(self, cfg: VoxelMorphModelConfig, in_channels: int, ndim: int = 2,
                 generator=None):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.cfg, self.ndim = cfg, ndim
        dt = _DTYPES[cfg.dtype]
        k = (3,) * ndim
        convs, cin, skips = [], in_channels, []
        for i, f in enumerate(cfg.enc_features):
            convs.append((cin, f, 2 if i > 0 else 1))
            cin = f
            skips.append(f)
        n_up = len(cfg.enc_features) - 1
        for i in range(n_up):
            convs.append((cin, cfg.dec_features[i], 1))
            cin = cfg.dec_features[i] + skips[n_up - 1 - i]
        for f in cfg.dec_features[n_up:]:
            convs.append((cin, f, 1))
            cin = f
        for i, (ci, co, s) in enumerate(convs):
            self.add_module(f"Conv_{i}", Conv(ci, co, k, (s,) * ndim, padding="SAME", dtype=dt,
                                              init="lecun_normal", generator=generator))
        self.out_channels = cin

    def forward(self, x):
        """x (N, C, *spatial) -> (N, F, *spatial)."""
        if x.dim() != self.ndim + 2:
            raise ValueError(f"expected (N, C, *spatial) with {self.ndim} spatial dims, "
                             f"got {tuple(x.shape)}")
        n_enc = len(self.cfg.enc_features)
        n_up = n_enc - 1
        skips = []
        for i in range(n_enc):
            x = leaky_relu(getattr(self, f"Conv_{i}")(x), 0.2)
            skips.append(x)
        for i in range(n_up):
            x = leaky_relu(getattr(self, f"Conv_{n_enc + i}")(x), 0.2)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = torch.cat([x, skips[n_up - 1 - i]], 1)
        for j in range(len(self.cfg.dec_features) - n_up):
            x = leaky_relu(getattr(self, f"Conv_{n_enc + n_up + j}")(x), 0.2)
        return x


class VoxelMorph(nn.Module):
    """Pairwise registration (moving, fixed) -> dict (module docstring).
    ``in_channels`` is the channel count of one image."""

    def __init__(self, cfg: VoxelMorphModelConfig = VoxelMorphModelConfig(),
                 in_channels: int = 1, ndim: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
        self.cfg, self.ndim = cfg, ndim
        self.VxmUNet_0 = VxmUNet(cfg, 2 * in_channels, ndim, generator)
        # a near-zero initial field: normal(1e-5) kernel, zero bias, float32
        self.flow_head = Conv(self.VxmUNet_0.out_channels, ndim, (3,) * ndim, padding="SAME",
                              init=("normal", 1e-5), generator=generator)

    def forward(self, moving: torch.Tensor, fixed: torch.Tensor) -> dict:
        x = torch.cat([moving, fixed], -1).movedim(-1, 1)
        field = self.flow_head(self.VxmUNet_0(x).float()).movedim(1, -1)
        out = {}
        if self.cfg.diffeomorphic:
            out["velocity"] = field
            flow = vecint_batch(field, self.cfg.int_steps)
            out["flow_inverse"] = vecint_batch(-field, self.cfg.int_steps)
        else:
            flow = field
        out["flow"] = flow
        out["registered"] = warp_batch(moving, flow, padding="border")
        return out


def register_sequence(model: VoxelMorph, frames: torch.Tensor) -> dict:
    """Frames 1..T-1 of a cine registered onto frame 0 in one batched
    forward: frames (T, *spatial, C) -> the outputs of the T-1 pairs."""
    moving = frames[1:]
    return model(moving, frames[:1].expand_as(moving))
