"""Denoising diffusion, DDPM (port of ``csof_tpu/models/diffusion.py``): the
cosine noise schedule, the epsilon-prediction U-Net with a sinusoidal time
embedding and an optional conditioning input, and the forward sampling, the
training loss and ancestral sampling.

Images are channels last, ``(N, H, W, C)``, NCHW inside; timesteps are
integers ``(N,)``. The schedule's tables are float32, computed on the host
(the cumulative product in order, in float32) and moved to the device of
use, and so are the time embedding's frequencies: the card and the CPU use
the same numbers. Every function that draws takes an explicit
``torch.Generator`` on the device of the draw, or the draws themselves
(``t``, ``noise``, the chain's first ``x`` and its per-step ``noises``, unit
normals), so that a caller can replay another implementation's draws.

The U-Net's 3x3 ``ConvNormAct`` convs run kernel K6 under
``conv_impl="pallas"`` (``CSOF_CONV2D_IMPL=pallas``) where the JAX package
runs its Pallas conv (stride 1, Co < 128, an input at least 32 wide), their
gradient K6 dx; :meth:`DenoiserUNet.kernel_launches` counts them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvNormAct, Dense, upsample_linear, kernel_switches
from csof_tpu_torch.models.segflow import routed_counts


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """float32 betas of the cosine schedule, clipped to [0, 0.999]."""
    t = np.linspace(0, timesteps, timesteps + 1)
    f = np.cos(((t / timesteps) + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bar = f / f[0]
    betas = 1 - alpha_bar[1:] / alpha_bar[:-1]
    return np.clip(betas, 0, 0.999).astype(np.float32)


@dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    features: tuple[int, ...] = (32, 64, 128)
    time_dim: int = 64
    channels: int = 1
    cond_channels: int = 0  # e.g. a one-hot segmentation for conditional synthesis


@functools.lru_cache(maxsize=None)
def _freqs(dim: int, device: torch.device) -> torch.Tensor:
    half = dim // 2
    f = np.exp(np.float32(-np.log(10000.0)) * np.arange(half, dtype=np.float32)
               / np.float32(half))
    return torch.from_numpy(f.astype(np.float32)).to(device)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) float32: [sin(t w), cos(t w)] with w =
    10000^(-k / (dim / 2))."""
    ang = t[..., None].float() * _freqs(dim, t.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sampling_timesteps(timesteps: int, steps: int) -> list[int]:
    """``jnp.linspace(timesteps - 1, 0, steps).astype(int32)`` as the JAX
    package's CPU code computes it: the fractions k / (steps - 1) as k times
    the float32 reciprocal of steps - 1, ``start * (1 - fraction)`` in
    float32, the end point last, each truncated toward zero. The same
    timesteps as JAX's up to 354 steps; above, XLA's vectorized division
    rounds otherwise, and at 1000 steps 102 of them differ by one."""
    if steps == 1:
        return [timesteps - 1]
    frac = np.arange(steps - 1, dtype=np.float32) * (np.float32(1) / np.float32(steps - 1))
    out = np.float32(timesteps - 1) * (np.float32(1) - frac)
    return [int(v) for v in out.astype(np.int32)] + [0]


def conditioned_launches(convs, width: int, features) -> list:
    """(block, input width, input needs a gradient) of a denoiser's
    ``convs``: (block, level, is the first on the data) triples."""
    widths = [width]
    for _ in features[1:]:
        widths.append((widths[-1] - 1) // 2 + 1)  # a 3x3 stride-2 conv padded (1, 1)
    out = []
    for block, level, first in convs:
        w = widths[max(level - 1, 0)] if block.Conv_0.stride[-1] == 2 else widths[level]
        out.append((block, w, not first))
    return out


class DenoiserUNet(nn.Module):
    """Epsilon-prediction U-Net: ``forward(x (N, H, W, C), t (N,), cond (N,
    H, W, Cc) or None)`` -> (N, H, W, C) float32. Two Dense layers embed the
    time; each level is a ``ConvNormAct`` (stride 2 below the first level),
    the time added through a Dense, and a second ``ConvNormAct``; each
    decoder level upsamples linearly, concatenates the skip, runs a
    ``ConvNormAct`` and adds the time; a zero-initialized 1x1 conv gives
    the output."""

    def __init__(self, cfg: DiffusionConfig, generator=None, conv_impl: str | None = None):
        super().__init__()
        self.cfg = cfg
        conv_impl = kernel_switches(2, conv_impl).conv_impl
        feats, td = cfg.features, cfg.time_dim
        kw = dict(generator=generator, conv_impl=conv_impl)
        self.Dense_0 = Dense(td, td, generator=generator)
        self.Dense_1 = Dense(td, td, generator=generator)
        cin = cfg.channels + cfg.cond_channels
        for i, f in enumerate(feats):
            self.add_module(f"ConvNormAct_{2 * i}", ConvNormAct(cin, f, 2 if i else 1, **kw))
            self.add_module(f"Dense_{2 + i}", Dense(td, f, generator=generator))
            self.add_module(f"ConvNormAct_{2 * i + 1}", ConvNormAct(f, f, 1, **kw))
            cin = f
        n = len(feats)
        for i, f in enumerate(reversed(feats[:-1])):
            skip = feats[n - 2 - i]
            self.add_module(f"ConvNormAct_{2 * n + i}", ConvNormAct(cin + skip, f, 1, **kw))
            self.add_module(f"Dense_{2 + n + i}", Dense(td, f, generator=generator))
            cin = f
        self.Conv_0 = Conv(cin, cfg.channels, 1, generator=generator)
        with torch.no_grad():
            self.Conv_0.weight.zero_()

    def forward(self, x, t, cond=None):
        cfg, n = self.cfg, len(self.cfg.features)
        temb = self.Dense_1(F.silu(self.Dense_0(time_embedding(t, cfg.time_dim))))
        act = F.silu(temb)
        if cond is not None:
            x = torch.cat([x, cond], dim=-1)
        h = x.movedim(-1, 1)
        skips = []
        for i in range(n):
            h = getattr(self, f"ConvNormAct_{2 * i}")(h)
            h = h + getattr(self, f"Dense_{2 + i}")(act)[:, :, None, None]
            h = getattr(self, f"ConvNormAct_{2 * i + 1}")(h)
            skips.append(h)
        for i in range(n - 1):
            h = upsample_linear(h, (2, 2))
            h = torch.cat([h, skips[n - 2 - i]], dim=1)
            h = getattr(self, f"ConvNormAct_{2 * n + i}")(h)
            h = h + getattr(self, f"Dense_{2 + n + i}")(act)[:, :, None, None]
        return self.Conv_0(h).movedim(1, -1)

    def kernel_launches(self, width: int, backward: bool = False) -> dict[str, int]:
        """K6 (and with ``backward`` K6 dx and dw) launches of a forward on
        inputs ``width`` pixels wide; the first conv's input is the data, whose
        gradient the backward never takes."""
        n = len(self.cfg.features)
        convs = [(getattr(self, f"ConvNormAct_{2 * i + j}"), i, i == 0 and j == 0)
                 for i in range(n) for j in (0, 1)]
        convs += [(getattr(self, f"ConvNormAct_{2 * n + i}"), n - 2 - i, False)
                  for i in range(n - 1)]
        return routed_counts(conditioned_launches(convs, width, self.cfg.features), backward)


class DDPM:
    """Forward q-sampling, the training loss and ancestral sampling over
    ``model`` (a :class:`DenoiserUNet` or any module with its call)."""

    def __init__(self, model: nn.Module, cfg: DiffusionConfig):
        self.model = model
        self.cfg = cfg
        betas = cosine_beta_schedule(cfg.timesteps)
        alphas = (np.float32(1) - betas).astype(np.float32)
        self._tables = {"betas": betas, "alphas": alphas,
                        "alpha_bars": np.cumprod(alphas, dtype=np.float32)}
        self._on = {}

    def table(self, name: str, device) -> torch.Tensor:
        """The float32 table ``betas``, ``alphas`` or ``alpha_bars`` on
        ``device``."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = torch.from_numpy(self._tables[name]).to(device)
        return self._on[key]

    @property
    def betas(self) -> torch.Tensor:
        return self.table("betas", "cpu")

    @property
    def alphas(self) -> torch.Tensor:
        return self.table("alphas", "cpu")

    @property
    def alpha_bars(self) -> torch.Tensor:
        return self.table("alpha_bars", "cpu")

    def q_sample(self, x0, t, noise):
        """sqrt(alpha_bar_t) x0 + sqrt(1 - alpha_bar_t) noise."""
        ab = self.table("alpha_bars", x0.device)[t][:, None, None, None]
        return torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise

    def draws(self, x0, generator=None, t=None, noise=None):
        """(t, noise) of a loss: drawn from ``generator`` where not given."""
        if t is None:
            t = torch.randint(0, self.cfg.timesteps, (x0.shape[0],), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        return t.to(x0.device, torch.int64), noise.to(x0.device)

    def loss(self, x0, cond=None, generator=None, t=None, noise=None):
        """Epsilon-prediction MSE (the DDPM objective)."""
        t, noise = self.draws(x0, generator, t, noise)
        eps = self.model(self.q_sample(x0, t, noise), t, cond)
        return (eps - noise).square().mean()

    @torch.no_grad()
    def sample(self, shape, cond=None, steps: int | None = None, generator=None, x=None,
               noises=None, device=None):
        """Ancestral sampling over ``steps`` timesteps from T - 1 down to 0
        (all of them by default): ``x`` the chain's start and ``noises`` its
        per-step unit normals (``steps`` of ``shape``), drawn from
        ``generator`` where not given; on ``device`` (the model's by
        default)."""
        steps = steps or self.cfg.timesteps
        if device is None:
            device = next(self.model.parameters()).device
        betas, alphas, abars = (self.table(k, device) for k in ("betas", "alphas", "alpha_bars"))
        x = torch.randn(shape, generator=generator, device=device) if x is None else x.to(device)
        for k, t in enumerate(sampling_timesteps(self.cfg.timesteps, steps)):
            tvec = torch.full((shape[0],), t, dtype=torch.int64, device=device)
            eps = self.model(x, tvec, cond)
            beta, alpha, ab = betas[t], alphas[t], abars[t]
            mean = (x - beta / torch.sqrt(1 - ab) * eps) / torch.sqrt(alpha)
            z = (torch.randn(shape, generator=generator, device=device) if noises is None
                 else noises[k].to(device))
            x = mean + z * torch.sqrt(beta) if t > 0 else mean
        return x

