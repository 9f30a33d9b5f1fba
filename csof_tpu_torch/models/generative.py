"""The generative extras (port of ``csof_tpu/models/generative.py``): the KL
autoencoder and latent diffusion over its latents, the ControlNet-style
controlled denoiser, and the Swin GAN pair.

Images and latents are channels last, ``(N, H, W, C)``, NCHW inside the
convs; the Swin stages run on channels-last maps batched over N, where the
JAX modules ``vmap`` them. As in JAX:

- ``SwinDiscriminator``'s stem is flax's ``Conv(f, 3x3, stride 2,
  padding="SAME")``, which on an even input pads (0, 1): output pixel (0, 0)
  takes the kernel's tap (0, 0) at input pixel (0, 0), not torch's
  ``padding=1``;
- ``ControlledDenoiserUNet`` resizes a hint of another size with
  ``jax.image.resize(..., "linear")``, which antialiases when it shrinks:
  ``F.interpolate(bilinear, align_corners=False, antialias=True)``;
- the ControlNet's zero convs start at zero, so at init the hint changes
  nothing, bit for bit; its base stands for a pretrained denoiser and its
  output conv is not zero-initialized.

Each draw (the autoencoder's latent sample, the diffusion draws) comes from
an explicit ``torch.Generator`` or is given. The autoencoder's decoder, the
denoisers and the control branch run kernel K6 under ``conv_impl="pallas"``
(``CSOF_CONV2D_IMPL=pallas``) where the JAX package runs its Pallas conv;
``kernel_launches`` counts the launches. The Swin GAN runs no kernel of the
port (plain 3x3 convs, as in JAX).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvNormAct, Dense, upsample_linear, kernel_switches
from csof_tpu_torch.models.segflow import routed_counts
from csof_tpu_torch.models.diffusion import (DDPM, DenoiserUNet, DiffusionConfig,
                                             conditioned_launches, time_embedding)
from csof_tpu_torch.models.swin import PatchMerging, SwinStage


def _normal_like(x, generator):
    return torch.randn(x.shape, generator=generator, device=x.device)


class KLAutoencoder(nn.Module):
    """Conv VAE: encoder (4x4 stride-2 ``ConvNormAct`` ``enc_i``) -> 1x1
    ``moments`` (mu, logvar) -> decoder (linear 2x upsampling and a 3x3
    ``ConvNormAct`` ``dec_i`` per feature, reversed) -> 1x1 ``out``."""

    def __init__(self, features=(32, 64), latent_dim: int = 4, in_channels: int = 1,
                 generator=None, conv_impl: str | None = None):
        super().__init__()
        self.features, self.latent_dim = tuple(features), latent_dim
        conv_impl = kernel_switches(2, conv_impl).conv_impl
        prev = in_channels
        for i, f in enumerate(self.features):
            self.add_module(f"enc_{i}", ConvNormAct(prev, f, 2, generator=generator,
                                                    kernel_size=4))
            prev = f
        self.moments = Conv(prev, 2 * latent_dim, 1, init="lecun_normal", generator=generator)
        prev = latent_dim
        for i, f in enumerate(reversed(self.features)):
            self.add_module(f"dec_{i}", ConvNormAct(prev, f, 1, generator=generator,
                                                    conv_impl=conv_impl))
            prev = f
        self.out = Conv(prev, 1, 1, init="lecun_normal", generator=generator)

    def encode(self, x: torch.Tensor):
        """(N, H, W, C) -> (mu, logvar), each (N, H / 2^k, W / 2^k, latent)."""
        h = x.movedim(-1, 1)
        for i in range(len(self.features)):
            h = getattr(self, f"enc_{i}")(h)
        m = self.moments(h).movedim(1, -1)
        return m[..., :self.latent_dim], m[..., self.latent_dim:]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = z.movedim(-1, 1)
        for i in range(len(self.features)):
            h = getattr(self, f"dec_{i}")(upsample_linear(h, (2, 2)))
        return self.out(h).movedim(1, -1)

    def forward(self, x: torch.Tensor, generator=None, eps=None) -> dict:
        """``eps``: the unit normal of the latent sample, drawn from
        ``generator`` if not given."""
        mu, logvar = self.encode(x)
        eps = _normal_like(mu, generator) if eps is None else eps.to(mu.device)
        z = mu + torch.exp(0.5 * logvar) * eps
        kl = -0.5 * (1 + logvar - mu.square() - torch.exp(logvar)).mean()
        return {"reconstruction": self.decode(z), "mu": mu, "logvar": logvar, "kl": kl}

    def kernel_launches(self, width: int, backward: bool = False) -> dict[str, int]:
        """K6 (and with ``backward`` K6 dx and dw) launches of a forward, or
        of a ``decode`` to images ``width`` pixels wide (the encoder runs
        none)."""
        w = width
        for _ in self.features:
            w = (w - 1) // 2 + 1  # a 4x4 stride-2 conv padded (1, 2)
        convs = []
        for i in range(len(self.features)):
            w *= 2
            convs.append((getattr(self, f"dec_{i}"), w, True))
        return routed_counts(convs, backward)


class LatentDiffusion:
    """DDPM over the KL autoencoder's latents: encode, scale, noise at a
    timestep, predict the noise, MSE. The autoencoder is frozen (its
    latents carry no gradient); ``denoiser`` is a :class:`DenoiserUNet` of
    ``denoiser_cfg``."""

    def __init__(self, ae: KLAutoencoder, denoiser_cfg: DiffusionConfig,
                 scaling_factor: float = 1.0, generator=None, conv_impl: str | None = None):
        self.ae = ae
        self.denoiser = DenoiserUNet(denoiser_cfg, generator, conv_impl)
        self.ddpm = DDPM(self.denoiser, denoiser_cfg)
        self.scaling_factor = scaling_factor

    def to(self, device) -> "LatentDiffusion":
        """Move the autoencoder and the denoiser to ``device``."""
        self.ae.to(device)
        self.denoiser.to(device)
        return self

    @torch.no_grad()
    def encode_latents(self, x, generator=None, eps=None):
        """Sampled latents times the scaling factor, without gradient;
        ``eps`` the sample's unit normal."""
        mu, logvar = self.ae.encode(x)
        eps = _normal_like(mu, generator) if eps is None else eps.to(mu.device)
        return (mu + torch.exp(0.5 * logvar) * eps) * self.scaling_factor

    def loss(self, x, cond=None, generator=None, eps=None, t=None, noise=None):
        latents = self.encode_latents(x, generator, eps)
        return self.ddpm.loss(latents, cond, generator, t, noise)

    @torch.no_grad()
    def sample(self, latent_shape, cond=None, steps=None, generator=None, x=None, noises=None):
        z = self.ddpm.sample(latent_shape, cond, steps, generator, x, noises)
        return self.ae.decode(z / self.scaling_factor)


class ControlledDenoiserUNet(nn.Module):
    """The denoiser U-Net (``base_*``) with a trainable control branch
    (``control_*``) fed a hint image: its per-level outputs join the base
    encoder's skips through zero-initialized 1x1 convs.

    ``forward(x (N, h, w, C), t (N,), hint (N, H, W, hint_channels))`` ->
    (N, h, w, C) float32."""

    def __init__(self, cfg: DiffusionConfig, hint_channels: int = 1, generator=None,
                 conv_impl: str | None = None):
        super().__init__()
        self.cfg = cfg
        conv_impl = kernel_switches(2, conv_impl).conv_impl
        feats, td, gen = cfg.features, cfg.time_dim, generator
        kw = dict(generator=gen, conv_impl=conv_impl)
        self.base_time0 = Dense(td, td, generator=gen)
        self.base_time1 = Dense(td, td, generator=gen)
        cin = cfg.channels + hint_channels
        for i, f in enumerate(feats):
            self.add_module(f"control_enc_{i}", ConvNormAct(cin, f, 2 if i else 1, **kw))
            self.add_module(f"control_temb_{i}", Dense(td, f, generator=gen))
            zero = Conv(f, f, 1, generator=gen)
            with torch.no_grad():
                zero.weight.zero_()
            self.add_module(f"control_zero_{i}", zero)
            cin = f
        cin = cfg.channels
        for i, f in enumerate(feats):
            self.add_module(f"base_enc_{i}", ConvNormAct(cin, f, 2 if i else 1, **kw))
            self.add_module(f"base_temb_{i}", Dense(td, f, generator=gen))
            self.add_module(f"base_enc2_{i}", ConvNormAct(f, f, 1, **kw))
            cin = f
        n = len(feats)
        for i, f in enumerate(reversed(feats[:-1])):
            self.add_module(f"base_dec_{i}", ConvNormAct(cin + feats[n - 2 - i], f, 1, **kw))
            self.add_module(f"base_dec_temb_{i}", Dense(td, f, generator=gen))
            cin = f
        self.base_out = Conv(cin, cfg.channels, 1, init="lecun_normal", generator=gen)

    def forward(self, x, t, hint):
        cfg, n = self.cfg, len(self.cfg.features)
        temb = self.base_time1(F.silu(self.base_time0(time_embedding(t, cfg.time_dim))))
        act = F.silu(temb)
        h = x.movedim(-1, 1)
        hint = hint.movedim(-1, 1)
        if hint.shape[2:] != h.shape[2:]:
            hint = F.interpolate(hint, size=h.shape[2:], mode="bilinear", align_corners=False,
                                 antialias=True)
        c = torch.cat([h, hint.to(h.dtype)], dim=1)
        controls = []
        for i in range(n):
            c = getattr(self, f"control_enc_{i}")(c)
            c = c + getattr(self, f"control_temb_{i}")(act)[:, :, None, None]
            controls.append(getattr(self, f"control_zero_{i}")(c))
        skips = []
        for i in range(n):
            h = getattr(self, f"base_enc_{i}")(h)
            h = h + getattr(self, f"base_temb_{i}")(act)[:, :, None, None]
            h = getattr(self, f"base_enc2_{i}")(h)
            h = h + controls[i]
            skips.append(h)
        for i in range(n - 1):
            h = upsample_linear(h, (2, 2))
            h = torch.cat([h, skips[n - 2 - i]], dim=1)
            h = getattr(self, f"base_dec_{i}")(h)
            h = h + getattr(self, f"base_dec_temb_{i}")(act)[:, :, None, None]
        return self.base_out(h).movedim(1, -1)

    def kernel_launches(self, width: int, backward: bool = False) -> dict[str, int]:
        """K6 (and with ``backward`` K6 dx) launches of a forward on inputs
        ``width`` pixels wide (the hint resized to it), and of the backward
        of a ControlNet step, which differentiates the control branch alone:
        the first control conv takes the data, and the base's level-0 convs
        come before the first control joins it, so none of their inputs
        takes a gradient; the base's weights are frozen, so K6 dw runs on
        the control convs alone."""
        n = len(self.cfg.features)
        convs = [(getattr(self, f"control_enc_{i}"), i, i == 0) for i in range(n)]
        convs += [(getattr(self, f"base_enc{j}_{i}"), i, i == 0)
                  for i in range(n) for j in ("", "2")]
        convs += [(getattr(self, f"base_dec_{i}"), n - 2 - i, False) for i in range(n - 1)]
        return routed_counts(conditioned_launches(convs, width, self.cfg.features), backward,
                             trained=[i < n for i in range(len(convs))])


def controlnet_param_labels(model: nn.Module) -> dict[str, str]:
    """{parameter name: "control" or "frozen"}: "control" for the trainable
    control branch (a top-level name starting with ``control``), "frozen"
    for the base U-Net."""
    return {name: "control" if name.split(".")[0].startswith("control") else "frozen"
            for name, _ in model.named_parameters()}


def controlnet_loss(model: ControlledDenoiserUNet, ddpm: DDPM):
    """``loss_fn(x0, hint, generator=None, t=None, noise=None)``: the DDPM
    epsilon MSE with the hint as conditioning."""

    def loss_fn(x0, hint, generator=None, t=None, noise=None):
        t, noise = ddpm.draws(x0, generator, t, noise)
        eps = model(ddpm.q_sample(x0, t, noise), t, hint)
        return (eps - noise).square().mean()

    return loss_fn


class SwinGenerator(nn.Module):
    """Latent vector (N, features[0]) -> image (N, base_hw 2^k, base_hw 2^k,
    out_channels) in (-1, 1): a Dense to a base map, then per level a linear
    2x upsampling and a 3x3 conv (after the first) and a Swin stage, then a
    last upsampling, 3x3 conv and tanh."""

    def __init__(self, features=(128, 64, 32), base_hw: int = 8, num_heads: int = 4,
                 window: int = 4, out_channels: int = 1, depth: int = 1,
                 latent_dim: int | None = None, generator=None):
        super().__init__()
        self.features, self.base_hw = tuple(features), base_hw
        f0 = self.features[0]
        self.Dense_0 = Dense(latent_dim or f0, base_hw * base_hw * f0, generator=generator)
        for i, f in enumerate(self.features):
            if i > 0:
                self.add_module(f"Conv_{i - 1}", Conv(self.features[i - 1], f, 3,
                                                      init="lecun_normal", generator=generator))
            self.add_module(f"stage_{i}", SwinStage(f, depth * 2, num_heads, window,
                                                    generator=generator))
        self.add_module(f"Conv_{len(self.features) - 1}", Conv(
            self.features[-1], out_channels, 3, init="lecun_normal", generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        f0 = self.features[0]
        h = self.Dense_0(z).reshape(z.shape[0], self.base_hw, self.base_hw, f0)
        for i in range(len(self.features)):
            if i > 0:
                h = upsample_linear(h.movedim(-1, 1), (2, 2))
                h = getattr(self, f"Conv_{i - 1}")(h).movedim(1, -1)
            h = getattr(self, f"stage_{i}")(h)
        h = upsample_linear(h.movedim(-1, 1), (2, 2))
        return torch.tanh(getattr(self, f"Conv_{len(self.features) - 1}")(h)).movedim(1, -1)


class SwinDiscriminator(nn.Module):
    """Image (N, H, W, C) -> (N,) real/fake logits: a 3x3 stride-2 SAME conv
    stem, per level a Swin stage and (but the last) a patch merging, the
    mean over the map and a Dense."""

    def __init__(self, features=(32, 64, 128), num_heads: int = 4, window: int = 4,
                 depth: int = 1, in_channels: int = 1, generator=None):
        super().__init__()
        self.features = tuple(features)
        self.Conv_0 = Conv(in_channels, self.features[0], 3, 2, padding="SAME",
                           init="lecun_normal", generator=generator)
        for i, f in enumerate(self.features):
            self.add_module(f"stage_{i}", SwinStage(f, depth * 2, num_heads, window,
                                                    generator=generator))
            if i < len(self.features) - 1:
                self.add_module(f"merge_{i}", PatchMerging(f, self.features[i + 1],
                                                           generator=generator))
        self.Dense_0 = Dense(self.features[-1], 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x.movedim(-1, 1)).movedim(1, -1)
        for i in range(len(self.features)):
            h = getattr(self, f"stage_{i}")(h)
            if i < len(self.features) - 1:
                h = getattr(self, f"merge_{i}")(h)
        return self.Dense_0(h.mean(dim=(1, 2)))[..., 0]
