"""On-device data augmentation (port of ``csof_tpu/data/augment.py``).

The same transforms, envelopes and order as the JAX package: one fused
spatial warp (rotation and scale about the centre, translation, an optional
elastic displacement, then the mirrors) shared by an image and its
segmentation, then the intensity chain (Gaussian noise, blur, brightness,
contrast, low-resolution simulation, inverted gamma, gamma, Rician noise,
Gibbs ringing, sharpening), each behind its own gate.

Each transform is split into a **draw** and an **apply**. A draw holds the
gates and scalars of a batch, and the noise fields where a transform uses
them, as tensors with a leading batch axis (``draw_spatial``,
``draw_intensity``); it is made on the batch's device from an explicit
``torch.Generator`` (``step_generator``: the config's seed + 17 and the
step count, as the JAX train step folds its key). An apply is
deterministic given its draw, so the JAX package's own draws reproduce its
outputs (``tests/test_torch_augment.py``).

Layout: channel-first batches, images (N, C, H, W), segmentations (N, H,
W); a video batch (N, T, H, W, C) is stacked to (N, C*T, H, W) as the JAX
package stacks a clip (channel c*T + t). Per-sample statistics (contrast's
mean, gamma's range and moments) are taken over all of a sample's channels,
as JAX takes them over a sample's (H, W, C).

Ported exactly where torch's own op differs: ``jax.image.resize``'s
"nearest" (index floor((i + 0.5) * in / out), torch's ``nearest-exact``) and
"cubic" (Keys, a = -0.5, weights renormalised at the edges) are written out
in ``resize_nearest`` and ``resize_cubic``; the elastic blur's reflect
padding takes any radius; the spatial warp is the JAX sampler
(:func:`csof_tpu_torch.ops.warp.grid_sample`: pixel coordinates, zero
padding, ``round`` half to even for segmentations).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from csof_tpu_torch.ops.warp import grid_sample


@dataclass(frozen=True)
class AugmentConfig:
    # spatial (nnU-Net V2: rotation +-30 degrees, scale 0.7-1.4, no elastic)
    p_rotation: float = 0.2
    max_rotation: float = 30.0  # degrees
    p_scale: float = 0.2
    scale_range: tuple[float, float] = (0.7, 1.4)
    p_mirror: float = 0.5
    p_translate: float = 0.0
    translate_range: float = 26.0  # pixels, uniform in +-range per axis
    p_elastic: float = 0.0
    elastic_alpha: tuple[float, float] = (0.0, 200.0)
    elastic_sigma: tuple[float, float] = (9.0, 13.0)
    # intensity
    p_noise: float = 0.1
    noise_max_sigma: float = 0.1
    p_blur: float = 0.2
    blur_sigma: tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: tuple[float, float] = (0.75, 1.25)
    p_gamma: float = 0.3
    gamma_range: tuple[float, float] = (0.7, 1.5)
    gamma_retain_stats: bool = True
    p_inverted_gamma: float = 0.1
    p_lowres: float = 0.25
    lowres_zoom: tuple[float, float] = (0.5, 1.0)
    p_lowres_per_channel: float = 0.5
    lowres_levels: int = 8  # the zoom is quantised to this many levels, as in JAX
    # MRI pixel artifacts (the video envelope)
    p_rician: float = 0.0
    rician_std: float = 0.075
    p_gibbs: float = 0.0
    gibbs_alpha: tuple[float, float] = (0.45, 0.75)
    p_sharpen: float = 0.0
    sharpen_sigma1: tuple[float, float] = (0.1, 0.2)
    sharpen_sigma2: tuple[float, float] = (0.2, 0.4)
    sharpen_alpha: tuple[float, float] = (2.0, 3.0)


def video_augment_config() -> AugmentConfig:
    """The video loaders' envelope: flips, rotation, zoom and translation at
    p=0.5 and the MRI pixel set (Rician, Gibbs, gamma, Gaussian noise,
    sharpening) at p=0.5."""
    return AugmentConfig(
        p_rotation=0.5, max_rotation=180.0,
        p_scale=0.5, scale_range=(0.5, 1.5),
        p_mirror=0.5,
        p_translate=0.5, translate_range=26.0,
        p_noise=0.5, noise_max_sigma=0.04,
        p_blur=0.0,
        p_brightness=0.5, brightness_range=(0.8, 1.2),
        p_contrast=0.0,
        p_gamma=0.5, gamma_range=(0.7, 1.5), gamma_retain_stats=False,
        p_inverted_gamma=0.0,
        p_lowres=0.0,
        p_rician=0.5, rician_std=0.075,
        p_gibbs=0.5, gibbs_alpha=(0.45, 0.75),
        p_sharpen=0.5,
    )


def default_augment_config() -> AugmentConfig:
    """The base nnU-Net envelope: the V2 one with elastic deformation at p=0.2."""
    return AugmentConfig(p_elastic=0.2)


def clip_augment_config() -> AugmentConfig:
    """``augment_video``'s default: the video envelope with the clip-scale
    spatial parameters of the 2D envelope and no translation."""
    return replace(video_augment_config(), p_rotation=0.2, max_rotation=30.0, p_scale=0.2,
                   scale_range=(0.7, 1.4), p_translate=0.0)


ELASTIC_RADIUS = 39  # the blur support, 3 * the largest sigma (13)
BLUR_RADIUS = 2


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``: seeded from ``seed + 17`` and
    the step, as the JAX step folds its key ``fold_in(PRNGKey(seed + 17),
    step)``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(((seed + 17) << 32) | (int(step) & 0xFFFFFFFF))
    return gen


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _gate(gen, n, p, device):
    return torch.rand(n, generator=gen, device=device) < p


def draw_spatial(gen: torch.Generator, n: int, h: int, w: int, cfg: AugmentConfig,
                 device=None) -> dict:
    """Spatial draw of n samples: angle (radians), scale, ty, tx, flip_y,
    flip_x (N,), and where ``p_elastic > 0`` the elastic gate (N,) float,
    alpha, sigma (N,) and noise (N, 2, H, W) uniform in [-1, 1)."""
    angle = _uniform(gen, n, -1.0, 1.0, device) * math.radians(cfg.max_rotation)
    scale = _uniform(gen, n, *cfg.scale_range, device)
    r = float(cfg.translate_range)
    trans = _uniform(gen, (2, n), -r, r, device)
    do_rot, do_scale, do_trans, flip_y, flip_x = (
        _gate(gen, n, p, device) for p in (cfg.p_rotation, cfg.p_scale, cfg.p_translate,
                                            cfg.p_mirror, cfg.p_mirror))
    zero = torch.zeros(n, device=device)
    draw = {"angle": torch.where(do_rot, angle, zero),
            "scale": torch.where(do_scale, scale, zero + 1.0),
            "ty": torch.where(do_trans, trans[0], zero),
            "tx": torch.where(do_trans, trans[1], zero),
            "flip_y": flip_y, "flip_x": flip_x}
    if cfg.p_elastic > 0:
        draw["elastic"] = _gate(gen, n, cfg.p_elastic, device).float()
        draw["elastic_alpha"] = _uniform(gen, n, *cfg.elastic_alpha, device)
        draw["elastic_sigma"] = _uniform(gen, n, *cfg.elastic_sigma, device)
        draw["elastic_noise"] = _uniform(gen, (n, 2, h, w), -1.0, 1.0, device)
    return draw


def draw_intensity(gen: torch.Generator, shape, cfg: AugmentConfig, device=None) -> dict:
    """Intensity draw of a batch of ``shape`` (N, C, H, W): a gate (N,) bool
    and the scalars of each transform, the Gaussian-noise field (N, C, H, W)
    and, where the transform is on, the low-res zoom level and gate per
    channel (N, C) and the two Rician fields (N, C, H, W) (standard normal)."""
    n = shape[0]
    u = lambda lo, hi: _uniform(gen, n, lo, hi, device)  # noqa: E731
    g = lambda p: _gate(gen, n, p, device)  # noqa: E731
    draw = {
        "noise": g(cfg.p_noise), "noise_sigma": u(0.0, cfg.noise_max_sigma),
        "noise_field": torch.randn(shape, generator=gen, device=device),
        "blur": g(cfg.p_blur), "blur_sigma": u(*cfg.blur_sigma),
        "brightness": g(cfg.p_brightness), "brightness_factor": u(*cfg.brightness_range),
        "contrast": g(cfg.p_contrast), "contrast_factor": u(*cfg.contrast_range),
        "gamma": g(cfg.p_gamma), "gamma_value": _draw_gamma(gen, n, cfg.gamma_range, device),
    }
    if cfg.p_lowres > 0:
        draw["lowres"] = g(cfg.p_lowres)
        draw["lowres_level"] = torch.randint(0, cfg.lowres_levels, tuple(shape[:2]),
                                             generator=gen, device=device)
        draw["lowres_channel"] = torch.rand(tuple(shape[:2]), generator=gen,
                                            device=device) < cfg.p_lowres_per_channel
    if cfg.p_inverted_gamma > 0:
        draw["inverted_gamma"] = g(cfg.p_inverted_gamma)
        draw["inverted_gamma_value"] = _draw_gamma(gen, n, cfg.gamma_range, device)
    if cfg.p_rician > 0:
        draw["rician"] = g(cfg.p_rician)
        draw["rician_std"] = u(0.0, cfg.rician_std)
        draw["rician_fields"] = torch.randn((2, *shape), generator=gen, device=device)
    if cfg.p_gibbs > 0:
        draw["gibbs"] = g(cfg.p_gibbs)
        draw["gibbs_alpha"] = u(*cfg.gibbs_alpha)
    if cfg.p_sharpen > 0:
        draw["sharpen"] = g(cfg.p_sharpen)
        draw["sharpen_sigma1"] = u(*cfg.sharpen_sigma1)
        draw["sharpen_sigma2"] = u(*cfg.sharpen_sigma2)
        draw["sharpen_alpha"] = u(*cfg.sharpen_alpha)
    return draw


def _draw_gamma(gen, n, gamma_range, device):
    """augment_gamma's bimodal draw: half the time from (lo, 1), else (1, hi)."""
    lo = _uniform(gen, n, gamma_range[0], 1.0, device)
    hi = _uniform(gen, n, 1.0, gamma_range[1], device)
    low_side = _gate(gen, n, 0.5, device) & (gamma_range[0] < 1)
    return torch.where(low_side, lo, hi)


# ---------------------------------------------------------------------------
# applies (deterministic given the draw)
# ---------------------------------------------------------------------------


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-sample (N,) value shaped to broadcast over x (N, ...)."""
    return v.reshape(-1, *([1] * (x.dim() - 1))).to(x.dtype)


def gauss_kernel(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, 2r+1) normalised Gaussian taps of each sample's sigma (N,)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x[None] / sigma.float().clamp_min(1e-3)[:, None]) ** 2)
    return k / k.sum(-1, keepdim=True)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" padding of a length-n axis by r a side,
    any r (the pattern repeats with period 2(n-1))."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _conv_axis(x: torch.Tensor, k: torch.Tensor, axis: int, mode: str) -> torch.Tensor:
    """Per-sample 1-D correlation of x (N, C, H, W) with taps k (N, 2r+1)
    along ``axis`` (2 or 3), padding "edge" or "reflect"."""
    r = (k.shape[1] - 1) // 2
    n = x.shape[axis]
    if mode == "edge":
        idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    else:
        idx = _reflect_index(n, r, x.device)
    xp = x.index_select(axis, idx)
    out = torch.zeros_like(x)
    for j in range(2 * r + 1):
        out = out + _bc(k[:, j], x) * xp.narrow(axis, j, n)
    return out


def separable_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The JAX ``_separable_blur``: radius-2 Gaussian of each sample's sigma
    along H, then W, edge padding. x (N, C, H, W), sigma (N,)."""
    k = gauss_kernel(sigma, BLUR_RADIUS).to(x.dtype)
    return _conv_axis(_conv_axis(x, k, 2, "edge"), k, 3, "edge")


def elastic_offset(noise: torch.Tensor, alpha: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Backward-map displacement (N, H, W, 2): the noise (N, 2, H, W) blurred
    along H then W by a Gaussian of radius 39 with reflect padding, times
    alpha (N,)."""
    k = gauss_kernel(sigma, ELASTIC_RADIUS)
    x = _conv_axis(_conv_axis(noise.float(), k, 2, "reflect"), k, 3, "reflect")
    return (x * _bc(alpha, x)).permute(0, 2, 3, 1)


def spatial_coords(draw: dict, h: int, w: int) -> torch.Tensor:
    """(N, H, W, 2) backward-map pixel coordinates (y, x) of the spatial
    draw: the elastic displacement added to the centred grid, then rotation
    and scale about the centre, then the translation."""
    angle = draw["angle"]
    device = angle.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy = (torch.arange(h, dtype=torch.float32, device=device) - cy)[None, :, None]
    gx = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, None, :]
    gy, gx = gy.expand(len(angle), h, w), gx.expand(len(angle), h, w)
    if "elastic" in draw:
        disp = _bc(draw["elastic"], gy[..., None]) * elastic_offset(
            draw["elastic_noise"], draw["elastic_alpha"], draw["elastic_sigma"])
        gy, gx = gy + disp[..., 0], gx + disp[..., 1]
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    scale = draw["scale"][:, None, None]
    y = (gy * cos + gx * -sin) * scale + (cy - draw["ty"])[:, None, None]
    x = (gy * sin + gx * cos) * scale + (cx - draw["tx"])[:, None, None]
    return torch.stack([y, x], dim=-1)


def apply_spatial(x: torch.Tensor, coords: torch.Tensor, flip_y: torch.Tensor,
                  flip_x: torch.Tensor, mode: str) -> torch.Tensor:
    """Warp x (N, C, H, W) to coords (zero padding), then mirror each sample
    along H where flip_y and along W where flip_x."""
    out = grid_sample(x, coords, mode=mode, padding="zeros")
    out = torch.where(_bc(flip_y, out).bool(), out.flip(2), out)
    return torch.where(_bc(flip_x, out).bool(), out.flip(3), out)


def _mean(x):
    return x.mean(dim=tuple(range(1, x.dim())), keepdim=True)


def _std(x):
    return x.std(dim=tuple(range(1, x.dim())), keepdim=True, correction=0)


def gamma_apply(x: torch.Tensor, gamma: torch.Tensor, invert: bool = False,
                retain_stats: bool = True) -> torch.Tensor:
    """augment_gamma on x (N, ...) with each sample's gamma (N,): on the
    min-max normalised sample, optionally around an inversion, optionally
    restoring the mean and standard deviation."""
    if invert:
        x = -x
    mu, sd = _mean(x), _std(x)
    dims = tuple(range(1, x.dim()))
    mn, mx = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    rng = mx - mn
    out = ((x - mn) / (rng + 1e-7)) ** _bc(gamma, x) * rng + mn
    if retain_stats:
        out = (out - _mean(out)) / (_std(out) + 1e-8) * sd + mu
    return -out if invert else out


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of x (..., H, W): the source
    index floor(((i + 0.5) * in) / out) in float32."""
    for axis, n in ((-2, size[0]), (-1, size[1])):
        m = x.shape[axis]
        if m == n:
            continue
        # on the CPU: CUDA divides a tensor by a scalar as a product with its
        # reciprocal, which moves floor() at whole numbers
        pos = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
        x = x.index_select(x.dim() + axis, torch.floor(pos).long().to(x.device))
    return x


def _cubic_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) weights of ``jax.image.resize(..., "cubic")`` along one axis:
    Keys' kernel (a = -0.5), widened by in/out when shrinking, each output's
    weights renormalised to sum 1, zero where its sample lies off the input.
    Computed on the CPU (the same bits on every device), then moved."""
    inv = torch.tensor(1.0 / (n / m), dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv - 0.0 * inv - 0.5
    xk = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None]).abs()
    xk = xk / kernel_scale
    out = ((1.5 * xk - 2.5) * xk) * xk + 1.0
    out = torch.where(xk >= 1.0, ((-0.5 * xk + 2.5) * xk - 4.0) * xk + 2.0, out)
    wts = torch.where(xk >= 2.0, torch.zeros_like(out), out)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts)).to(device)


def resize_cubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "cubic")`` of x (..., H, W)."""
    h, w = x.shape[-2:]
    if h != size[0]:
        x = torch.einsum("...hw,hi->...iw", x, _cubic_weights(h, size[0], x.device).to(x.dtype))
    if w != size[1]:
        x = torch.einsum("...hw,wj->...hj", x, _cubic_weights(w, size[1], x.device).to(x.dtype))
    return x


def lowres_sizes(h: int, w: int, zoom_range, levels: int) -> list[tuple[int, int]]:
    """The low-resolution size of each zoom level, as the JAX package
    quantises the zoom: linspace over the range, Python round."""
    return [(max(1, round(z * h)), max(1, round(z * w)))
            for z in np.linspace(zoom_range[0], zoom_range[1], levels)]


def lowres_apply(x: torch.Tensor, level: torch.Tensor, channel_gate: torch.Tensor,
                 zoom_range=(0.5, 1.0), levels: int = 8) -> torch.Tensor:
    """SimulateLowResolution on x (N, C, H, W): each (sample, channel) plane
    whose gate is set is resized down to its level's size (nearest) and back
    (cubic)."""
    h, w = x.shape[-2:]
    out = x.clone()
    sizes = lowres_sizes(h, w, zoom_range, levels)
    for lvl in torch.unique(level[channel_gate]).tolist():
        sel = channel_gate & (level == lvl)
        planes = x[sel]
        out[sel] = resize_cubic(resize_nearest(planes, sizes[lvl]), (h, w))
    return out


def rician_apply(x: torch.Tensor, std: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """RandRicianNoise: sqrt((x + n1)^2 + n2^2) with the sign of x + n1,
    n_i = fields[i] * std (fields (2, *x.shape) standard normal)."""
    s = _bc(std, x)
    n1, n2 = fields[0] * s, fields[1] * s
    return torch.sign(x + n1) * torch.sqrt((x + n1) ** 2 + n2 ** 2)


def gibbs_apply(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """k-space truncation ringing of each plane of x (N, C, H, W): the 2-D
    FFT times exp(-q d^2), d the normalised distance from the k-space
    centre, q = 10 alpha / max(1 - alpha, 1e-3), back to the real part."""
    h, w = x.shape[-2:]
    fy = torch.fft.fftfreq(h, device=x.device)[:, None]
    fx = torch.fft.fftfreq(w, device=x.device)[None, :]
    d2 = (fy / 0.5) ** 2 + (fx / 0.5) ** 2
    q = 10.0 * alpha.float() / torch.clamp(1.0 - alpha.float(), min=1e-3)
    mask = torch.exp(-q[:, None, None, None] * d2)
    k = torch.fft.fft2(x, dim=(-2, -1))
    return torch.fft.ifft2(k * mask, dim=(-2, -1)).real.to(x.dtype)


def sharpen_apply(x: torch.Tensor, sigma1: torch.Tensor, sigma2: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """Unsharp masking: b1 = blur(x, s1), b2 = blur(b1, s2), b1 + a (b1 - b2)."""
    b1 = separable_blur(x, sigma1)
    b2 = separable_blur(b1, sigma2)
    return b1 + _bc(alpha, x) * (b1 - b2)


def apply_intensity(x: torch.Tensor, draw: dict, cfg: AugmentConfig) -> torch.Tensor:
    """The intensity chain on x (N, C, H, W), in the JAX package's order."""

    def gated(name, y, new):
        return torch.where(_bc(draw[name], y).bool(), new, y)

    x = x + (_bc(draw["noise"], x) * draw["noise_field"]) * _bc(draw["noise_sigma"], x)
    x = gated("blur", x, separable_blur(x, draw["blur_sigma"]))
    x = gated("brightness", x, x * _bc(draw["brightness_factor"], x))
    mean = _mean(x)
    x = gated("contrast", x, (x - mean) * _bc(draw["contrast_factor"], x) + mean)
    if cfg.p_lowres > 0:
        x = gated("lowres", x, lowres_apply(x, draw["lowres_level"], draw["lowres_channel"],
                                            cfg.lowres_zoom, cfg.lowres_levels))
    if cfg.p_inverted_gamma > 0:
        x = gated("inverted_gamma", x, gamma_apply(x, draw["inverted_gamma_value"], True,
                                                   cfg.gamma_retain_stats))
    x = gated("gamma", x, gamma_apply(x, draw["gamma_value"], False, cfg.gamma_retain_stats))
    if cfg.p_rician > 0:
        x = gated("rician", x, rician_apply(x, draw["rician_std"], draw["rician_fields"]))
    if cfg.p_gibbs > 0:
        x = gated("gibbs", x, gibbs_apply(x, draw["gibbs_alpha"]))
    if cfg.p_sharpen > 0:
        x = gated("sharpen", x, sharpen_apply(x, draw["sharpen_sigma1"], draw["sharpen_sigma2"],
                                              draw["sharpen_alpha"]))
    return x


def apply_augment(images: torch.Tensor, segs: torch.Tensor, spatial: dict, intensity: dict,
                  cfg: AugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole pipeline given its draws: images (N, C, H, W) float warped
    bilinear, segs (N, K, H, W) warped nearest (as float, back to their
    dtype), then the intensity chain on the images."""
    h, w = images.shape[-2:]
    coords = spatial_coords(spatial, h, w)
    img = apply_spatial(images, coords, spatial["flip_y"], spatial["flip_x"], "bilinear")
    seg = apply_spatial(segs.float(), coords, spatial["flip_y"], spatial["flip_x"], "nearest")
    return apply_intensity(img, intensity, cfg), seg.to(segs.dtype)


#: intensity draws whose batch axis is not the first
_BATCH_AXIS = {"rician_fields": 1}


def _draws(gen: torch.Generator, shape, cfg: AugmentConfig, device,
           rows: tuple[int, slice] | None) -> tuple[dict, dict]:
    """The spatial and intensity draws of a batch of ``shape`` (N, C, H, W);
    with ``rows`` = (n, sl), those of a batch of n, cut to its rows ``sl``
    (a rank's rows of the global batch get the global batch's draws)."""
    n = shape[0] if rows is None else rows[0]
    spatial = draw_spatial(gen, n, shape[2], shape[3], cfg, device)
    intensity = draw_intensity(gen, (n, *shape[1:]), cfg, device)
    if rows is not None:
        spatial = {k: v[rows[1]] for k, v in spatial.items()}
        intensity = {k: v[(slice(None),) * _BATCH_AXIS.get(k, 0) + (rows[1],)]
                     for k, v in intensity.items()}
    return spatial, intensity


def augment_batch_2d(gen: torch.Generator, images: torch.Tensor, segs: torch.Tensor,
                     cfg: AugmentConfig = AugmentConfig(),
                     rows: tuple[int, slice] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """images (N, C, H, W), segs (N, H, W) -> the augmented pair, each sample
    with its own draw, on the batch's device. ``rows`` = (n, sl): the batch
    is rows ``sl`` of one of n, and takes their draws."""
    spatial, intensity = _draws(gen, tuple(images.shape), cfg, images.device, rows)
    img, seg = apply_augment(images, segs[:, None], spatial, intensity, cfg)
    return img, seg[:, 0]


def augment_video(gen: torch.Generator, video: torch.Tensor, seg: torch.Tensor,
                  cfg: AugmentConfig | None = None,
                  rows: tuple[int, slice] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """video (N, T, H, W, C), seg (N, T, H, W): one spatial and one intensity
    draw per clip, applied to all of its frames (``clip_augment_config`` by
    default); ``rows`` as for ``augment_batch_2d``."""
    cfg = cfg or clip_augment_config()
    n, t, h, w, c = video.shape
    stacked = video.permute(0, 4, 1, 2, 3).reshape(n, c * t, h, w)
    spatial, intensity = _draws(gen, tuple(stacked.shape), cfg, video.device, rows)
    img, seg_out = apply_augment(stacked, seg, spatial, intensity, cfg)
    return img.reshape(n, c, t, h, w).permute(0, 2, 3, 4, 1), seg_out
