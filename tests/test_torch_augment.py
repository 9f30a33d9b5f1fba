"""The port's augmentation (``csof_tpu_torch.data.augment``) against the JAX
package's (``csof_tpu/data/augment.py``). Each transform's apply is fed the
JAX function's own draws (the test replays its key splits) and must give
the JAX output: float32 within 1e-5 (the same math in another summation
order; FFTs within 2e-5 of the plane's largest value), segmentations
exactly. Then the port's own draws: each gate fires at its rate over 2000
draws (within 4 sigma), one seed and step give the same bits twice, and the
trainer augments a train step and leaves validation alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads

from csof_tpu.data import augment as ja
from csof_tpu.ops.warp import grid_sample as jax_grid_sample
from csof_tpu_torch.data import augment as ta
from csof_tpu_torch.ops.warp import grid_sample

torch_threads.pin()

TOL = 1e-5
FFT_TOL = 2e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _chw(x) -> torch.Tensor:
    """A JAX (H, W, C) array as a port batch of one (1, C, H, W)."""
    return _t(np.asarray(x)).permute(2, 0, 1)[None].contiguous()


def _hwc(x: torch.Tensor) -> np.ndarray:
    return x[0].permute(1, 2, 0).numpy()


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, np.abs(ref).max()), rtol=0)


def _image(seed=0, h=40, w=36, c=2):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2).astype(np.float32)
    return (2 * blob[..., None] + 0.3 * rng.randn(h, w, c)).astype(np.float32)


def _u(key, lo, hi):
    return float(jax.random.uniform(key, minval=lo, maxval=hi))


# --------------------------------------------------------------------------
# the JAX draws, replayed from its key splits, in the port's layout
# --------------------------------------------------------------------------


def _gamma_draw(key, gamma_range):
    k1, k2, k3 = jax.random.split(key, 3)
    lo, hi = _u(k2, gamma_range[0], 1.0), _u(k3, 1.0, gamma_range[1])
    return lo if bool(ja._bern(k1, 0.5)) and gamma_range[0] < 1 else hi


def _lowres_draw(key, c, cfg):
    levels, gates = [], []
    for k in jax.random.split(key, c):
        k1, k2 = jax.random.split(k)
        levels.append(int(jax.random.randint(k1, (), 0, cfg.lowres_levels)))
        gates.append(bool(ja._bern(k2, cfg.p_lowres_per_channel)))
    return torch.tensor([levels]), torch.tensor([gates])


def jax_spatial_draw(key, h, w, cfg) -> dict:
    keys = jax.random.split(key, 12)
    coords, flip_y, flip_x = ja._spatial_draw(key, h, w, cfg)
    do_rot = bool(ja._bern(keys[0], cfg.p_rotation))
    do_scale = bool(ja._bern(keys[2], cfg.p_scale))
    do_trans = cfg.p_translate > 0 and bool(ja._bern(keys[4], cfg.p_translate))
    r = float(cfg.translate_range)
    angle = float(jax.random.uniform(keys[1], minval=-1.0, maxval=1.0) *
                  jnp.deg2rad(cfg.max_rotation)) if do_rot else 0.0
    draw = {"angle": _t([angle]),
            "scale": _t([_u(keys[3], *cfg.scale_range) if do_scale else 1.0]),
            "ty": _t([_u(keys[5], -r, r) if do_trans else 0.0]),
            "tx": _t([_u(keys[6], -r, r) if do_trans else 0.0]),
            "flip_y": torch.tensor([bool(flip_y)]), "flip_x": torch.tensor([bool(flip_x)])}
    if cfg.p_elastic > 0:
        k_sig, k_field = jax.random.split(keys[11])
        noise = jax.random.uniform(k_field, (h, w, 2), minval=-1.0, maxval=1.0)
        draw.update(elastic=_t([float(ja._bern(keys[9], cfg.p_elastic))]),
                    elastic_alpha=_t([_u(keys[10], *cfg.elastic_alpha)]),
                    elastic_sigma=_t([_u(k_sig, *cfg.elastic_sigma)]), elastic_noise=_chw(noise))
    return draw, np.asarray(coords)


def jax_intensity_draw(key, shape_hwc, cfg) -> dict:
    gates, draws = [], []
    for k in jax.random.split(key, 10):
        g, d = jax.random.split(k)
        gates.append(g)
        draws.append(d)
    gate = lambda i, p: torch.tensor([bool(ja._bern(gates[i], p))])  # noqa: E731
    k_sigma, k_field = jax.random.split(draws[0])
    out = {"noise": gate(0, cfg.p_noise),
           "noise_sigma": _t([float(jax.random.uniform(k_sigma, maxval=cfg.noise_max_sigma))]),
           "noise_field": _chw(jax.random.normal(k_field, shape_hwc)),
           "blur": gate(1, cfg.p_blur), "blur_sigma": _t([_u(draws[1], *cfg.blur_sigma)]),
           "brightness": gate(2, cfg.p_brightness),
           "brightness_factor": _t([_u(draws[2], *cfg.brightness_range)]),
           "contrast": gate(3, cfg.p_contrast),
           "contrast_factor": _t([_u(draws[3], *cfg.contrast_range)]),
           "gamma": gate(6, cfg.p_gamma), "gamma_value": _t([_gamma_draw(draws[6],
                                                                         cfg.gamma_range)])}
    if cfg.p_lowres > 0:
        out["lowres"] = gate(4, cfg.p_lowres)
        out["lowres_level"], out["lowres_channel"] = _lowres_draw(draws[4], shape_hwc[-1], cfg)
    if cfg.p_inverted_gamma > 0:
        out["inverted_gamma"] = gate(5, cfg.p_inverted_gamma)
        out["inverted_gamma_value"] = _t([_gamma_draw(draws[5], cfg.gamma_range)])
    if cfg.p_rician > 0:
        k1, k2, k3 = jax.random.split(draws[7], 3)
        out["rician"] = gate(7, cfg.p_rician)
        out["rician_std"] = _t([float(jax.random.uniform(k1, maxval=cfg.rician_std))])
        out["rician_fields"] = torch.stack([_chw(jax.random.normal(k, shape_hwc))
                                            for k in (k2, k3)])
    if cfg.p_gibbs > 0:
        out["gibbs"] = gate(8, cfg.p_gibbs)
        out["gibbs_alpha"] = _t([_u(draws[8], *cfg.gibbs_alpha)])
    if cfg.p_sharpen > 0:
        k1, k2, k3 = jax.random.split(draws[9], 3)
        out.update(sharpen=gate(9, cfg.p_sharpen),
                   sharpen_sigma1=_t([_u(k1, *cfg.sharpen_sigma1)]),
                   sharpen_sigma2=_t([_u(k2, *cfg.sharpen_sigma2)]),
                   sharpen_alpha=_t([_u(k3, *cfg.sharpen_alpha)]))
    return out


# --------------------------------------------------------------------------
# each transform given the JAX draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("size,out", [((40, 36), (20, 18)), ((40, 36), (23, 31)),
                                      ((17, 9), (40, 36)), ((12, 12), (12, 5)),
                                      ((5, 7), (1, 1))])
def test_resize_nearest_exact_and_keys_cubic(size, out):
    x = np.random.RandomState(1).randn(3, *size).astype(np.float32)
    ref = jax.vmap(lambda p: jax.image.resize(p, out, "nearest"))(jnp.asarray(x))
    np.testing.assert_array_equal(ta.resize_nearest(_t(x), out).numpy(), np.asarray(ref))
    ref = jax.vmap(lambda p: jax.image.resize(p, out, "cubic"))(jnp.asarray(x))
    _close(ta.resize_cubic(_t(x), out).numpy(), ref)
    # torch's own modes are other functions: nearest-exact is JAX's nearest,
    # its bicubic (a = -0.75) is not JAX's cubic (a = -0.5)
    near = torch.nn.functional.interpolate(_t(x)[None], size=out, mode="nearest-exact")[0]
    np.testing.assert_array_equal(near.numpy(), ta.resize_nearest(_t(x), out).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_low_resolution(seed):
    cfg = dataclasses.replace(ja.AugmentConfig(), p_lowres_per_channel=0.6)
    img, key = _image(seed, c=4), jax.random.PRNGKey(seed)
    ref = ja.simulate_low_resolution(key, img, cfg.lowres_zoom, cfg.p_lowres_per_channel,
                                     cfg.lowres_levels)
    level, gate = _lowres_draw(key, 4, cfg)
    got = ta.lowres_apply(_chw(img), level, gate, cfg.lowres_zoom, cfg.lowres_levels)
    _close(_hwc(got), ref)


@pytest.mark.parametrize("h,w,sigma", [(40, 36, 9.5), (64, 48, 13.0), (24, 30, 11.0)])
def test_elastic_offset(h, w, sigma):
    key = jax.random.PRNGKey(3)
    ref = ja._elastic_offset(key, h, w, 150.0, sigma)
    noise = jax.random.uniform(key, (h, w, 2), minval=-1.0, maxval=1.0)
    got = ta.elastic_offset(_chw(noise), _t([150.0]), _t([sigma]))[0]
    _close(got.numpy(), ref)


@pytest.mark.parametrize("sigma", [0.5, 0.77, 1.0, 1e-4])
def test_separable_blur(sigma):
    img = _image(4)
    _close(_hwc(ta.separable_blur(_chw(img), _t([sigma]))), ja._separable_blur(img, sigma))


@pytest.mark.parametrize("seed", [0, 1])
def test_gibbs_rician_and_sharpen(seed):
    img, cfg = _image(seed, c=3), ta.video_augment_config()
    k = jax.random.PRNGKey(10 + seed)
    ref = ja.gibbs_artifact(k, img, cfg.gibbs_alpha)
    _close(_hwc(ta.gibbs_apply(_chw(img), _t([_u(k, *cfg.gibbs_alpha)]))), ref, FFT_TOL)

    ref = ja.rician_noise(k, img, cfg.rician_std)
    k1, k2, k3 = jax.random.split(k, 3)
    std = _t([float(jax.random.uniform(k1, maxval=cfg.rician_std))])
    fields = torch.stack([_chw(jax.random.normal(kk, img.shape)) for kk in (k2, k3)])
    _close(_hwc(ta.rician_apply(_chw(img), std, fields)), ref)

    ref = ja.gaussian_sharpen(k, img, cfg.sharpen_sigma1, cfg.sharpen_sigma2, cfg.sharpen_alpha)
    s1, s2, a = (_t([_u(kk, *r)]) for kk, r in zip(
        jax.random.split(k, 3), (cfg.sharpen_sigma1, cfg.sharpen_sigma2, cfg.sharpen_alpha)))
    _close(_hwc(ta.sharpen_apply(_chw(img), s1, s2, a)), ref)


@pytest.mark.parametrize("invert,retain", [(False, True), (True, True), (False, False)])
def test_gamma(invert, retain):
    img = _image(5)
    for seed in range(4):  # both sides of the bimodal draw
        k = jax.random.PRNGKey(20 + seed)
        ref = ja.gamma_transform(k, img, (0.7, 1.5), invert, retain)
        got = ta.gamma_apply(_chw(img), _t([_gamma_draw(k, (0.7, 1.5))]), invert, retain)
        _close(_hwc(got), ref)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_matches_jax(mode, padding):
    rng = np.random.RandomState(6)
    img = rng.randn(20, 24, 3).astype(np.float32)
    coords = (rng.rand(18, 22, 2) * [26, 30] - [3, 3]).astype(np.float32)
    coords[0, :4] = [[2.5, 3.5], [3.5, 2.5], [-0.5, 0.0], [19.5, 23.5]]  # ties and edges
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords), mode=mode, padding=padding)
    got = grid_sample(_chw(img), _t(coords)[None], mode=mode, padding=padding)
    _close(_hwc(got), ref)


# --------------------------------------------------------------------------
# the whole pipelines given the JAX draws
# --------------------------------------------------------------------------

ALL_ON = dataclasses.replace(
    ta.video_augment_config(), p_rotation=1.0, p_scale=1.0, p_mirror=1.0, p_translate=1.0,
    p_elastic=1.0, p_noise=1.0, p_blur=1.0, p_brightness=1.0, p_contrast=1.0, p_gamma=1.0,
    p_inverted_gamma=1.0, p_lowres=1.0, p_rician=1.0, p_gibbs=1.0, p_sharpen=1.0,
    gamma_retain_stats=True)
CONFIGS = {"v2": ta.AugmentConfig(), "base": ta.default_augment_config(),
           "video": ta.video_augment_config(), "clip": ta.clip_augment_config(), "all": ALL_ON}


def _jax_cfg(cfg: ta.AugmentConfig) -> ja.AugmentConfig:
    return ja.AugmentConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_sample_2d_given_the_jax_draws(name, seed):
    cfg = CONFIGS[name]
    jcfg = _jax_cfg(cfg)
    img = _image(seed, h=48, w=40, c=1)
    seg = (img[..., 0] > 1).astype(np.int32) + (img[..., 0] > 2)
    key = jax.random.PRNGKey(100 + seed)
    ref_img, ref_seg = ja.augment_sample_2d(key, jnp.asarray(img), jnp.asarray(seg), jcfg)
    k_spatial, k_pixel = jax.random.split(key)
    spatial, jcoords = jax_spatial_draw(k_spatial, 48, 40, jcfg)
    np.testing.assert_allclose(ta.spatial_coords(spatial, 48, 40)[0].numpy(), jcoords,
                               atol=1e-4, rtol=0)
    intensity = jax_intensity_draw(k_pixel, img.shape, jcfg)
    got_img, got_seg = ta.apply_augment(_chw(img), torch.from_numpy(seg)[None, None], spatial,
                                        intensity, cfg)
    np.testing.assert_array_equal(got_seg[0, 0].numpy(), np.asarray(ref_seg))
    _close(_hwc(got_img), ref_img, FFT_TOL if cfg.p_gibbs else TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_augment_video_given_the_jax_draws(seed):
    t, h, w = 4, 32, 36
    rng = np.random.RandomState(seed)
    video = rng.rand(t, h, w, 1).astype(np.float32)
    seg = rng.randint(0, 4, (t, h, w)).astype(np.int32)
    seg[1] = -1
    key = jax.random.PRNGKey(200 + seed)
    jcfg = _jax_cfg(ta.clip_augment_config())
    ref_v, ref_s = ja.augment_video(key, jnp.asarray(video), jnp.asarray(seg))
    k_spatial, k_pixel = jax.random.split(key)
    spatial, _ = jax_spatial_draw(k_spatial, h, w, jcfg)
    stacked = np.moveaxis(video, 0, -1).reshape(h, w, t)  # the JAX clip stack
    intensity = jax_intensity_draw(k_pixel, stacked.shape, jcfg)
    img, seg_out = ta.apply_augment(_t(video).permute(3, 0, 1, 2).reshape(1, t, h, w),
                                    torch.from_numpy(seg)[None], spatial, intensity,
                                    ta.clip_augment_config())
    np.testing.assert_array_equal(seg_out[0].numpy(), np.asarray(ref_s))
    _close(img[0].numpy(), np.asarray(ref_v)[..., 0], FFT_TOL)


# --------------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------------


def test_gate_rates_lie_within_four_sigma():
    n = 2000
    for cfg in (ta.AugmentConfig(), ta.default_augment_config(), ta.video_augment_config()):
        gen = ta.step_generator(0, 0, "cpu")
        spatial = ta.draw_spatial(gen, n, 8, 8, cfg)
        intensity = ta.draw_intensity(gen, (n, 2, 8, 8), cfg)
        rates = {"flip_y": (spatial["flip_y"], cfg.p_mirror),
                 "flip_x": (spatial["flip_x"], cfg.p_mirror),
                 "rotation": (spatial["angle"] != 0, cfg.p_rotation),
                 "scale": (spatial["scale"] != 1, cfg.p_scale),
                 "translate": (spatial["ty"] != 0, cfg.p_translate)}
        if cfg.p_elastic:
            rates["elastic"] = (spatial["elastic"] > 0, cfg.p_elastic)
        for name in ("noise", "blur", "brightness", "contrast", "gamma", "lowres",
                     "inverted_gamma", "rician", "gibbs", "sharpen"):
            p = getattr(cfg, f"p_{name}")
            if name in intensity:
                rates[name] = (intensity[name], p)
            else:
                assert p == 0, name
        if "lowres_channel" in intensity:
            rates["lowres_channel"] = (intensity["lowres_channel"].flatten(),
                                       cfg.p_lowres_per_channel)
        for name, (fired, p) in rates.items():
            m = fired.numel()
            sigma = np.sqrt(p * (1 - p) / m)
            assert abs(fired.float().mean().item() - p) <= 4 * sigma + 1e-12, name
    low = intensity["gamma_value"][intensity["gamma_value"] < 1]
    assert 0.35 < low.numel() / n < 0.65  # the bimodal gamma draw


def test_the_same_seed_and_step_give_the_same_bits():
    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randn(3, 1, 40, 36).astype(np.float32))
    segs = torch.from_numpy(rng.randint(0, 3, (3, 40, 36)))
    runs = [ta.augment_batch_2d(ta.step_generator(12345, 9, "cpu"), images, segs,
                                ta.default_augment_config()) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    other = ta.augment_batch_2d(ta.step_generator(12345, 10, "cpu"), images, segs,
                                ta.default_augment_config())
    assert not torch.equal(other[0], runs[0][0])
    video = torch.from_numpy(rng.rand(2, 3, 32, 32, 1).astype(np.float32))
    vseg = torch.from_numpy(rng.randint(-1, 4, (2, 3, 32, 32)))
    a, b = (ta.augment_video(ta.step_generator(1, 4, "cpu"), video, vseg) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_the_trainer_augments_train_steps_only(tmp_path, monkeypatch):
    from csof_tpu_torch.config import experiment as texp
    from csof_tpu_torch.training.trainer import Trainer

    seen = []
    cfg = texp.ExperimentConfig(
        model="segflow", segflow=texp.SegFlowModelConfig(
            out_encoder_dims=(8, 16), d_model=16, bottleneck_heads=2, dim_feedforward=32,
            corr_radius=(2, 2), corr_stride=(1, 1), dtype="float32"))
    assert cfg.data.do_data_aug
    tr = Trainer(cfg, tmp_path, device="cpu").initialize()
    real = tr.augment

    def spy(batch, rows=None):
        out = real(batch, rows)
        seen.append(out)
        return out

    monkeypatch.setattr(tr, "augment", spy)
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 4, (2, 3, 16, 16)).astype(np.int32)
    seg[:, 1] = -1
    batch = {"video": rng.rand(2, 3, 16, 16, 1).astype(np.float32), "seg": seg,
             "labeled_mask": np.array([[1, 0, 1], [1, 0, 1]], np.float32)}
    tr.run_iteration(batch, train=False)
    assert not seen
    tr.run_iteration(batch)
    assert len(seen) == 1
    assert (seen[0]["seg"][:, 1] == -1).all()  # the unlabelled frame stays unlabelled
    assert seen[0]["video"].shape == (2, 3, 16, 16, 1)
