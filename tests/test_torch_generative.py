"""The port's generative family against the JAX package's, on the CPU: the
diffusion schedule and time embedding, the denoiser U-Net, DDPM's loss and
ancestral sampling, the KL autoencoder, latent diffusion (its train step and
sampling), the ControlNet (the hint's antialiased resize, the zero-init
no-op, the parameter labels, its optimizer and train step), the VQ-VAE (the
codes exactly), the patch discriminator and the GAN losses, and the Swin GAN
(the stem's (0, 1) pad, both steps). The same parameters (a flax tree drawn
from a numpy seed, carried over by ``load_flax_params``) and JAX's own draws
from the same key splits as the JAX functions (``t``, noise, the chain's
noises, the latent samples, ``z``). Then the kernel switch: under
``CSOF_CONV2D_IMPL=pallas`` the port calls kernel K6 (its plain version
on the CPU) where and as often as the JAX package calls its Pallas conv
(counted on a trace of JAX's forward), ``kernel_launches`` gives the count, and the gradients
under the switch equal JAX's with the switch off (JAX cannot differentiate
its Pallas conv outside a vmap, F8).

Tolerances (float32): outputs within 1e-5 of the largest magnitude (the
same sums in another order); the loss within 1e-5 relative; each gradient
within 1e-5 of the largest entry of its tree (the conv biases in front of a
group norm have an exact gradient of zero, rounding noise on both sides);
updates by plain SGD within 1e-6 absolute. DDPM's chain and latent diffusion's
samples within 1e-4 of the largest: each step divides by sqrt(alpha_t) and
carries the last step's rounding on. The Swin modules within 1e-4 (their
float32 softmax and GELU, as the port's Swin tests). VQ codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import torch_threads
from flax import linen as jax_nn
from test_torch_finalflow import _counting
from test_torch_raft import random_params

import csof_tpu.ops.pallas.conv as jconv
from csof_tpu.models import diffusion as jdiff
from csof_tpu.models import discriminator as jdisc
from csof_tpu.models import generative as jgen
from csof_tpu.models import vqvae as jvq
from csof_tpu.training import generative as jtrain
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays, load_flax_params
from csof_tpu_torch.models import blocks, diffusion, discriminator, generative, vqvae
from csof_tpu_torch.training import generative as ttrain

torch_threads.pin()

TOL = 1e-5
CHAIN_TOL = 1e-4
SWIN_TOL = 1e-4
CFG = dict(timesteps=10, features=(8, 16), time_dim=16)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * float(np.abs(ref).max()))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _grads_close(model, grads, jax_grads, tol=TOL):
    """Each port gradient within tol of the largest entry of JAX's tree."""
    want = flax_to_torch_arrays(model, jax.tree_util.tree_map(np.asarray, jax_grads))
    top = max(float(np.abs(g).max()) for g in want.values())
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.detach().numpy(), want[name], rtol=0, atol=tol * top,
                                   err_msg=name)


def _images(seed, n=2, hw=16, c=1):
    return np.random.RandomState(seed).rand(n, hw, hw, c).astype(np.float32)


def _ddpm_draws(key, x0, timesteps):
    """JAX's DDPM.loss draws (diffusion.py:94-96)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (x0.shape[0],), 0, timesteps)),
            np.asarray(jax.random.normal(k2, x0.shape)))


def _chain_draws(key, shape, steps):
    """JAX's DDPM.sample draws: the first x, then each step's unit normal."""
    k0, kinit = jax.random.split(key)
    x = np.asarray(jax.random.normal(kinit, shape))
    noises, k = [], k0
    for _ in range(steps):
        k, ksub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(ksub, shape)))
    return x, noises


def test_schedule_embedding_and_timesteps_match_jax():
    for t in (10, 1000):
        jd = jdiff.DDPM(None, jdiff.DiffusionConfig(timesteps=t))
        td = diffusion.DDPM(None, diffusion.DiffusionConfig(timesteps=t))
        np.testing.assert_array_equal(td.betas.numpy(), np.asarray(jd.betas))
        np.testing.assert_array_equal(td.alphas.numpy(), np.asarray(jd.alphas))
        _close(td.alpha_bars, jd.alpha_bars, 1e-6)  # XLA's cumprod sums in another order
        for steps in (1, 2, 3, 7, 10) + ((28, 38, 49, 50, 51, 55, 333, 354) if t == 1000 else ()):
            want = np.asarray(jnp.linspace(t - 1, 0, steps).astype(jnp.int32)).tolist()
            assert diffusion.sampling_timesteps(t, steps) == want, (t, steps)
    steps = np.array([0, 1, 17, 500, 999])
    for dim in (16, 64):
        got = diffusion.time_embedding(_t(steps, torch.int64), dim).numpy()
        ang = steps[:, None].astype(np.float32) * diffusion._freqs(dim, torch.device("cpu")).numpy()
        exact = np.concatenate([np.sin(ang.astype(np.float64)), np.cos(ang.astype(np.float64))], -1)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
        # XLA's float32 sine is up to 1.5e-5 off near 1000 rad (against float64)
        np.testing.assert_allclose(got, np.asarray(jdiff.time_embedding(jnp.asarray(steps), dim)),
                                   rtol=0, atol=2e-5)


def _denoiser(cond_channels=0, seed=0, hw=16):
    cfg = dict(CFG, cond_channels=cond_channels)
    jm = jdiff.DenoiserUNet(jdiff.DiffusionConfig(**cfg))
    x = _images(seed, hw=hw)
    cond = _images(seed + 1, hw=hw, c=cond_channels) if cond_channels else None
    t = np.array([3, 8])
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(cond),) if cond_channels else ())
    params = random_params(jm, *args, seed=seed)
    tm = diffusion.DenoiserUNet(diffusion.DiffusionConfig(**cfg))
    load_flax_params(tm, params)
    return jm, tm, params, x, t, cond


@pytest.mark.parametrize("cond_channels", [0, 4])
def test_denoiser_matches_jax(cond_channels):
    jm, tm, params, x, t, cond = _denoiser(cond_channels, seed=cond_channels)
    ref = jm.apply({"params": params}, x, t, cond)
    with torch.no_grad():
        out = tm(_t(x), _t(t, torch.int64), None if cond is None else _t(cond))
    _close(out, ref)


def test_ddpm_loss_gradients_and_chain_match_jax():
    jm, tm, params, x, _, _ = _denoiser(0, seed=3)
    cfg = jdiff.DiffusionConfig(**CFG)
    jd, td = jdiff.DDPM(jm, cfg), diffusion.DDPM(tm, diffusion.DiffusionConfig(**CFG))
    key = jax.random.PRNGKey(5)
    t, noise = _ddpm_draws(key, x, cfg.timesteps)
    ref, jgrads = jax.jit(jax.value_and_grad(lambda p: jd.loss({"params": p}, key, x)))(params)
    loss = td.loss(_t(x), t=_t(t, torch.int64), noise=_t(noise))
    loss.backward()
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    _grads_close(tm, {n: p.grad for n, p in tm.named_parameters()}, jgrads)

    shape = (2, 16, 16, 1)
    key = jax.random.PRNGKey(6)
    want = jd.sample({"params": params}, key, shape, steps=7)
    x0, noises = _chain_draws(key, shape, 7)
    got = td.sample(shape, steps=7, x=_t(x0), noises=[_t(z) for z in noises])
    _close(got, want, CHAIN_TOL)


def _ae(seed=0, hw=16):
    jm = jgen.KLAutoencoder(features=(8, 16), latent_dim=4)
    x = _images(seed, hw=hw)
    params = random_params(jm, jnp.asarray(x), jax.random.PRNGKey(1), seed=seed)
    tm = generative.KLAutoencoder(features=(8, 16), latent_dim=4)
    load_flax_params(tm, params)
    return jm, tm, params, x


def test_kl_autoencoder_matches_jax():
    jm, tm, params, x = _ae(seed=7)
    rng = jax.random.PRNGKey(2)
    ref = jm.apply({"params": params}, x, rng)
    eps = jax.random.normal(rng, ref["mu"].shape)
    with torch.no_grad():
        out = tm(_t(x), eps=_t(eps))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k])


def test_latent_diffusion_step_and_sample_match_jax():
    jae, tae, ae_params, x = _ae(seed=8)
    cfg = dict(CFG, channels=4)
    jldm = jgen.LatentDiffusion(jae, jdiff.DiffusionConfig(**cfg), scaling_factor=0.5)
    tldm = generative.LatentDiffusion(tae, diffusion.DiffusionConfig(**cfg), scaling_factor=0.5)
    latents = jldm.encode_latents({"params": ae_params}, jax.random.PRNGKey(0), x)
    dparams = random_params(jldm.denoiser, latents, jnp.zeros((2,), jnp.int32), seed=9)
    load_flax_params(tldm.denoiser, dparams)

    key = jax.random.PRNGKey(10)
    k_enc, k_ddpm = jax.random.split(key)
    eps = jax.random.normal(k_enc, latents.shape)
    t, noise = _ddpm_draws(k_ddpm, latents, cfg["timesteps"])
    tx = optax.sgd(1.0)  # the update is minus the gradient: both are held at once
    new, _, ref = jtrain.make_ldm_train_step(jldm, tx)(
        {"params": dparams}, tx.init({"params": dparams}), {"params": ae_params}, key, x)
    step = ttrain.make_ldm_train_step(tldm, torch.optim.SGD(tldm.denoiser.parameters(), lr=1.0))
    loss = step(_t(x), eps=_t(eps), t=_t(t, torch.int64), noise=_t(noise))
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), dparams,
                                    new["params"])
    _grads_close(tldm.denoiser, {n: p.grad for n, p in tldm.denoiser.named_parameters()}, jgrads)
    want = flax_to_torch_arrays(tldm.denoiser, jax.tree_util.tree_map(np.asarray,
                                                                     new["params"]))
    for n, p in tldm.denoiser.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)
    assert all(p.grad is None for p in tae.parameters())  # the autoencoder is frozen

    shape = (1, 4, 4, 4)
    key = jax.random.PRNGKey(11)
    img = jldm.sample(new, {"params": ae_params}, key, shape, steps=3)
    x0, noises = _chain_draws(key, shape, 3)
    got = tldm.sample(shape, steps=3, x=_t(x0), noises=[_t(z) for z in noises])
    assert got.shape == (1, 16, 16, 1)
    _close(got, img, CHAIN_TOL)


def _controlnet(seed, hw=16, hint_hw=16, hint_channels=2):
    cfg = jdiff.DiffusionConfig(**CFG)
    jm = jgen.ControlledDenoiserUNet(cfg)
    x = _images(seed, hw=hw)
    hint = _images(seed + 1, hw=hint_hw, c=hint_channels)
    t = np.array([2, 9])
    params = random_params(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint), seed=seed)
    tm = generative.ControlledDenoiserUNet(diffusion.DiffusionConfig(**CFG), hint_channels)
    load_flax_params(tm, params)
    return jm, tm, params, x, t, hint


@pytest.mark.parametrize("hint_hw", [16, 32])
def test_controlled_denoiser_matches_jax(hint_hw):
    """A 32^2 hint for 16^2 inputs takes JAX's antialiased linear resize."""
    jm, tm, params, x, t, hint = _controlnet(12 + hint_hw, hint_hw=hint_hw)
    ref = jm.apply({"params": params}, x, t, hint)
    with torch.no_grad():
        out = tm(_t(x), _t(t, torch.int64), _t(hint))
    _close(out, ref)


@pytest.mark.parametrize("out_hw", [32, 64])
def test_hint_resize_is_jax_antialiased_linear(out_hw):
    """Trap 2: jax.image.resize(..., "linear") antialiases when it shrinks;
    torch's bilinear without antialias is far off."""
    hint = np.random.RandomState(out_hw).rand(2, 128, 128, 4).astype(np.float32)
    want = np.asarray(jax.image.resize(hint, (2, out_hw, out_hw, 4), "linear"))
    nchw = _t(hint).movedim(-1, 1)
    got = F.interpolate(nchw, size=(out_hw, out_hw), mode="bilinear", align_corners=False,
                        antialias=True).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = F.interpolate(nchw, size=(out_hw, out_hw), mode="bilinear",
                          align_corners=False).movedim(1, -1)
    assert float(np.abs(plain.numpy() - want).max()) > 0.1


def test_controlnet_zero_init_is_a_no_op_bit_for_bit_and_labels_match_jax():
    model = generative.ControlledDenoiserUNet(diffusion.DiffusionConfig(**CFG), 2,
                                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # a base that is not at its own init, as a pretrained one
        model.base_out.weight.normal_(generator=torch.Generator().manual_seed(1))
    x, hint = _t(_images(20)), _t(_images(21, c=2))
    t = torch.tensor([1, 7])
    with torch.no_grad():
        assert torch.equal(model(x, t, hint), model(x, t, torch.zeros_like(hint)))
    jm, tm, params, *_ = _controlnet(22)
    want = {path[0].key: label for path, label in
            jax.tree_util.tree_leaves_with_path(jgen.controlnet_param_labels(params))}
    labels = generative.controlnet_param_labels(tm)
    assert {n.split(".")[0]: lab for n, lab in labels.items()} == want
    assert set(labels.values()) == {"control", "frozen"}


def test_controlnet_step_matches_jax_and_keeps_the_base():
    jm, tm, params, x, _, hint = _controlnet(30)
    cfg = jdiff.DiffusionConfig(**CFG)
    jd, td = jdiff.DDPM(jm, cfg), diffusion.DDPM(tm, diffusion.DiffusionConfig(**CFG))
    key = jax.random.PRNGKey(31)
    t, noise = _ddpm_draws(key, x, cfg.timesteps)
    loss_fn = jgen.controlnet_loss(jm, jd)
    ref, jgrads = jax.value_and_grad(lambda p: loss_fn({"params": p}, key, x, hint))(params)
    tx, opt_state = jtrain.make_controlnet_optimizer({"params": params})
    new, _, _ = jtrain.make_controlnet_train_step(jm, jd, tx)({"params": params}, opt_state,
                                                              key, x, hint)
    opt = ttrain.make_controlnet_optimizer(tm)
    step = ttrain.make_controlnet_train_step(tm, td, opt)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    loss = step(_t(x), _t(hint), t=_t(t, torch.int64), noise=_t(noise))
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    labels = generative.controlnet_param_labels(tm)
    control = {n for n, lab in labels.items() if lab == "control"}
    jcontrol = jax.tree_util.tree_map(np.asarray, jgrads)
    want_g = flax_to_torch_arrays(tm, jcontrol)
    top = max(float(np.abs(want_g[n]).max()) for n in control)
    want = flax_to_torch_arrays(tm, jax.tree_util.tree_map(np.asarray, new["params"]))
    lr = 1e-4
    for n, p in tm.named_parameters():
        if n not in control:
            assert torch.equal(p, before[n]), n  # the base never moves, bit for bit
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[n], rtol=0, atol=TOL * top, err_msg=n)
        if np.abs(want_g[n]).max() > 1e-3 * top:  # AdamW's first step is lr x sign(g)
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-7,
                                       err_msg=n)
        else:  # a zero gradient in exact arithmetic: its sign is rounding on either side
            assert float((p - before[n]).abs().max()) <= lr * (1 + 1e-4 * float(
                before[n].abs().max())) * 1.0001, n


def test_controlnet_optimizer_clips_the_control_gradients_alone_and_decays_by_1e_4():
    """Trap 3: optax's multi_transform clips the control gradients by their
    own global norm (12) and runs optax.adamw, whose weight decay is 1e-4
    (torch's AdamW default is 1e-2). Both optimizers take the same large
    gradients (the base's larger still: they would move the clip), then a
    zero gradient at lr 0.5, where only the decay moves a parameter."""
    jm, tm, params, *_ = _controlnet(40)
    rng = np.random.RandomState(41)
    jgrads = jax.tree_util.tree_map(lambda p: (rng.randn(*p.shape) * 50).astype(np.float32),
                                    params)
    for lr, scale in ((1e-4, 1.0), (0.5, 0.0)):
        tm2 = generative.ControlledDenoiserUNet(diffusion.DiffusionConfig(**CFG), 2)
        load_flax_params(tm2, params)
        grads = jax.tree_util.tree_map(lambda g: g * scale, jgrads)
        tx, state = jtrain.make_controlnet_optimizer({"params": params}, lr=lr)
        upd, _ = tx.update({"params": grads}, state, {"params": params})
        want = flax_to_torch_arrays(tm2, jax.tree_util.tree_map(
            np.asarray, optax.apply_updates({"params": params}, upd)["params"]))
        opt = ttrain.make_controlnet_optimizer(tm2, lr=lr)
        g = flax_to_torch_arrays(tm2, grads)
        for n, p in tm2.named_parameters():
            p.grad = _t(g[n])
        opt.step()
        for n, p in tm2.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=2e-6, atol=1e-9,
                                       err_msg=f"lr {lr}: {n}")
    decayed = generative.controlnet_param_labels(tm2)
    assert any(lab == "control" for lab in decayed.values())


def _vq(seed=0, hw=16):
    jm = jvq.VQVAE(features=(8, 16), num_embeddings=32, embedding_dim=8)
    x = _images(seed, hw=hw)
    params = random_params(jm, jnp.asarray(x), seed=seed)
    tm = vqvae.VQVAE(features=(8, 16), num_embeddings=32, embedding_dim=8)
    load_flax_params(tm, params)
    return jm, tm, params, x


def test_vqvae_matches_jax_codes_exactly_and_its_loss_gradients():
    jm, tm, params, x = _vq(50)

    def jloss(p):
        out = jm.apply({"params": p}, x)
        return (jnp.mean((out["reconstruction"] - x) ** 2) + out["codebook_loss"]
                + out["commitment_loss"]), out

    (ref, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = tm(_t(x))
    assert len(np.unique(np.asarray(jout["codes"]))) > 3
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(jout["codes"]))
    for k in ("reconstruction", "codebook_loss", "commitment_loss"):
        _close(out[k], jout[k])
    loss = (out["reconstruction"] - _t(x)).square().mean() + out["codebook_loss"] \
        + out["commitment_loss"]
    loss.backward()
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    _grads_close(tm, {n: p.grad for n, p in tm.named_parameters()}, jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_discriminator_and_gan_losses_match_jax(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jm = jdisc.PatchDiscriminator(features=(8, 16), dtype=jdt)
    x = _images(60, hw=16, c=2)
    params = random_params(jm, jnp.asarray(x), seed=60)
    tm = discriminator.PatchDiscriminator(2, features=(8, 16), dtype=getattr(torch, dtype))
    load_flax_params(tm, params)
    ref = jm.apply({"params": params}, x)
    with torch.no_grad():
        out = tm(_t(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref, TOL if dtype == "float32" else 5e-2)
    real, fake = out, out.flip(0) * 0.5
    jr, jf = jnp.asarray(real.numpy()), jnp.asarray(fake.numpy())
    _close(discriminator.discriminator_loss(real, fake), jdisc.discriminator_loss(jr, jf), 1e-6)
    _close(discriminator.generator_adversarial_loss(fake),
           jdisc.generator_adversarial_loss(jf), 1e-6)


def test_swin_discriminator_stem_pads_zero_then_one():
    """Trap 1: flax's stride-2 SAME 3x3 conv pads (0, 1) on an even input:
    output pixel (0, 0) takes tap (0, 0) at input pixel (0, 0)."""
    x = np.zeros((1, 8, 8, 1), np.float32)
    x[0, 0, 0, 0] = 1.0
    disc = generative.SwinDiscriminator(features=(4, 8), num_heads=2, window=2)
    stem = disc.Conv_0
    with torch.no_grad():
        stem.weight.copy_(torch.arange(36.0).view(4, 1, 3, 3))
        stem.bias.zero_()
        out = stem(_t(x).movedim(-1, 1))
        torch_pad1 = F.conv2d(_t(x).movedim(-1, 1), stem.weight, stride=2, padding=1)
    assert out[0, :, 0, 0].tolist() == stem.weight[:, 0, 0, 0].tolist()
    assert torch_pad1[0, :, 0, 0].tolist() == stem.weight[:, 0, 1, 1].tolist()
    kern = np.transpose(stem.weight.detach().numpy(), (2, 3, 1, 0))
    want = jax.lax.conv_general_dilated(x, kern, (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(out.movedim(1, -1).numpy(), np.asarray(want))


SWIN_G = dict(features=(8,), base_hw=4, num_heads=2, window=4)
SWIN_D = dict(features=(8, 16), num_heads=2, window=2)


def test_swin_gan_forwards_match_jax():
    """The generator's 8^2 images and the discriminator's logits (its stem,
    a stage, a patch merging and a second stage), z drawn as JAX's GAN
    steps draw it."""
    jg, jd = jgen.SwinGenerator(**SWIN_G), jgen.SwinDiscriminator(**SWIN_D)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(72), (2, jg.features[0])))
    gp = random_params(jg, jnp.asarray(z), seed=70)
    real = _images(71, hw=8)
    dp = random_params(jd, jnp.asarray(real), seed=71)
    tg, td = generative.SwinGenerator(**SWIN_G), generative.SwinDiscriminator(**SWIN_D)
    load_flax_params(tg, gp)
    load_flax_params(td, dp)
    with torch.no_grad():
        _close(tg(_t(z)), jg.apply({"params": gp}, z), SWIN_TOL)
        _close(td(_t(real)), jd.apply({"params": dp}, real), SWIN_TOL)


class _JaxTinyGenerator(jax_nn.Module):
    """A generator with the ``features`` the GAN steps read, cheap to
    compile (a jit of the Swin GAN step costs tens of seconds on a CPU)."""

    features: tuple = (8,)

    @jax_nn.compact
    def __call__(self, z):
        return jnp.tanh(jax_nn.Dense(8 * 8 * 2)(z).reshape(z.shape[0], 8, 8, 2))


class _TinyGenerator(torch.nn.Module):
    features = (8,)

    def __init__(self):
        super().__init__()
        self.Dense_0 = blocks.Dense(8, 8 * 8 * 2)

    def forward(self, z):
        return torch.tanh(self.Dense_0(z).reshape(z.shape[0], 8, 8, 2))


def test_gan_steps_match_jax():
    """JAX's make_gan_train_steps (jitted, plain SGD) and the port's on a
    tiny generator and a patch discriminator: the d_step (fakes detached,
    z drawn from the step's key), then the g_step (the generator alone
    moves); the losses and every updated parameter."""
    jg, jd = _JaxTinyGenerator(), jdisc.PatchDiscriminator(features=(8, 16))
    key_d, key_g = jax.random.PRNGKey(73), jax.random.PRNGKey(74)
    gp = random_params(jg, jnp.zeros((2, 8)), seed=73)
    real = _images(75, hw=8, c=2)
    dp = random_params(jd, jnp.asarray(real), seed=74)
    lr = 0.05
    tx = optax.sgd(lr)
    jd_step, jg_step = jtrain.make_gan_train_steps(jg, jd, tx, tx)
    dnew, _, d_ref = jd_step({"params": dp}, tx.init({"params": dp}), {"params": gp}, key_d, real)
    gnew, _, g_ref = jg_step({"params": gp}, tx.init({"params": gp}), dnew, key_g, 2)

    tg, td = _TinyGenerator(), discriminator.PatchDiscriminator(2, features=(8, 16))
    load_flax_params(tg, gp)
    load_flax_params(td, dp)
    d_step, g_step = ttrain.make_gan_train_steps(tg, td, torch.optim.SGD(tg.parameters(), lr=lr),
                                                 torch.optim.SGD(td.parameters(), lr=lr))
    d_loss = d_step(_t(real), z=_t(jax.random.normal(key_d, (2, 8))))
    assert all(p.grad is None for p in tg.parameters())  # the fakes are detached
    g_loss = g_step(2, z=_t(jax.random.normal(key_g, (2, 8))))
    for got, ref in ((d_loss, d_ref), (g_loss, g_ref)):
        assert abs(float(got) - float(ref)) <= TOL * abs(float(ref))
    for model, new in ((td, dnew), (tg, gnew)):
        want = flax_to_torch_arrays(model, jax.tree_util.tree_map(np.asarray, new["params"]))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6,
                                       err_msg=n)


def _count(monkeypatch):
    calls = {"jax": 0, "port": 0}
    for mod, name, key in ((jconv, "conv3x3_cols_vb", "jax"), (blocks, "conv3x3", "port")):
        monkeypatch.setattr(mod, name, _counting(calls, key, getattr(mod, name)))
    return calls


def test_k6_routes_as_jax_in_the_denoisers_autoencoder_and_vqvae(monkeypatch):
    """32-wide inputs, features (8, 16): the denoiser's 32-wide convs (its
    16-wide level does not route), the ControlNet's control and base convs
    at 32, the KL decoder's and the VQ-VAE decoder's 32-wide conv. JAX's
    Pallas calls are counted on a trace of its forward under the switch
    (``jax.eval_shape``: the count is the trace's; its interpret-mode run
    computes the same conv as XLA's); each port forward under the switch
    against JAX's, and the denoiser's gradients under the switch against
    JAX's with it off (F8)."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    cases = []
    jm, tm, params, x, t, _ = _denoiser(0, seed=80, hw=32)
    cases.append((jm, params, (x, t), tm, (_t(x), _t(t, torch.int64)), 3, None))
    cn = _controlnet(81, hw=32, hint_hw=64)
    cases.append((cn[0], cn[2], cn[3:], cn[1], (_t(cn[3]), _t(cn[4], torch.int64), _t(cn[5])),
                  4, None))
    jae, tae, ae_params, img = _ae(seed=82, hw=32)
    eps = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8, 4))
    cases.append((jae, ae_params, (img, jax.random.PRNGKey(0)), tae, (_t(img), None, _t(eps)), 1,
                  "reconstruction"))
    jv, tv, vparams, img = _vq(83, hw=32)
    cases.append((jv, vparams, (img,), tv, (_t(img),), 1, "reconstruction"))
    for jmod, jparams, jargs, tmod, targs, want, key in cases:
        calls = _count(monkeypatch)
        jax.eval_shape(lambda p: jmod.apply({"params": p}, *jargs), jparams)
        with torch.no_grad():
            out = tmod(*targs)
        assert calls["jax"] == calls["port"] == tmod.kernel_launches(32)["K6"] == want
        with monkeypatch.context() as m:
            m.setenv("CSOF_CONV2D_IMPL", "native")
            ref = jmod.apply({"params": jparams}, *jargs)
        _close(out if key is None else out[key], ref if key is None else ref[key])

    monkeypatch.setenv("CSOF_CONV2D_IMPL", "native")  # F8: JAX differentiates its plain conv
    jd = jdiff.DDPM(jm, jdiff.DiffusionConfig(**CFG))
    key = jax.random.PRNGKey(84)
    tt, noise = _ddpm_draws(key, x, CFG["timesteps"])
    ref, jgrads = jax.jit(jax.value_and_grad(lambda p: jd.loss({"params": p}, key, x)))(params)
    calls = _count(monkeypatch)
    loss = diffusion.DDPM(tm, diffusion.DiffusionConfig(**CFG)).loss(
        _t(x), t=_t(tt, torch.int64), noise=_t(noise))
    loss.backward()
    assert calls["port"] == 3
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    _grads_close(tm, {n: p.grad for n, p in tm.named_parameters()}, jgrads)
    assert tm.kernel_launches(32, backward=True) == {"K5": 0, "K6": 3, "K6_dx": 2, "K6_dw": 3}


def test_controlnet_step_differentiates_the_control_branch_alone(monkeypatch):
    """A ControlNet step at 32^2 under the switch: the base's parameters take
    no gradient, and K6 dx runs only where a control gradient needs it (the
    32-wide decoder conv; not the base's level-0 convs, which come before
    the first control joins the base), as kernel_launches counts; the loss
    and the control gradients equal the same step's with the switch off
    (held against JAX by test_controlnet_step_matches_jax_and_keeps_the_base)."""
    from csof_tpu_torch.ops.kernels import conv as k6

    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    _, tm, params, x, _, hint = _controlnet(86, hw=32, hint_hw=64)
    off = generative.ControlledDenoiserUNet(diffusion.DiffusionConfig(**CFG), 2,
                                            conv_impl="native")
    load_flax_params(off, params)
    rng = np.random.RandomState(87)
    t, noise = _t(rng.randint(0, CFG["timesteps"], 2), torch.int64), _t(rng.randn(*x.shape))
    dx = {"port": 0, "dw": 0}
    monkeypatch.setattr(k6, "conv3x3_dx_plain", _counting(dx, "port", k6.conv3x3_dx_plain))
    monkeypatch.setattr(k6, "conv3x3_dw_plain", _counting(dx, "dw", k6.conv3x3_dw_plain))
    losses = []
    for model in (tm, off):
        opt = torch.optim.SGD(ttrain.make_controlnet_optimizer(model).params, lr=0.0)
        step = ttrain.make_controlnet_train_step(
            model, diffusion.DDPM(model, diffusion.DiffusionConfig(**CFG)), opt)
        losses.append(float(step(_t(x), _t(hint), t=t, noise=noise)))
        if model is tm:
            assert dx["port"] == tm.kernel_launches(32, backward=True)["K6_dx"] == 1
            # K6 dw on the control conv alone: the base's weights are frozen
            assert dx["dw"] == tm.kernel_launches(32, backward=True)["K6_dw"] == 1
    assert abs(losses[0] - losses[1]) <= TOL * abs(losses[1])
    labels = generative.controlnet_param_labels(tm)
    top = max(float(p.grad.abs().max()) for n, p in off.named_parameters()
              if labels[n] == "control")
    for (n, p), q in zip(tm.named_parameters(), off.parameters()):
        if labels[n] == "frozen":
            assert p.grad is None and not p.requires_grad, n
        else:
            np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=0,
                                       atol=TOL * top, err_msg=n)


def test_kernel_launches_at_the_card_geometry():
    """The counts chip_smoke.py phase 34 holds the card to (DiffusionConfig()
    widths 32/64/128): the pixel denoiser at 128^2 routes levels 0 and 1
    and both decoder convs (5; its first conv takes the data: 4 dx); at the
    32^2 latents levels 0 and the last decoder conv (3; 2 dx); the KL
    decoder and the VQ-VAE decoder to 128^2 two each; the ControlNet at
    128^2 one control conv and five base convs (6; 3 dx: its step
    differentiates the control branch alone, and the base's level-0 convs
    come before the first control joins the base), on the 32^2 latents one
    control conv and three base convs (4; 1 dx). K6 dw: one a routed conv
    whose weight trains, so the ControlNet's control conv alone."""
    cfg = diffusion.DiffusionConfig()
    den = diffusion.DenoiserUNet(cfg, conv_impl="pallas")
    assert den.kernel_launches(128, backward=True) == {"K5": 0, "K6": 5, "K6_dx": 4, "K6_dw": 5}
    assert den.kernel_launches(32, backward=True) == {"K5": 0, "K6": 3, "K6_dx": 2, "K6_dw": 3}
    cond = diffusion.DenoiserUNet(diffusion.DiffusionConfig(cond_channels=4), conv_impl="pallas")
    assert cond.kernel_launches(128) == {"K5": 0, "K6": 5}
    ae = generative.KLAutoencoder(conv_impl="pallas")
    assert ae.kernel_launches(128) == {"K5": 0, "K6": 2}
    assert vqvae.VQVAE(conv_impl="pallas").kernel_launches(128, backward=True) == {
        "K5": 0, "K6": 2, "K6_dx": 2, "K6_dw": 2}
    cn = generative.ControlledDenoiserUNet(cfg, 4, conv_impl="pallas")
    assert cn.kernel_launches(128, backward=True) == {"K5": 0, "K6": 6, "K6_dx": 3, "K6_dw": 1}
    latent = generative.ControlledDenoiserUNet(diffusion.DiffusionConfig(channels=4), 4,
                                               conv_impl="pallas")
    assert latent.kernel_launches(32, backward=True) == {"K5": 0, "K6": 4, "K6_dx": 1,
                                                         "K6_dw": 1}
    assert diffusion.DenoiserUNet(cfg, conv_impl="native").kernel_launches(128) == {
        "K5": 0, "K6": 0}
