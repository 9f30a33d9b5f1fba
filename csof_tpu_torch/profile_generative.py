#!/usr/bin/env python3
"""The generative family of the PyTorch port on a CUDA device: its runs at
full width, and their device-time profiles.

    python3 -m csof_tpu_torch.profile_generative [out_prefix]
    python3 -m csof_tpu_torch.profile_generative --launches

:data:`GEN_RUNS` are ``chip_smoke.py`` phase 34's runs, float32 with random
weights from a seed: the DDPM denoiser (``DiffusionConfig()``: T = 1000,
features 32/64/128) on 16 x 128^2 (the SegFlow ROI), unconditional and with
a 4-class one-hot condition; latent diffusion over ``KLAutoencoder()``'s
32^2 x 4 latents of the same images, and the autoencoder's decode back to
128^2; the ControlNet at 128^2 with a 4-channel hint, and on the 32^2
latents with the 128^2 hint (the resize path); ``VQVAE()`` on the same
images; ``SwinGenerator()`` -> 64^2 and ``SwinDiscriminator()`` at batch 16;
UDA with the Task002 2d U-Net (``task002_heart_2d()``, no deep supervision)
on 8 source + 8 target images of 320 x 256 and ``PatchDiscriminator()`` on
its 2-class softmax; ``PolicyNet()`` on 16 x 128^2. Each run has a forward
and a training step (the port's training functions; the draws given, so
that the card and the CPU take the same ones), and the K6 and K6 dx launches
``kernel_launches`` gives for each (and UDA's U-Net on the card K7 and K7
dx).

With ``--launches``, one JSON line: for each run, the K6, K6 dx, K7 and K7
dx kernels among the device events of one forward and of one step
(``kernel_times.device_events``, a fresh process: one that has taken many
traces can lose kernels), under ``CSOF_CONV2D_IMPL=pallas``, beside the
counts the modules give, with the device events and busy ms of that
trace and the host-clock ms (median of 3 calls without the profiler).
Without it, the device-time table and summary line of one DDPM step and
one UDA step (``profile_flow.profile_call``), written to
``out_prefix_{ddpm,uda}_step.txt`` if given.
"""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from csof_tpu_torch.config.experiment import OptimConfig
from csof_tpu_torch.config.plans import task002_heart_2d
from csof_tpu_torch.models.diffusion import DDPM, DenoiserUNet, DiffusionConfig
from csof_tpu_torch.models.discriminator import PatchDiscriminator
from csof_tpu_torch.models.generative import (ControlledDenoiserUNet, KLAutoencoder,
                                              LatentDiffusion, SwinDiscriminator, SwinGenerator)
from csof_tpu_torch.models.unet import unet_from_plans
from csof_tpu_torch.models.vqvae import VQVAE
from csof_tpu_torch.training import policy_search, uda
from csof_tpu_torch.training.generative import (make_controlnet_optimizer,
                                                make_controlnet_train_step, make_gan_train_steps,
                                                make_ldm_train_step, take_step)
from csof_tpu_torch.training.schedules import Optimizer

#: batch and size of the image runs (the SegFlow ROI), of UDA (Task002's 2d
#: patch, source and target each) and the GAN batch; sampling's batch and steps
GEN_B, GEN_HW = 16, 128
UDA_B, UDA_HW = 8, (320, 256)
GAN_B = 16
SAMPLE_B, SAMPLE_STEPS = 4, 50
#: the runs, in order
GEN_RUNS = ("ddpm", "ddpm cond", "ldm", "kl decode", "controlnet", "controlnet latent",
            "vqvae", "gan", "uda", "policy")


@dataclass
class GenCase:
    """One run on one device: its modules, a forward, a training step (None
    for a forward-only run), the K6 / K6 dx launches each should make, and
    the inputs it closes over."""

    models: dict
    forward: Callable
    step: Callable | None
    want_forward: dict
    want_step: dict = field(default_factory=dict)
    inputs: dict = field(default_factory=dict)


def adamw(params, lr: float = 1e-4) -> Optimizer:
    """The port's trainer optimizer: clip 12, then AdamW at a constant lr."""
    return Optimizer(OptimConfig(optimizer="adamw", scheduler="constant", initial_lr=lr), 1,
                     params)


def _data(rng, device, *shape):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)


def _normal(rng, device, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


def _timesteps(rng, device, n, timesteps=1000):
    return torch.from_numpy(rng.randint(0, timesteps, n)).to(device, torch.int64)


def trained_out(model: DenoiserUNet, generator) -> DenoiserUNet:
    """The denoiser with its zero-initialized output conv drawn normal(0,
    0.02), as a trained one's: at init the output is zero and no gradient
    reaches the layers before it."""
    with torch.no_grad():
        model.Conv_0.weight.normal_(0.0, 0.02, generator=generator)
    return model


def build_case(name: str, conv_impl: str, device, small: bool = False, seed: int = 0) -> GenCase:
    """Run ``name`` on ``device`` with weights from ``seed`` (drawn on the
    CPU, so every device gets the same) and inputs and draws from a numpy
    seed; ``small``: batch 1 (UDA at 128^2, which still routes K6), for
    card-vs-CPU parity."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed + 1)
    b = 1 if small else GEN_B
    dev = torch.device(device)
    cfg = DiffusionConfig()
    if name in ("ddpm", "ddpm cond"):
        cc = 4 if name == "ddpm cond" else 0
        model = trained_out(DenoiserUNet(DiffusionConfig(cond_channels=cc), gen, conv_impl),
                            gen).to(dev)
        x = _data(rng, dev, b, GEN_HW, GEN_HW, 1) * 2 - 1
        cond = None
        if cc:
            labels = torch.from_numpy(rng.randint(0, cc, (b, GEN_HW, GEN_HW))).to(dev)
            cond = torch.nn.functional.one_hot(labels, cc).float()
        t, noise = _timesteps(rng, dev, b), _normal(rng, dev, b, GEN_HW, GEN_HW, 1)
        ddpm, opt = DDPM(model, model.cfg), adamw(model.parameters())

        def step():
            loss = ddpm.loss(x, cond, t=t, noise=noise)
            take_step(opt, loss)
            return loss.detach()

        return GenCase({"denoiser": model}, lambda: model(x, t, cond), step,
                       model.kernel_launches(GEN_HW), model.kernel_launches(GEN_HW, True),
                       {"x": x, "t": t, "noise": noise, "cond": cond})
    if name in ("ldm", "kl decode"):
        ae = KLAutoencoder(generator=gen, conv_impl=conv_impl).to(dev)
        ldm = LatentDiffusion(ae, DiffusionConfig(channels=4), generator=gen,
                              conv_impl=conv_impl)
        trained_out(ldm.denoiser, gen)
        ldm.to(dev)
        x = _data(rng, dev, b, GEN_HW, GEN_HW, 1) * 2 - 1
        lw = GEN_HW // 4
        eps = _normal(rng, dev, b, lw, lw, 4)
        latents = ldm.encode_latents(x, eps=eps)
        if name == "kl decode":
            return GenCase({"ae": ae}, lambda: ae.decode(latents), None,
                           ae.kernel_launches(GEN_HW), inputs={"latents": latents})
        t, noise = _timesteps(rng, dev, b), _normal(rng, dev, b, lw, lw, 4)
        den = ldm.denoiser
        step_fn = make_ldm_train_step(ldm, adamw(den.parameters()))
        return GenCase({"denoiser": den, "ae": ae}, lambda: den(latents, t),
                       lambda: step_fn(x, eps=eps, t=t, noise=noise), den.kernel_launches(lw),
                       den.kernel_launches(lw, True), {"x": x, "ldm": ldm})
    if name in ("controlnet", "controlnet latent"):
        latent = name == "controlnet latent"
        ccfg = DiffusionConfig(channels=4) if latent else cfg
        model = ControlledDenoiserUNet(ccfg, 4, gen, conv_impl)
        with torch.no_grad():  # zero convs that have trained a little: the hint counts
            for i in range(len(ccfg.features)):
                getattr(model, f"control_zero_{i}").weight.normal_(0.0, 0.02, generator=gen)
        model = model.to(dev)
        w = GEN_HW // 4 if latent else GEN_HW
        x = _normal(rng, dev, b, w, w, ccfg.channels)
        hint = _data(rng, dev, b, GEN_HW, GEN_HW, 4)
        t, noise = _timesteps(rng, dev, b), _normal(rng, dev, b, w, w, ccfg.channels)
        opt = make_controlnet_optimizer(model)
        step_fn = make_controlnet_train_step(model, DDPM(model, ccfg), opt)
        return GenCase({"controlnet": model}, lambda: model(x, t, hint),
                       lambda: step_fn(x, hint, t=t, noise=noise), model.kernel_launches(w),
                       model.kernel_launches(w, True), {"x": x, "hint": hint, "opt": opt})
    if name == "vqvae":
        model = VQVAE(generator=gen, conv_impl=conv_impl).to(dev)
        x = _data(rng, dev, b, GEN_HW, GEN_HW, 1)
        opt = adamw(model.parameters())

        def step():
            out = model(x)
            loss = ((out["reconstruction"] - x).square().mean() + out["codebook_loss"]
                    + out["commitment_loss"])
            take_step(opt, loss)
            return loss.detach()

        return GenCase({"vqvae": model}, lambda: model(x), step, model.kernel_launches(GEN_HW),
                       model.kernel_launches(GEN_HW, True), {"x": x})
    if name == "gan":
        bg = 1 if small else GAN_B
        g = SwinGenerator(generator=gen).to(dev)
        d = SwinDiscriminator(generator=gen).to(dev)
        z, z2 = _normal(rng, dev, bg, g.features[0]), _normal(rng, dev, bg, g.features[0])
        real = _data(rng, dev, bg, 64, 64, 1) * 2 - 1
        d_step, g_step = make_gan_train_steps(g, d, adamw(g.parameters()),
                                              adamw(d.parameters()))
        none = {"K5": 0, "K6": 0}
        return GenCase({"generator": g, "discriminator": d}, lambda: d(g(z)),
                       lambda: (d_step(real, z=z), g_step(bg, z=z2)), none,
                       {**none, "K6_dx": 0}, {"z": z})
    if name == "uda":
        bu = 1 if small else UDA_B
        h, w = (128, 128) if small else UDA_HW
        net = unet_from_plans(task002_heart_2d(), deep_supervision=False, conv_impl=conv_impl,
                              fused_norm_act=False, generator=gen).to(dev)
        disc = PatchDiscriminator(2, generator=gen).to(dev)
        batch = {"source": _data(rng, dev, bu, h, w, 1), "target": _data(rng, dev, bu, h, w, 1),
                 "source_seg": torch.from_numpy(rng.rand(bu, h, w) > 0.7).to(dev, torch.int64)}
        batch["target"] = batch["target"] * 1.5 + 0.25  # another domain's intensities

        def seg_apply(m, x):
            return m(x.movedim(-1, 1)).movedim(1, -1)

        state = uda.init_uda_state(net, disc, adamw(net.parameters()),
                                   adamw(disc.parameters()))
        step_fn = uda.make_uda_step(seg_apply, disc)
        per = net.kernel_launches((h, w), backward=True)
        return GenCase({"seg": net, "disc": disc},
                       lambda: seg_apply(net, batch["source"]),
                       lambda: step_fn(state, batch)[1]["seg_loss"], net.kernel_launches((h, w)),
                       {"K5": 0, "K6": 4 * per["K6"], "K6_dx": 2 * per["K6_dx"],
                        "K6_dw": 2 * per["K6_dw"], "K7": 4 * per["K7"],
                        "K7_dx": 2 * per["K7_dx"]}, batch)
    if name == "policy":
        pol = policy_search.PolicyNet(generator=gen).to(dev)
        x = _data(rng, dev, b, GEN_HW, GEN_HW, 1)
        actions = torch.from_numpy(rng.randint(0, pol.num_intervals, b)).to(dev)
        target = float(policy_search.interval_to_angle(torch.tensor(5.0), pol.num_intervals))
        step_fn = policy_search.make_reinforce_step(pol, lambda xb, a: -(a - target).abs(),
                                                    adamw(pol.parameters()))
        none = {"K5": 0, "K6": 0}
        return GenCase({"policy": pol}, lambda: pol(x),
                       lambda: step_fn(torch.tensor(0.0, device=dev), x, actions=actions)[1][
                           "loss"], none, {**none, "K6_dx": 0}, {"x": x})
    raise ValueError(f"unknown run {name!r}")


def sample_ldm(case: GenCase, generator=None) -> torch.Tensor:
    """Latent diffusion's ``sample``: SAMPLE_STEPS steps at batch SAMPLE_B
    over 32^2 x 4 latents, decoded to 128^2 images."""
    lw = GEN_HW // 4
    return case.inputs["ldm"].sample((SAMPLE_B, lw, lw, 4), steps=SAMPLE_STEPS,
                                     generator=generator)


def generative_launches(reps: int = 3) -> dict:
    """{run: {"forward" | "step": {"K6", "K6_dx", "K6_dw", "K7", "K7_dx": device
    kernels of one call, "want", "wall_ms", "events", "busy_ms"}}} under
    pallas, on the
    card: one trace of one call (``device_events``, warm-up included) gives
    the kernels, the events and the busy ms; then the host-clock ms, the
    median of ``reps`` calls without the profiler."""
    from csof_tpu_torch.kernel_times import device_events
    from csof_tpu_torch.utils.profiling import busy_ms

    out = {}
    for name in GEN_RUNS:
        case = build_case(name, "pallas", "cuda")
        for kind, fn, want in (("forward", case.forward, case.want_forward),
                               ("step", case.step, case.want_step)):
            if fn is None:
                continue
            with torch.inference_mode(kind == "forward"):
                events, _ = device_events(fn, reps=1)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            out.setdefault(name, {})[kind] = {
                "K6": sum("conv3x3_kernel" in e.name for e in events),
                "K6_dx": sum("conv3x3_dx_kernel" in e.name for e in events),
                "K6_dw": sum("conv3x3_wgrad_kernel" in e.name for e in events),
                "K7": sum("inorm_lrelu_fwd" in e.name for e in events),
                "K7_dx": sum("inorm_lrelu_bwd" in e.name for e in events),
                "want": want, "wall_ms": statistics.median(times), "events": len(events),
                "busy_ms": busy_ms(events)}
        del case
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_generative: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--launches"]:
        import json

        print(json.dumps(generative_launches()))
        return 0
    from csof_tpu_torch.profile_flow import profile_call

    prefix = sys.argv[1] if len(sys.argv) > 1 else None
    for name in ("ddpm", "uda"):
        case = build_case(name, "pallas", "cuda")
        summary, table = profile_call(case.step, f"{name} step (float32, pallas)")
        print(summary)
        print(table)
        if prefix:
            with open(f"{prefix}_{name}_step.txt", "w") as f:
                f.write(summary + "\n" + table + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
