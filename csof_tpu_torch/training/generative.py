"""Training steps of the generative extras (port of
``csof_tpu/training/generative.py``): latent diffusion, ControlNet and the
alternating GAN steps.

Each step takes the port's optimizer objects where the JAX step takes an
optax transform: any object with ``step()`` over a list of parameters (a
``torch.optim.Optimizer``, or :class:`csof_tpu_torch.training.schedules.
Optimizer` with its clip). A step differentiates the loss with respect to
the optimizer's parameters, sets their gradients (a zero one where
autograd gives none, as optax updates every leaf) and steps it; the models
update in place and the step returns the loss. Draws come from an explicit ``torch.Generator`` (``generator``, or
``rng`` in the GAN steps, whose first model is the generator) or are given.
"""

from __future__ import annotations

import torch

from csof_tpu_torch.config.experiment import OptimConfig
from csof_tpu_torch.models.discriminator import discriminator_loss, generator_adversarial_loss
from csof_tpu_torch.models.generative import (ControlledDenoiserUNet, LatentDiffusion,
                                              controlnet_loss, controlnet_param_labels)
from csof_tpu_torch.training.schedules import Optimizer


def optimizer_params(optimizer) -> list[torch.nn.Parameter]:
    """The parameters ``optimizer`` updates."""
    if isinstance(optimizer, Optimizer):
        return optimizer.params
    return [p for group in optimizer.param_groups for p in group["params"]]


def take_step(optimizer, loss: torch.Tensor) -> None:
    """Differentiate ``loss`` with respect to the optimizer's parameters,
    set their gradients and step."""
    params = optimizer_params(optimizer)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()


def make_ldm_train_step(ldm: LatentDiffusion, optimizer):
    """``step(x, cond=None, generator=None, eps=None, t=None, noise=None)``:
    the epsilon MSE on the frozen autoencoder's latents, one update of the
    denoiser; returns the loss."""

    def step(x, cond=None, generator=None, eps=None, t=None, noise=None):
        loss = ldm.loss(x, cond, generator, eps, t, noise)
        take_step(optimizer, loss)
        return loss.detach()

    return step


def make_controlnet_optimizer(model: ControlledDenoiserUNet, lr: float = 1e-4) -> Optimizer:
    """The ControlNet recipe's optimizer (the JAX package's
    ``optax.multi_transform``): the control gradients clipped to a global
    norm of 12 among themselves, then AdamW (optax's defaults: b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4) at the constant ``lr``; the base
    parameters are not in it and never move."""
    labels = controlnet_param_labels(model)
    control = [p for name, p in model.named_parameters() if labels[name] == "control"]
    cfg = OptimConfig(optimizer="adamw", scheduler="constant", initial_lr=lr,
                      weight_decay=1e-4, grad_clip_norm=12.0)
    return Optimizer(cfg, 1, control)


def make_controlnet_train_step(model: ControlledDenoiserUNet, ddpm, optimizer):
    """``step(x0, hint, generator=None, t=None, noise=None)``: the epsilon
    MSE with the hint, one update of the optimizer's (the control branch's)
    parameters; returns the loss. The base's parameters are set to take no
    gradient: the JAX step's frozen gradients are read by nothing
    (``optax.set_to_zero``), so XLA never computes them, and here autograd
    skips them and the input gradients only they need (the base's level-0
    convs before the first control joins it)."""
    loss_fn = controlnet_loss(model, ddpm)
    labels = controlnet_param_labels(model)
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)

    def step(x0, hint, generator=None, t=None, noise=None):
        loss = loss_fn(x0, hint, generator, t, noise)
        take_step(optimizer, loss)
        return loss.detach()

    return step


def make_gan_train_steps(generator, discriminator, g_opt, d_opt):
    """The alternating non-saturating GAN steps: ``d_step(real, rng=None,
    z=None)`` and ``g_step(batch_size, rng=None, z=None)``, each returning
    its loss; ``z`` (batch, generator.features[0]) unit normals. ``d_step``
    detaches the fakes; ``g_step`` updates the generator only."""

    def latents(batch, rng, z, device):
        if z is None:
            z = torch.randn(batch, generator.features[0], generator=rng, device=device)
        return z.to(device)

    def d_step(real, rng=None, z=None):
        with torch.no_grad():
            fake = generator(latents(real.shape[0], rng, z, real.device))
        loss = discriminator_loss(discriminator(real), discriminator(fake))
        take_step(d_opt, loss)
        return loss.detach()

    def g_step(batch_size, rng=None, z=None):
        device = next(generator.parameters()).device
        fake = generator(latents(batch_size, rng, z, device))
        loss = generator_adversarial_loss(discriminator(fake))
        take_step(g_opt, loss)
        return loss.detach()

    return d_step, g_step
