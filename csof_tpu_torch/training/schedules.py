"""Learning-rate schedules and the optimizer (port of
``csof_tpu/training/schedules.py``).

The schedules are plain functions of the update count. :class:`Optimizer`
reproduces the JAX package's optax chain: clip by global norm, then AdamW
(optax.adamw: b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
parameter) or SGD with Nesterov momentum behind ``add_decayed_weights``, with
the learning rate read at the count before each update, as optax reads it.
Every parameter is updated at every step, with a zero gradient where
autograd gave none, as optax updates every leaf.
"""

from __future__ import annotations

import math

import torch

from csof_tpu_torch.config.experiment import OptimConfig


def poly_schedule(initial_lr: float, total_steps: int, exponent: float = 0.9):
    def schedule(step: int) -> float:
        frac = 1.0 - step / max(total_steps, 1)
        return initial_lr * frac ** exponent if frac >= 0 else math.nan  # as jnp gives

    return schedule


def cosine_with_warmup(initial_lr: float, total_steps: int, warmup_percent: float,
                       eta_min: float):
    """``optax.warmup_cosine_decay_schedule`` as the JAX package builds it:
    linear from initial_lr/100 to initial_lr over the warm-up steps, then a
    cosine to eta_min, held at eta_min past the last step."""
    warmup = max(1, int(total_steps * warmup_percent))
    decay = max(total_steps, warmup + 1) - warmup
    init, peak = initial_lr * 1e-2, initial_lr
    alpha = 0.0 if peak == 0.0 else eta_min / peak

    def schedule(step: int) -> float:
        if step < warmup:
            return (init - peak) * (1.0 - max(step, 0) / warmup) + peak
        count = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def build_schedule(cfg: OptimConfig, total_steps: int):
    if cfg.scheduler == "poly":
        return poly_schedule(cfg.initial_lr, total_steps, cfg.poly_exponent)
    if cfg.scheduler == "cosine":
        return cosine_with_warmup(cfg.initial_lr, total_steps, cfg.warmup_percent, cfg.eta_min)
    return lambda step: cfg.initial_lr


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: g * (max_norm / ||g||) when the
    global norm is at least max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Stays on the device; returns the norm."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip, then AdamW or SGD, over ``params`` under the schedule of
    ``cfg``; ``count`` is the number of updates made (optax's step count)."""

    def __init__(self, cfg: OptimConfig, total_steps: int, params, count: int = 0):
        self.cfg = cfg
        self.schedule = build_schedule(cfg, total_steps)
        self.params = [p for p in params if p.requires_grad]
        self.count = count
        if cfg.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=0.0, momentum=cfg.sgd_momentum,
                                         nesterov=cfg.nesterov, weight_decay=cfg.weight_decay)
        else:
            self.inner = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        # a parameter without a gradient (a zero-weight deep-supervision
        # head) takes a zero one: optax still decays it and moves its
        # momentum, where torch's optimizers would skip it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        clip_by_global_norm_(grads, self.cfg.grad_clip_norm)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def build_optimizer(cfg: OptimConfig, total_steps: int, params) -> Optimizer:
    """Grad-clip ``cfg.grad_clip_norm`` then AdamW or SGD-Nesterov."""
    return Optimizer(cfg, total_steps, params)
