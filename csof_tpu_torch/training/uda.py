"""Unsupervised domain adaptation by adversarial output alignment (port of
``csof_tpu/training/uda.py``): a segmentation model trains on labelled
source data while a patch discriminator pushes its target-domain softmax to
look like its source-domain one.

One step, as the JAX step: the segmentation update first (Dice + CE on the
source plus ``adversarial_weight`` times the generator loss of the
discriminator on the target's softmax, differentiated over the segmentation
model only), then the discriminator's update on the softmaxes of the
**updated** segmentation model (detached), source as real and target as
fake. The softmax runs over the class axis; ``seg_apply(seg_model, x)``
maps channels-last images ``(N, H, W, C)`` to channels-last logits ``(N, H,
W, classes)``. The state is ``(seg_model, seg_opt, disc, disc_opt)``, the
models updated in place. Kernel K5 has no backward, so a segmentation model
that runs it (``CSOF_FUSED_NORM=1``) is refused, as the trainer refuses it.
"""

from __future__ import annotations

from typing import Callable

import torch

from csof_tpu_torch.models.blocks import kernel_switches
from csof_tpu_torch.models.discriminator import (PatchDiscriminator, discriminator_loss,
                                                 generator_adversarial_loss)
from csof_tpu_torch.ops import losses as L
from csof_tpu_torch.training.generative import optimizer_params, take_step


def _check_trainable(seg_model: torch.nn.Module) -> None:
    fused = any(getattr(m, "fused_norm_act", False) for m in seg_model.modules())
    if fused or kernel_switches(2).fused_norm_act:
        raise NotImplementedError(
            "CSOF_FUSED_NORM=1 (fused_norm_act) runs kernel K5, which has no backward: the "
            "JAX package uses it for inference only. Unset it to train.")


def init_uda_state(seg_model: torch.nn.Module, disc: PatchDiscriminator, seg_opt, disc_opt):
    """The step's state ``(seg_model, seg_opt, disc, disc_opt)``; each
    optimizer must hold exactly its model's parameters."""
    _check_trainable(seg_model)
    for model, opt in ((seg_model, seg_opt), (disc, disc_opt)):
        if {id(p) for p in model.parameters()} != {id(p) for p in optimizer_params(opt)}:
            raise ValueError(f"an optimizer does not hold exactly the parameters of its "
                             f"{type(model).__name__}")
    return seg_model, seg_opt, disc, disc_opt


def make_uda_step(seg_apply: Callable, disc: PatchDiscriminator,
                  adversarial_weight: float = 0.001):
    """``step(state, batch) -> (state, metrics)``, batch ``{"source",
    "source_seg", "target"}``; metrics ``seg_loss``, ``disc_loss``, ``sup``
    and ``adv_gen`` (detached tensors)."""

    def step(state, batch):
        seg_model, seg_opt, disc_model, disc_opt = state
        if disc_model is not disc:
            raise ValueError("the state's discriminator is not the step's")
        _check_trainable(seg_model)
        src_logits = seg_apply(seg_model, batch["source"])
        sup = L.dice_and_ce_loss(src_logits, batch["source_seg"])
        tgt_probs = torch.softmax(seg_apply(seg_model, batch["target"]), dim=-1)
        fool = generator_adversarial_loss(disc(tgt_probs))
        seg_loss = sup + adversarial_weight * fool
        take_step(seg_opt, seg_loss)

        with torch.no_grad():
            src_probs = torch.softmax(seg_apply(seg_model, batch["source"]), dim=-1)
            tgt_probs = torch.softmax(seg_apply(seg_model, batch["target"]), dim=-1)
        disc_l = discriminator_loss(disc(src_probs), disc(tgt_probs))
        take_step(disc_opt, disc_l)
        metrics = {"seg_loss": seg_loss.detach(), "disc_loss": disc_l.detach(),
                   "sup": sup.detach(), "adv_gen": fool.detach()}
        return state, metrics

    return step
