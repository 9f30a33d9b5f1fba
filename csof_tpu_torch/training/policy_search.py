"""REINFORCE search over rotation intervals (port of
``csof_tpu/training/policy_search.py``): a small conv policy gives
categorical logits over K rotation bins, trained against a black-box reward
with an EMA baseline.

Images are channels last, ``(N, H, W, C)``, NCHW inside. The policy's convs
are flax's default ``Conv``: 3x3, stride 2, ``padding="SAME"``, which on an
even input pads (0, 1); they run no kernel of the port. The actions come
from an explicit ``torch.Generator`` or are given.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from csof_tpu_torch.models.blocks import Conv, Dense
from csof_tpu_torch.training.generative import take_step


class PolicyNet(nn.Module):
    """Two stride-2 3x3 convs with ReLU, the mean over the map, a Dense:
    ``(N, H, W, C)`` -> ``(N, num_intervals)`` logits."""

    def __init__(self, num_intervals: int = 20, features: int = 16, in_channels: int = 1,
                 generator=None):
        super().__init__()
        self.num_intervals = num_intervals
        self.Conv_0 = Conv(in_channels, features, 3, 2, padding="SAME", init="lecun_normal",
                           generator=generator)
        self.Conv_1 = Conv(features, 2 * features, 3, 2, padding="SAME", init="lecun_normal",
                           generator=generator)
        self.Dense_0 = Dense(2 * features, num_intervals, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.Conv_0(x.movedim(-1, 1)))
        h = torch.relu(self.Conv_1(h))
        return self.Dense_0(h.mean(dim=(2, 3)))


def interval_to_angle(interval: torch.Tensor, num_intervals: int) -> torch.Tensor:
    """Bin index -> rotation angle in radians over the full circle, [-pi, pi)."""
    return (interval / num_intervals) * 2 * math.pi - math.pi


def make_reinforce_step(policy: PolicyNet, reward_fn: Callable, optimizer,
                        baseline_decay: float = 0.9):
    """``step(baseline, x, generator=None, actions=None) -> (baseline,
    metrics)``: draw a bin per image from the policy's softmax (or take
    ``actions``), score the angles with ``reward_fn(x, angle)`` (N,), ascend
    log-prob times (reward - baseline), then move the baseline toward the
    mean reward by ``1 - baseline_decay``. Metrics: ``loss``,
    ``mean_reward``, ``actions``."""

    def step(baseline, x, generator=None, actions=None):
        logits = policy(x)
        if actions is None:
            probs = torch.softmax(logits.detach().float(), dim=-1)
            actions = torch.multinomial(probs, 1, generator=generator)[:, 0]
        actions = actions.to(logits.device, torch.int64)
        angle = interval_to_angle(actions.float(), policy.num_intervals)
        with torch.no_grad():
            reward = reward_fn(x, angle)
        logp = torch.log_softmax(logits, dim=-1).gather(1, actions[:, None])[:, 0]
        loss = -(logp * (reward - baseline)).mean()
        take_step(optimizer, loss)
        baseline = baseline_decay * baseline + (1 - baseline_decay) * reward.mean()
        return baseline, {"loss": loss.detach(), "mean_reward": reward.mean(), "actions": actions}

    return step
