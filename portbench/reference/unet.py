"""Plain float32 reference of nnU-Net's 2d training step.

A frozen, independent restatement of the plans-driven U-Net (strided-conv
pooling, 2x2 transposed-conv upsampling, conv + InstanceNorm + LeakyReLU
0.01 twice a stage, features doubled a level and capped, a bias-free 1x1
head at every decoder level, full resolution first), its loss (cross
entropy plus batch soft Dice without the background, smooth 1e-5, at every
head against the label map sliced to the head's scale, weighted 1/2^i with
the coarsest head at 0 and the weights summing to 1), and its update (the
global gradient norm clipped to 12 without epsilon, then SGD with Nesterov
momentum, the weight decay added to the gradient, under the poly
schedule). Float32 with TF32 off; submodules carry the port's parameter
names. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Precision


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, stride, device):
        super().__init__()
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = _param((cout, cin, 3, 3), device)
        self.Conv_0.bias = _param((cout,), device)
        self.InstanceNorm_0 = nn.Module()
        self.InstanceNorm_0.weight = _param((cout,), device)
        self.InstanceNorm_0.bias = _param((cout,), device)
        self.stride = stride

    def forward(self, x, prec):
        y = F.conv2d(prec(x), prec(self.Conv_0.weight), self.Conv_0.bias, self.stride, 1)
        n = self.InstanceNorm_0
        return F.leaky_relu(F.instance_norm(y, weight=n.weight, bias=n.bias, eps=1e-5), 0.01)


class UNet2d(nn.Module):
    """x (N, 1, H, W) -> the heads' logits (N, C, H/2^l, W/2^l), l = 0..pools-1."""

    def __init__(self, base: int, cap: int, pools: int, classes: int,
                 prec: Precision | None = None, device="cpu"):
        super().__init__()
        self.pools, self.prec = pools, prec or Precision()
        feats = [min(base * 2 ** lv, cap) for lv in range(pools + 1)]
        for d in range(pools + 1):
            stack = nn.Module()
            stack.ConvNormAct_0 = ConvNormAct(1 if d == 0 else feats[d - 1], feats[d],
                                              1 if d == 0 else 2, device)
            stack.ConvNormAct_1 = ConvNormAct(feats[d], feats[d], 1, device)
            self.add_module(f"StackedConvs_{d}", stack)
        for u in range(pools):
            lv = pools - 1 - u
            up = nn.Module()
            up.weight = _param((feats[lv + 1], feats[lv], 2, 2), device)
            up.bias = _param((feats[lv],), device)
            self.add_module(f"ConvTranspose_{u}", up)
            stack = nn.Module()
            stack.ConvNormAct_0 = ConvNormAct(2 * feats[lv], feats[lv], 1, device)
            stack.ConvNormAct_1 = ConvNormAct(feats[lv], feats[lv], 1, device)
            self.add_module(f"StackedConvs_{pools + 1 + u}", stack)
            head = nn.Module()
            head.weight = _param((classes, feats[lv], 1, 1), device)
            self.add_module(f"seg_head_{lv}", head)

    def _stack(self, name, x):
        s = getattr(self, name)
        return s.ConvNormAct_1(s.ConvNormAct_0(x, self.prec), self.prec)

    def forward(self, x):
        p, n = self.prec, self.pools
        skips = []
        for d in range(n):
            x = self._stack(f"StackedConvs_{d}", x)
            skips.append(x)
        x = self._stack(f"StackedConvs_{n}", x)
        heads = []
        for u in range(n):
            lv = n - 1 - u
            t = getattr(self, f"ConvTranspose_{u}")
            x = F.conv_transpose2d(p(x), p(t.weight), t.bias, stride=2)
            x = self._stack(f"StackedConvs_{n + 1 + u}", torch.cat([x, skips[lv]], 1))
            heads.append(F.conv2d(p(x), p(getattr(self, f"seg_head_{lv}").weight)))
        return heads[::-1]


def head_weights(n: int) -> np.ndarray:
    w = np.array([1 / 2 ** i for i in range(n)])
    if n > 2:
        w[-1] = 0.0
    return w / w.sum()


def dice_ce(logits: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy + (1 - mean foreground batch soft Dice), NCHW logits."""
    ce = F.cross_entropy(logits, seg.long())
    probs = torch.softmax(logits, 1)
    classes = torch.arange(logits.shape[1], device=seg.device).view(1, -1, 1, 1)
    y = (seg.long()[:, None] == classes).to(probs.dtype)
    axes = (0, 2, 3)
    tp = (probs * y).sum(axes)
    fp = probs.sum(axes) - tp
    fn = y.sum(axes) - tp
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5)
    return ce + 1 - dc[1:].mean()


def loss(model: UNet2d, data: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The deep-supervision loss of a batch: data (N, 1, H, W), seg (N, H, W)."""
    heads = model(data)
    total = 0.0
    for i, (w, out) in enumerate(zip(head_weights(len(heads)), heads)):
        if w != 0.0:
            total = total + float(w) * dice_ce(out, seg[:, ::2 ** i, ::2 ** i])
    return total


def poly_lr(initial: float, step: int, total: int, exponent: float = 0.9) -> float:
    return initial * (1.0 - step / max(total, 1)) ** exponent


class SGD:
    """Clip the global gradient norm to ``clip`` (scale 1 below it), add
    ``wd`` x the parameter, Nesterov momentum: buf = m buf + d (buf = d at the
    first step), p -= lr (d + m buf). ``first_grads`` keeps the first
    step's clipped gradient, as the optimizer is handed it."""

    def __init__(self, params, lr_at, momentum: float, wd: float, clip: float):
        self.params = list(params)
        self.lr_at, self.momentum, self.wd, self.clip = lr_at, momentum, wd, clip
        self.bufs = None
        self.count = 0
        self.first_grads = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = [g * scale for g in grads]
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        lr = self.lr_at(self.count)
        ds = [g + self.wd * p for g, p in zip(grads, self.params)]
        self.bufs = ds if self.bufs is None else [self.momentum * b + d
                                                  for b, d in zip(self.bufs, ds)]
        for p, d, b in zip(self.params, ds, self.bufs):
            p -= lr * (d + self.momentum * b)
        self.count += 1
