"""Plain float32 reference of nnU-Net's 3d_fullres training step.

A frozen, independent restatement of the plans-driven 3-D U-Net and its
loss, beside the 2-D one in ``reference/unet.py``, whose update (the global
gradient norm clipped to 12, SGD with Nesterov momentum under the poly
schedule) it takes by import:

- per level two conv + InstanceNorm (over D, H, W; eps 1e-5, affine) +
  LeakyReLU 0.01, each conv ``F.conv3d`` with the level's per-axis kernel,
  padded ((k-1)//2, k//2) an axis and with a bias; the first conv of
  every level below the top strides by the pool of the level above it, so
  pooling is a strided conv;
- features doubled a level from the base and capped (320 in the plan);
- a transposed conv with kernel = stride = that pool back up, the skip
  concatenated after it, and two convs with the kernel of the level below
  (nnU-Net's decoder at level l takes the kernel list's entry l + 1);
- a bias-free 1x1x1 head at every decoder level, full resolution first;
- the loss: cross entropy plus batch soft Dice without the background
  (smooth 1e-5, summed over the batch and D, H, W) at every head, against
  the label map sliced by the cumulative per-axis pool strides, weighted
  1/2^i with the coarsest head at 0 and the weights summing to 1.

Departures from the paper's recipe, each the configuration's
(``configs/unet3d_task002.json``): float32 with TF32 off, where nnU-Net v1
trains in fp16 mixed precision; no data augmentation (the port does not
augment a 3-D batch, as the JAX package does not). Remat is left out: it
recomputes the same arithmetic and changes no number. Submodules carry the
port's parameter names, in its order. Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# the update is the 2-D reference's; the driver takes it from here
from portbench.reference.unet import SGD, head_weights, poly_lr  # noqa: F401


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, kernel, stride, device):
        super().__init__()
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = _param((cout, cin, *kernel), device)
        self.Conv_0.bias = _param((cout,), device)
        self.InstanceNorm_0 = nn.Module()
        self.InstanceNorm_0.weight = _param((cout,), device)
        self.InstanceNorm_0.bias = _param((cout,), device)
        self.stride = tuple(stride)
        self.pads = [((k - 1) // 2, k // 2) for k in kernel]

    def forward(self, x):
        if all(lo == hi for lo, hi in self.pads):
            y = F.conv3d(x, self.Conv_0.weight, self.Conv_0.bias, self.stride,
                         tuple(lo for lo, _ in self.pads))
        else:
            x = F.pad(x, [p for lo_hi in self.pads[::-1] for p in lo_hi])
            y = F.conv3d(x, self.Conv_0.weight, self.Conv_0.bias, self.stride)
        n = self.InstanceNorm_0
        return F.leaky_relu(F.instance_norm(y, weight=n.weight, bias=n.bias, eps=1e-5), 0.01)


class UNet3d(nn.Module):
    """x (N, 1, D, H, W) -> the heads' logits, full resolution first: one a
    decoder level, each at its level's (D, H, W)."""

    def __init__(self, base: int, cap: int, pools, kernels, classes: int, device="cpu"):
        super().__init__()
        pools, kernels = [tuple(p) for p in pools], [tuple(k) for k in kernels]
        if len(kernels) != len(pools) + 1:
            raise ValueError("one kernel a level: len(pools) + 1")
        self.pools = pools
        n = len(pools)
        feats = [min(base * 2 ** lv, cap) for lv in range(n + 1)]
        for d in range(n + 1):
            stack = nn.Module()
            stack.ConvNormAct_0 = ConvNormAct(1 if d == 0 else feats[d - 1], feats[d], kernels[d],
                                              (1, 1, 1) if d == 0 else pools[d - 1], device)
            stack.ConvNormAct_1 = ConvNormAct(feats[d], feats[d], kernels[d], (1, 1, 1), device)
            self.add_module(f"StackedConvs_{d}", stack)
        for u in range(n):
            lv = n - 1 - u
            up = nn.Module()
            up.weight = _param((feats[lv + 1], feats[lv], *pools[lv]), device)
            up.bias = _param((feats[lv],), device)
            self.add_module(f"ConvTranspose_{u}", up)
            stack = nn.Module()
            stack.ConvNormAct_0 = ConvNormAct(2 * feats[lv], feats[lv], kernels[lv + 1],
                                              (1, 1, 1), device)
            stack.ConvNormAct_1 = ConvNormAct(feats[lv], feats[lv], kernels[lv + 1], (1, 1, 1),
                                              device)
            self.add_module(f"StackedConvs_{n + 1 + u}", stack)
            head = nn.Module()
            head.weight = _param((classes, feats[lv], 1, 1, 1), device)
            self.add_module(f"seg_head_{lv}", head)

    def _stack(self, name, x):
        s = getattr(self, name)
        return s.ConvNormAct_1(s.ConvNormAct_0(x))

    def forward(self, x):
        n = len(self.pools)
        skips = []
        for d in range(n):
            x = self._stack(f"StackedConvs_{d}", x)
            skips.append(x)
        x = self._stack(f"StackedConvs_{n}", x)
        heads = []
        for u in range(n):
            lv = n - 1 - u
            t = getattr(self, f"ConvTranspose_{u}")
            x = F.conv_transpose3d(x, t.weight, t.bias, stride=self.pools[lv])
            x = self._stack(f"StackedConvs_{n + 1 + u}", torch.cat([x, skips[lv]], 1))
            heads.append(F.conv3d(x, getattr(self, f"seg_head_{lv}").weight))
        return heads[::-1]


def dice_ce(logits: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy + (1 - mean foreground batch soft Dice), NCDHW logits."""
    ce = F.cross_entropy(logits, seg.long())
    probs = torch.softmax(logits, 1)
    classes = torch.arange(logits.shape[1], device=seg.device).view(1, -1, 1, 1, 1)
    y = (seg.long()[:, None] == classes).to(probs.dtype)
    axes = (0, 2, 3, 4)
    tp = (probs * y).sum(axes)
    fp = probs.sum(axes) - tp
    fn = y.sum(axes) - tp
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5)
    return ce + 1 - dc[1:].mean()


def head_strides(pools) -> list[tuple[int, ...]]:
    """The cumulative per-axis stride of each head's scale, full resolution first."""
    out = [(1, 1, 1)]
    for p in pools[:-1]:
        out.append(tuple(a * b for a, b in zip(out[-1], p)))
    return out


def loss(model: UNet3d, data: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The deep-supervision loss of a batch: data (N, 1, D, H, W), seg (N, D, H, W)."""
    heads = model(data)
    total = 0.0
    strides = head_strides(model.pools)
    for w, out, (sz, sy, sx) in zip(head_weights(len(heads)), heads, strides):
        if w != 0.0:
            total = total + float(w) * dice_ce(out, seg[:, ::sz, ::sy, ::sx])
    return total
