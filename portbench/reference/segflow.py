"""Plain float32 reference of the SegFlow serving forward and its predictor.

A frozen, independent restatement of the joint seg+flow video model at its
serving geometry: the query encoder and the segmentation decoder once over
all frames, then a loop over frames (frame 0 the prime step) of the memory
encoder on the warped state, a local correlation and a conv + GroupNorm +
LeakyReLU skip fuse at each level, two cross-attention bottlenecks, a
ConvGRU and the PatchExpand flow decoder. Every tensor is float32 and every
product runs with TF32 off; the correlation is the shifted-products sum over
a zero-padded memory. Submodules carry the port's parameter names, so one
state dict loads into both. The predictor part (ROI crop, per-frame min-max
normalisation, softmax, uncrop) restates the serving predictor's host
arithmetic in numpy. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Precision


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


def groups_for(channels: int, groups: int = 8) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class Conv(nn.Module):
    """k x k conv, padding ((k-1)//2, k//2) = k//2 for odd k, with bias."""

    def __init__(self, cin, cout, k, stride, prec, device, bias=True):
        super().__init__()
        self.weight = _param((cout, cin, k, k), device)
        self.bias = _param((cout,), device) if bias else None
        self.stride, self.pad, self.prec = stride, k // 2, prec

    def forward(self, x):
        return F.conv2d(self.prec(x), self.prec(self.weight), self.bias, self.stride, self.pad)


class GroupNorm(nn.Module):
    def __init__(self, channels, device):
        super().__init__()
        self.weight = _param((channels,), device)
        self.bias = _param((channels,), device)
        self.groups = groups_for(channels)

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, 1e-5)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, stride, prec, device):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 3, stride, prec, device)
        self.GroupNorm_0 = GroupNorm(cout, device)

    def forward(self, x):
        return F.leaky_relu(self.GroupNorm_0(self.Conv_0(x)), 0.01)


class Dense(nn.Module):
    def __init__(self, cin, cout, prec, device):
        super().__init__()
        self.weight = _param((cout, cin), device)
        self.bias = _param((cout,), device)
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class LayerNorm(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.weight = _param((d,), device)
        self.bias = _param((d,), device)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-6)


class Encoder(nn.Module):
    def __init__(self, cin, dims, prec, device):
        super().__init__()
        for i, f in enumerate(dims):
            self.add_module(f"ConvNormAct_{2 * i}", ConvNormAct(cin, f, 2 if i else 1, prec,
                                                                device))
            self.add_module(f"ConvNormAct_{2 * i + 1}", ConvNormAct(f, f, 1, prec, device))
            cin = f
        self.levels = len(dims)

    def forward(self, x):
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(getattr(self, f"ConvNormAct_{2 * i}")(x))
            skips.append(x)
        return skips


class ConvTranspose(nn.Module):
    def __init__(self, cin, cout, prec, device):
        super().__init__()
        self.weight = _param((cin, cout, 2, 2), device)
        self.bias = _param((cout,), device)
        self.prec = prec

    def forward(self, x):
        return F.conv_transpose2d(self.prec(x), self.prec(self.weight), self.bias, stride=2)


class Decoder(nn.Module):
    """PatchExpand (2x2 transposed conv, GroupNorm, tanh-GELU), skip concat,
    two ConvNormAct a level, then a 1x1 head."""

    def __init__(self, cin, dims, head, prec, device):
        super().__init__()
        self.up = len(dims) - 1
        for i in range(self.up):
            f = dims[self.up - 1 - i]
            self.add_module(f"expand_{i}", ConvTranspose(cin, f, prec, device))
            self.add_module(f"GroupNorm_{i}", GroupNorm(f, device))
            self.add_module(f"ConvNormAct_{2 * i}", ConvNormAct(2 * f, f, 1, prec, device))
            self.add_module(f"ConvNormAct_{2 * i + 1}", ConvNormAct(f, f, 1, prec, device))
            cin = f
        self.Conv_0 = Conv(cin, head, 1, 1, prec, device)

    def forward(self, x, skips):
        for i in range(self.up):
            x = getattr(self, f"expand_{i}")(x)
            x = F.gelu(getattr(self, f"GroupNorm_{i}")(x), approximate="tanh")
            x = torch.cat([x, skips[self.up - 1 - i]], 1)
            x = getattr(self, f"ConvNormAct_{2 * i}")(x)
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
        return self.Conv_0(x)


def sine_pos_embed(h: int, w: int, dim: int, device) -> torch.Tensor:
    """(h*w, dim) fixed 2D sine/cosine embedding: sin, cos of y, then of x."""
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    parts = []
    for coord in (ys, xs):
        ang = coord.reshape(-1)[:, None] * omega[None, :]
        parts += [np.sin(ang), np.cos(ang)]
    return torch.from_numpy(np.concatenate(parts, 1).astype(np.float32)).to(device)


class CrossAttention(nn.Module):
    """Pre-norm cross-attention over the pixels of a map, then a GELU FFN."""

    def __init__(self, d, heads, ff, prec, device):
        super().__init__()
        self.d, self.heads, self.prec = d, heads, prec
        self.LayerNorm_0 = LayerNorm(d, device)
        self.q_proj, self.k_proj = Dense(d, d, prec, device), Dense(d, d, prec, device)
        self.v_proj, self.out_proj = Dense(d, d, prec, device), Dense(d, d, prec, device)
        self.LayerNorm_1 = LayerNorm(d, device)
        self.Dense_0, self.Dense_1 = Dense(d, ff, prec, device), Dense(ff, d, prec, device)

    def forward(self, qm, km, vm):
        n, _, h, w = qm.shape
        hd = self.d // self.heads
        pos = sine_pos_embed(h, w, self.d, qm.device)
        q = qm.flatten(2).transpose(1, 2) + pos
        k = km.flatten(2).transpose(1, 2) + pos
        v = vm.flatten(2).transpose(1, 2)

        def split(t):
            return t.view(n, -1, self.heads, hd).transpose(1, 2)

        qh = split(self.q_proj(self.LayerNorm_0(q)))
        kh, vh = split(self.k_proj(k)), split(self.v_proj(v))
        p = self.prec
        weights = torch.softmax(p(qh) @ p(kh).transpose(-1, -2) / math.sqrt(hd), -1)
        attn = (p(weights) @ p(vh)).transpose(1, 2).reshape(n, h * w, self.d)
        x = q + self.out_proj(attn)
        x = x + self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x.transpose(1, 2).reshape(n, self.d, h, w)


class ConvGRU(nn.Module):
    def __init__(self, d, prec, device):
        super().__init__()
        self.Conv_0 = Conv(2 * d, 2 * d, 3, 1, prec, device)
        self.Conv_1 = Conv(2 * d, d, 3, 1, prec, device)

    def forward(self, h, x):
        z, r = torch.sigmoid(self.Conv_0(torch.cat([x, h], 1))).chunk(2, 1)
        q = torch.tanh(self.Conv_1(torch.cat([x, r * h], 1)))
        return (1 - z) * h + z * q


def correlation(q, m, radius: int, stride: int, prec) -> torch.Tensor:
    """out[b, kk, y, x] = <q[b, :, y, x], m[b, :, y + s*dy, x + s*dx]> / sqrt(C)
    over the (2r+1)^2 window, dy-major, zero outside the image."""
    _, c, h, w = q.shape
    pad = radius * stride
    q, mp = prec(q), F.pad(prec(m), (pad, pad, pad, pad))
    k = 2 * radius + 1
    outs = []
    for i in range(k * k):
        oy, ox = (i // k - radius) * stride, (i % k - radius) * stride
        outs.append((q * mp[:, :, pad + oy:pad + oy + h, pad + ox:pad + ox + w]).sum(1))
    return torch.stack(outs, 1) / math.sqrt(c)


def warp(image, flow):
    """image (B, C, H, W) sampled at x + flow(x), bilinear, border clamp;
    flow channel 0 along H, 1 along W, in pixels."""
    _, _, h, w = image.shape
    ys = torch.arange(h, device=flow.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=flow.device, dtype=torch.float32).view(1, 1, w)
    gy = (ys + flow[:, 0]) * (2.0 / (h - 1)) - 1.0
    gx = (xs + flow[:, 1]) * (2.0 / (w - 1)) - 1.0
    return F.grid_sample(image, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode="border", align_corners=True)


class SkipFuse(nn.Module):
    """conv + GroupNorm + LeakyReLU over the concat of query, memory and
    their local correlation."""

    def __init__(self, c, radius, stride, prec, device):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(2 * c + (2 * radius + 1) ** 2, c, 1, prec, device)
        self.radius, self.stride, self.prec = radius, stride, prec

    def forward(self, q, m):
        corr = correlation(q, m, self.radius, self.stride, self.prec)
        return self.ConvNormAct_0(torch.cat([q, m, corr], 1))


class Step(nn.Module):
    def __init__(self, cfg, prec, device):
        super().__init__()
        dims, d = cfg["out_encoder_dims"], cfg["d_model"]
        self.memory_encoder = Encoder(6, dims, prec, device)
        for lvl, c in enumerate(dims):
            self.add_module(f"skip_fuse_{lvl}", SkipFuse(c, cfg["corr_radius"][lvl],
                                                         cfg["corr_stride"][lvl], prec, device))
        self.dist_embed = Dense(8, dims[-1], prec, device)
        args = (d, cfg["bottleneck_heads"], cfg["dim_feedforward"], prec, device)
        self.bottleneck_prev = CrossAttention(*args)
        self.bottleneck_ed = CrossAttention(*args)
        self.ConvNormAct_0 = ConvNormAct(2 * d, d, 1, prec, device)
        self.gru = ConvGRU(d, prec, device)
        self.flow_decoder = Decoder(d, dims, 2, prec, device)
        self.levels = len(dims)

    def forward(self, carry, frame, q_skips, prime: bool):
        hidden, cum_flow, prev_b, x0, prev_frame = carry
        if prime:
            registered, error, flow_in = frame, torch.zeros_like(frame), torch.zeros_like(cum_flow)
        else:
            registered = warp(frame, cum_flow)
            error, flow_in = registered - x0, cum_flow
        m_skips = self.memory_encoder(torch.cat([x0, prev_frame, flow_in, error, registered], 1))
        fused = [None if prime and lvl < self.levels - 1
                 else getattr(self, f"skip_fuse_{lvl}")(q_skips[lvl], m_skips[lvl])
                 for lvl in range(self.levels)]
        b = frame.shape[0]
        ang = torch.zeros((b, 1), device=frame.device) * 2.0 ** torch.arange(
            4, device=frame.device, dtype=torch.float32)  # inter-frame distance 0
        cur = fused[-1] + self.dist_embed(torch.cat([ang.sin(), ang.cos()], 1))[:, :, None, None]
        b1 = self.bottleneck_prev(cur, prev_b, prev_b)
        b2 = self.bottleneck_ed(cur, m_skips[-1], hidden)
        hidden = self.gru(hidden, self.ConvNormAct_0(torch.cat([b1, b2], 1)))
        if prime:
            return (hidden, cum_flow, cur, x0, frame), cum_flow, frame[:, 0]
        cum_flow = cum_flow + self.flow_decoder(hidden, fused)
        return (hidden, cum_flow, cur, x0, frame), cum_flow, warp(frame, cum_flow)[:, 0]


class SegFlow(nn.Module):
    """video (B, T, H, W, 1) float32 -> seg_logits (B, T, H, W, C), cum_flow
    (B, T, 2, H, W), registered (B, T, H, W)."""

    def __init__(self, cfg: dict, num_classes: int, prec: Precision | None = None,
                 device="cpu"):
        super().__init__()
        prec = prec or Precision()
        dims = cfg["out_encoder_dims"]
        self.cfg = cfg
        self.query_encoder = Encoder(1, dims, prec, device)
        self.seg_decoder = Decoder(dims[-1], dims, num_classes, prec, device)
        self.ScanSegFlowStep_0 = Step(cfg, prec, device)

    def forward(self, video):
        b, t, h, w, _ = video.shape
        d, scale = self.cfg["d_model"], 2 ** (len(self.cfg["out_encoder_dims"]) - 1)
        frames = video.permute(1, 0, 4, 2, 3).contiguous()  # (T, B, 1, H, W)
        q_flat = self.query_encoder(frames.view(t * b, 1, h, w))
        seg = self.seg_decoder(q_flat[-1], q_flat).view(t, b, -1, h, w).permute(1, 0, 3, 4, 2)
        q_skips = [s.view(t, b, *s.shape[1:]) for s in q_flat]
        zeros_b = torch.zeros((b, d, h // scale, w // scale), device=video.device)
        carry = (zeros_b, torch.zeros((b, 2, h, w), device=video.device), zeros_b,
                 frames[0], frames[0])
        flows, regs = [], []
        for i in range(t):
            carry, cum, reg = self.ScanSegFlowStep_0(carry, frames[i], [s[i] for s in q_skips],
                                                     prime=i == 0)
            flows.append(cum)
            regs.append(reg)
        return {"seg_logits": seg, "cum_flow": torch.stack(flows, 1),
                "registered": torch.stack(regs, 1)}


def crop_window(mask: np.ndarray, hw, cs: int) -> tuple[int, int]:
    """The crop_size window's corner: centred on the mask's bounding box
    (the image centre for an empty mask), clamped into the image."""
    h, w = hw
    if mask.any():
        ys, xs = np.where(mask)
        cy, cx = (ys.min() + ys.max()) / 2.0, (xs.min() + xs.max()) / 2.0
    else:
        cy, cx = h / 2, w / 2
    half = cs / 2.0
    cy = min(max(cy, half), max(h - half, half))
    cx = min(max(cx, half), max(w - half, half))
    y0 = max(0, min(int(round(cy - half)), max(h - cs, 0)))
    x0 = max(0, min(int(round(cx - half)), max(w - cs, 0)))
    return y0, x0


def crop_inputs(video: np.ndarray, mask: np.ndarray, cs: int):
    """video (T, D, H, W) -> ((D, T, cs, cs, 1) per-frame min-max normalised
    float32 crops, (y0, x0)). The plain reference of the predictor's host
    arithmetic before the network."""
    _, _, h, w = video.shape
    y0, x0 = crop_window(np.asarray(mask, bool), (h, w), cs)
    padded = np.pad(video, ((0, 0), (0, 0), (0, max(cs - h, 0)), (0, max(cs - w, 0))))
    c = padded[:, :, y0:y0 + cs, x0:x0 + cs]
    mn = c.min(axis=(-2, -1), keepdims=True)
    mx = c.max(axis=(-2, -1), keepdims=True)
    norm = (c - mn) / (mx - mn + 1e-8)
    return np.ascontiguousarray(np.moveaxis(norm, 1, 0)[..., None], np.float32), (y0, x0)


def network_outputs(model: SegFlow, videos: torch.Tensor, rows: int = 4) -> dict:
    """The network on (D, T, cs, cs, 1) crops in blocks of ``rows`` slices:
    softmax (T, D, cs, cs, C), cum_flow (T, D, cs, cs, 2), registered (T, D,
    cs, cs) as numpy float32, in the crop window."""
    probs, flows, regs = [], [], []
    with torch.no_grad():
        for s in range(0, videos.shape[0], rows):
            out = model(videos[s:s + rows])
            probs.append(torch.softmax(out["seg_logits"], -1).cpu())
            flows.append(out["cum_flow"].cpu())
            regs.append(out["registered"].cpu())
    probs, flow, reg = (torch.cat(x, 0).numpy() for x in (probs, flows, regs))
    return {"softmax": np.moveaxis(probs, 0, 1),
            "flow": np.moveaxis(np.moveaxis(flow, 2, -1), 0, 1),
            "registered": np.moveaxis(reg, 0, 1)}
