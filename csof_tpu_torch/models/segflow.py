"""SegFlow: joint segmentation + optical-flow cine model, for serving and
training (port of ``csof_tpu/models/segflow.py``).

NCHW inside; the public layouts are the JAX package's: video
``(B, T, H, W, 1)`` in, ``seg_logits`` ``(B, T, H, W, C)``, ``flow`` and
``cum_flow`` ``(B, T, 2, H, W)``, ``registered`` ``(B, T, H, W)`` out.

The query encoder and the segmentation decoder run once over all B*T frames;
the recurrent part runs as a Python loop over frames, frame 0 as the "prime"
step that computes only what frame 0 contributes to the carry (its flow is
the identity). Every temporal path of the JAX package computes this math.
Submodules carry the flax scope names, so a flax parameter tree loads by name
(:mod:`csof_tpu_torch.compat.flax_import`).

Ported ``corr_fuse`` modes: ``concat``, ``concat_cm`` (the same math on NCHW)
and ``fused_cm`` (kernel K3). ``concat`` and ``concat_cm`` are differentiable
(the correlation runs K1 forward and K2 backward on the card); ``fused_cm`` is
forward-only, the serving remap. ``split``, ``project`` and ``mean1`` have
parameter trees of their own and are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.attention import CrossAttentionLayer
from csof_tpu_torch.models.blocks import (
    Conv,
    ConvNormAct,
    ConvTranspose,
    Dense,
    add_norm,
)
from csof_tpu_torch.models.convgru import ConvGRUCell
from csof_tpu_torch.ops.correlation import local_correlation_volume
from csof_tpu_torch.ops.kernels.skipfuse import fused_skip_fuse
from csof_tpu_torch.ops.warp import warp_image_cm

PORTED_CORR_FUSE = ("concat", "concat_cm", "fused_cm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: SegFlowModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


class Encoder(nn.Module):
    """Two ConvNormAct per level, the first of each level after level 0 with
    stride 2; returns the per-level skips (NCHW)."""

    def __init__(self, in_channels, out_dims, norm="group", dtype=torch.float32, generator=None):
        super().__init__()
        cin = in_channels
        for i, f in enumerate(out_dims):
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(cin, f, 2 if i else 1, norm, dtype, generator))
            self.add_module(f"ConvNormAct_{2 * i + 1}",
                            ConvNormAct(f, f, 1, norm, dtype, generator))
            cin = f
        self.levels = len(out_dims)

    def forward(self, x):
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"ConvNormAct_{2 * i}")(x)
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    """PatchExpand upsample (ConvTranspose 2x2 + norm + tanh-GELU), skip
    concat, two ConvNormAct per level, then a float32 1x1 head."""

    def __init__(self, in_channels, out_dims, head_channels, norm="group", dtype=torch.float32,
                 head_init_scale=1.0, generator=None):
        super().__init__()
        self.up = len(out_dims) - 1
        self.norm_names = []
        cin = in_channels
        for i in range(self.up):
            f = out_dims[self.up - 1 - i]
            self.add_module(f"expand_{i}", ConvTranspose(cin, f, 2, dtype, generator))
            self.norm_names.append(add_norm(self, norm, f, i))
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(2 * f, f, 1, norm, dtype, generator))
            self.add_module(f"ConvNormAct_{2 * i + 1}",
                            ConvNormAct(f, f, 1, norm, dtype, generator))
            cin = f
        self.Conv_0 = Conv(cin, head_channels, 1, init=("normal", 1e-5 * head_init_scale),
                           generator=generator)

    def forward(self, bottleneck, skips):
        """-> (float32 head (N, head_channels, H, W), last features)."""
        x = bottleneck
        for i in range(self.up):
            skip = skips[self.up - 1 - i]
            x = getattr(self, f"expand_{i}")(x)
            x = nn.functional.gelu(getattr(self, self.norm_names[i])(x), approximate="tanh")
            x = torch.cat([x, skip], 1)
            x = getattr(self, f"ConvNormAct_{2 * i}")(x)
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
        return self.Conv_0(x.float()), x


class SkipFuse(nn.Module):
    """Fuse (query, memory, correlation) skips: corr -> concat -> 3x3
    ConvNormAct. ``fused_cm`` runs the whole chain as kernel K3 on the same
    parameters (GroupNorm only, forward-only); the other modes run the
    differentiable correlation op and the module chain."""

    def __init__(self, channels, mode="concat", norm="group", dtype=torch.float32, radius=4,
                 stride=1, use_corr=True, generator=None):
        super().__init__()
        if mode not in PORTED_CORR_FUSE:
            raise ValueError(f"corr_fuse={mode!r} is not ported (ported: {PORTED_CORR_FUSE})")
        if mode == "fused_cm" and norm not in ("group", "batch"):
            raise ValueError(f"corr_fuse='fused_cm' needs GroupNorm, got norm={norm!r}")
        self.mode, self.radius, self.stride, self.use_corr = mode, radius, stride, use_corr
        self.compute_dtype = dtype
        cin = 2 * channels + ((2 * radius + 1) ** 2 if use_corr else 0)
        self.ConvNormAct_0 = ConvNormAct(cin, channels, 1, norm, dtype, generator)

    def forward(self, q, m):
        dt = self.compute_dtype
        q, m = q.to(dt), m.to(dt)
        cna = self.ConvNormAct_0
        if self.mode == "fused_cm":
            gn = getattr(cna, cna.norm_name)
            return fused_skip_fuse(q, m, cna.Conv_0.weight, cna.Conv_0.bias, gn.weight, gn.bias,
                                   self.radius, self.stride)
        parts = [q, m]
        if self.use_corr:
            parts.append(local_correlation_volume(q, m, self.radius, self.stride).to(dt))
        return cna(torch.cat(parts, 1))


class SegFlowStep(nn.Module):
    """One temporal step: memory encoder on the warped state, per-level
    corr + skip fuse, two cross-attention bottlenecks, ConvGRU, flow decoder."""

    def __init__(self, cfg: SegFlowModelConfig, generator=None):
        super().__init__()
        dt = compute_dtype(cfg)
        dims, d = cfg.out_encoder_dims, cfg.d_model
        self.cfg = cfg
        mode = cfg.corr_fuse
        if mode == "fused_cm" and not cfg.use_cost_volume:
            mode = "concat_cm"  # nothing to fuse in-kernel; same parameters
        self.memory_encoder = Encoder(6, dims, cfg.norm, dt, generator)
        for lvl, c in enumerate(dims):
            self.add_module(f"skip_fuse_{lvl}", SkipFuse(
                c, mode, cfg.norm, dt, cfg.corr_radius[lvl], cfg.corr_stride[lvl],
                cfg.use_cost_volume, generator))
        self.dist_embed = Dense(8, dims[-1], dt, generator)
        args = (d, cfg.bottleneck_heads, cfg.dim_feedforward, dt)
        self.bottleneck_prev = CrossAttentionLayer(*args, generator=generator)
        self.bottleneck_ed = CrossAttentionLayer(*args, generator=generator)
        self.ConvNormAct_0 = ConvNormAct(2 * d, d, 1, cfg.norm, dt, generator)
        if cfg.use_gru:
            self.gru = ConvGRUCell(d, d, dt, generator)
        self.flow_decoder = Decoder(d, dims, 2, cfg.norm, dt, generator=generator)
        self.levels = len(dims)
        self.compute_dtype = dt

    def forward(self, carry, frame, q_skips, dist, prime: bool = False):
        """carry = (hidden, cum_flow, prev_bottleneck, x0, prev_frame);
        frame (B, 1, H, W); q_skips per level (B, C, h, w); dist (B,)."""
        dt = self.compute_dtype
        hidden, cum_flow, prev_bottleneck, x0, prev_frame = carry
        if prime:
            registered = frame
            error = torch.zeros_like(frame)
            flow_in = torch.zeros_like(cum_flow).to(frame.dtype)
        else:
            registered = warp_image_cm(frame, cum_flow, padding="border")
            error = registered - x0
            flow_in = cum_flow.to(frame.dtype)
        memory_in = torch.cat([x0, prev_frame, flow_in, error, registered], 1)
        m_skips = self.memory_encoder(memory_in.to(dt))

        fused = []
        for lvl in range(self.levels):
            if prime and lvl < self.levels - 1:
                fused.append(None)  # feeds only the flow decoder, which prime skips
                continue
            fused.append(getattr(self, f"skip_fuse_{lvl}")(q_skips[lvl], m_skips[lvl]))
        cur = fused[-1]
        freqs = 2.0 ** torch.arange(4, device=dist.device, dtype=torch.float32)
        ang = dist.float()[:, None] * freqs
        demb = torch.cat([torch.sin(ang), torch.cos(ang)], 1)  # (B, 8)
        cur = cur + self.dist_embed(demb.to(dt))[:, :, None, None]

        b1 = self.bottleneck_prev(cur, prev_bottleneck, prev_bottleneck)
        b2 = self.bottleneck_ed(cur, m_skips[-1], hidden)
        bottleneck = self.ConvNormAct_0(torch.cat([b1, b2], 1).to(dt))
        if self.cfg.use_gru:
            hidden = self.gru(hidden.to(dt), bottleneck)
            dec_in = hidden
        else:
            dec_in = bottleneck

        if prime:
            out = {"flow": torch.zeros_like(cum_flow), "cum_flow": cum_flow,
                   "registered": frame[:, 0]}
            return (hidden, cum_flow, cur, x0, frame), out
        dflow, _ = self.flow_decoder(dec_in, fused)
        cum_flow = cum_flow + dflow
        out = {
            "flow": dflow,
            "cum_flow": cum_flow,
            "registered": warp_image_cm(frame, cum_flow, padding="border")[:, 0],
        }
        return (hidden, cum_flow, cur, x0, frame), out


class SegFlow(nn.Module):
    """Full video model. Build on the CPU (parameters are drawn from
    ``generator`` as flax initializes them), then move with ``.to(device)``.
    Gradients reach every parameter in the ``concat`` and ``concat_cm``
    modes; ``fused_cm`` refuses them (run it under ``torch.inference_mode()``
    or ``no_grad()``)."""

    def __init__(self, cfg: SegFlowModelConfig = SegFlowModelConfig(), num_classes: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        # attn_fused is a program form of the same math (the JAX package
        # stacks the two bottlenecks' parameters under bottleneck_dual):
        # it runs the two CrossAttentionLayers, and load_flax_params unstacks
        # its checkpoints
        if cfg.deep_supervision or cfg.dec_upsample != "expand":
            raise ValueError("deep_supervision and dec_upsample='linear' are not ported")
        if cfg.out_encoder_dims[-1] != cfg.d_model:
            raise ValueError("SegFlow carries the bottleneck features as the next step's "
                             "attention input, so out_encoder_dims[-1] must equal d_model")
        self.cfg, self.num_classes = cfg, num_classes
        dt = compute_dtype(cfg)
        dims = cfg.out_encoder_dims
        self.query_encoder = Encoder(1, dims, cfg.norm, dt, generator)
        self.seg_decoder = Decoder(dims[-1], dims, num_classes, cfg.norm, dt,
                                   head_init_scale=1e5, generator=generator)
        # the flax scope of the shared step module
        self.step_name = "ScanCheckpointSegFlowStep_0" if cfg.remat else "ScanSegFlowStep_0"
        self.add_module(self.step_name, SegFlowStep(cfg, generator))
        self.compute_dtype = dt

    def forward(self, video: torch.Tensor, distance: torch.Tensor | None = None) -> dict:
        """video (B, T, H, W, 1); distance (B, T) inter-frame spacing or None."""
        cfg, dt = self.cfg, self.compute_dtype
        b, t, h, w, _ = video.shape
        scale = 2 ** (len(cfg.out_encoder_dims) - 1)
        # frame-major (T, B, 1, H, W): per-frame slices of the skips are contiguous
        frames = video.permute(1, 0, 4, 2, 3).contiguous()
        q_skips = self.query_encoder(frames.view(t * b, 1, h, w).to(dt))
        seg, _ = self.seg_decoder(q_skips[-1], q_skips)
        seg_logits = seg.view(t, b, -1, h, w).permute(1, 0, 3, 4, 2)
        q_skips = [s.view(t, b, *s.shape[1:]) for s in q_skips]
        if distance is None:
            distance = torch.zeros((b, t), dtype=torch.float32, device=video.device)

        step = getattr(self, self.step_name)
        hb, wb = h // scale, w // scale
        x0 = frames[0]
        carry = (
            torch.zeros((b, cfg.d_model, hb, wb), dtype=dt, device=video.device),
            torch.zeros((b, 2, h, w), dtype=torch.float32, device=video.device),
            torch.zeros((b, cfg.d_model, hb, wb), dtype=dt, device=video.device),
            x0, x0,
        )
        outs = []
        for i in range(t):
            carry, o = step(carry, frames[i], [s[i] for s in q_skips], distance[:, i],
                            prime=i == 0)
            outs.append(o)
        res = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}
        res["seg_logits"] = seg_logits
        return res
