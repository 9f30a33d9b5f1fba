"""SegFlow: joint segmentation + optical-flow cine model, for serving and
training (port of ``csof_tpu/models/segflow.py``).

NCHW inside; the public layouts are the JAX package's: video
``(B, T, H, W, 1)`` in, ``seg_logits`` ``(B, T, H, W, C)``, ``flow`` and
``cum_flow`` ``(B, T, 2, H, W)``, ``registered`` ``(B, T, H, W)`` out; with
``deep_supervision`` also ``seg_ds`` (each ``(B, T, H, W, C)``) and
``flow_ds`` (each ``(B, T, 2, H, W)``), finest first.

The query encoder and the segmentation decoder run once over all B*T frames;
the recurrent part runs as a Python loop over frames, frame 0 as the "prime"
step that computes only what frame 0 contributes to the carry (its flow is
the identity). Every temporal path of the JAX package computes this math, so
``scan_unroll`` and ``scan_while1`` (program forms) load and change nothing
but the layout of the intermediates (``forward(..., intermediates=True)``).
``remat`` checkpoints each step (``torch.utils.checkpoint``) under the flax
scope ``ScanCheckpointSegFlowStep_0``. Submodules carry the flax scope names,
so a flax parameter tree loads by name
(:mod:`csof_tpu_torch.compat.flax_import`).

``corr_fuse`` modes: ``concat``, ``concat_cm`` (the same math and
parameters), ``split`` (three convs and one bias, the same math again;
``fuse_q_hoist`` runs the query conv once over all frames as the top-level
``fuse_q_{lvl}``), ``project`` (a 1x1 projection of the correlation) and
``mean1`` (its channel mean), all differentiable (the correlation runs K1
forward and K2 backward on the card); ``fused_cm`` is kernel K3,
forward-only, the serving remap.

The JAX package's two kernel switches, read from the environment as it reads
them unless given: ``CSOF_CONV2D_IMPL=pallas`` runs the 3x3 convs of every
``ConvNormAct`` it routes to its Pallas conv as kernel K6 (forward and dx):
both encoders, both decoders, the ``concat``/``project``/``mean1`` skip
fuses and the step's ``ConvNormAct_0``, where ``conv3x3_worthwhile`` holds.
The blocks JAX builds outside ``ConvNormAct`` never route: ``concat_cm``'s
fuse (``_NCHWConvNormAct``), the split convs, ``fuse_q_{lvl}``, the ConvGRU,
the transposed convs and the 1x1 heads. ``CSOF_FUSED_NORM=1`` runs the same
blocks' InstanceNorm + LeakyReLU as kernel K5 (``norm="instance"``).
"""

from __future__ import annotations


import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.attention import CrossAttentionLayer
from csof_tpu_torch.models.blocks import (
    Conv,
    ConvNormAct,
    ConvTranspose,
    Dense,
    add_norm,
    kernel_switches,
    leaky_relu,
    upsample_linear,
)
from csof_tpu_torch.models.convgru import ConvGRUCell
from csof_tpu_torch.ops.correlation import local_correlation_volume
from csof_tpu_torch.ops.kernels.skipfuse import fused_skip_fuse
from csof_tpu_torch.ops.warp import warp_image_cm

CORR_FUSE = ("concat", "split", "project", "mean1", "concat_cm", "fused_cm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: SegFlowModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def temporal_path(cfg: SegFlowModelConfig, t: int) -> str:
    """The JAX package's temporal path for ``t`` frames: "while1" (the frame
    loop inside one length-1 ``nn.scan``), "loop" (a Python loop, frame 0
    as the prime step) or "scan" (``nn.scan``, every frame a full step).
    Under ``remat`` frame 0 runs the full step on every path."""
    if cfg.scan_while1 and not cfg.remat:
        return "while1"
    return "loop" if cfg.scan_unroll > t else "scan"


def level_widths(width: int, levels: int) -> list[int]:
    """The input width of each level of an ``Encoder`` (stride-2 convs with
    padding 1)."""
    widths = [width]
    for _ in range(levels - 1):
        widths.append((widths[-1] - 1) // 2 + 1)
    return widths


def routed_launches(blocks) -> dict[str, int]:
    """K5 and K6 launches of ``(ConvNormAct, input width, times)`` triples."""
    return {"K5": sum(t * b.fused_norm_act for b, _, t in blocks),
            "K6": sum(t * b.uses_k6(w) for b, w, t in blocks)}


def routed_counts(convs, backward: bool = False, trained=None) -> dict[str, int]:
    """K5 and K6 (and with ``backward`` K6 dx and K6 dw) launches of
    ``convs``: (ConvNormAct, input width, whether its input needs a
    gradient) triples, each called once; a routed conv's dx runs where its
    input needs a gradient, its dw where its weight does (``trained``: one
    bool a conv; by default every weight)."""
    out = routed_launches([(block, w, 1) for block, w, _ in convs])
    if backward:
        out["K6_dx"] = sum(block.uses_k6(w) and grad for block, w, grad in convs)
        out["K6_dw"] = sum(block.uses_k6(w) and t for (block, w, _), t in
                           zip(convs, [True] * len(convs) if trained is None else trained))
    return out


class Encoder(nn.Module):
    """Two ConvNormAct per level, the first of each level after level 0 with
    stride 2; returns the per-level skips (NCHW)."""

    def __init__(self, in_channels, out_dims, norm="group", dtype=torch.float32, generator=None,
                 conv_impl="native", fused_norm_act=False):
        super().__init__()
        kw = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        cin = in_channels
        for i, f in enumerate(out_dims):
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(cin, f, 2 if i else 1, norm, dtype, generator, **kw))
            self.add_module(f"ConvNormAct_{2 * i + 1}",
                            ConvNormAct(f, f, 1, norm, dtype, generator, **kw))
            cin = f
        self.levels = len(out_dims)

    def routed_blocks(self, width: int, times: int = 1):
        """(block, input width, times) of each ConvNormAct for an input
        ``width`` pixels wide, run ``times`` times."""
        widths = level_widths(width, self.levels)
        for i in range(self.levels):
            yield getattr(self, f"ConvNormAct_{2 * i}"), widths[max(i - 1, 0)], times
            yield getattr(self, f"ConvNormAct_{2 * i + 1}"), widths[i], times

    def forward(self, x):
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"ConvNormAct_{2 * i}")(x)
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    """Upsample, skip concat, two ConvNormAct per level, then a float32 1x1
    head. ``upsample="expand"``: PatchExpand (ConvTranspose 2x2 + norm +
    tanh-GELU); "linear": a linear resize (no parameters). With
    ``deep_supervision``, every level but the last also gives a float32 1x1
    head ``ds_head_{i}`` resized to full resolution."""

    def __init__(self, in_channels, out_dims, head_channels, norm="group", dtype=torch.float32,
                 head_init_scale=1.0, generator=None, deep_supervision=False,
                 upsample="expand", conv_impl="native", fused_norm_act=False):
        super().__init__()
        if upsample not in ("expand", "linear"):
            raise ValueError(f"unknown decoder upsample {upsample!r}")
        kw = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        self.up = len(out_dims) - 1
        self.upsample, self.deep_supervision = upsample, deep_supervision
        self.norm_names = []
        cin = in_channels
        for i in range(self.up):
            f = out_dims[self.up - 1 - i]
            if upsample == "expand":
                self.add_module(f"expand_{i}", ConvTranspose(cin, f, 2, dtype, generator))
                self.norm_names.append(add_norm(self, norm, f, i))
                cin = f
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(cin + f, f, 1, norm, dtype, generator, **kw))
            self.add_module(f"ConvNormAct_{2 * i + 1}",
                            ConvNormAct(f, f, 1, norm, dtype, generator, **kw))
            if deep_supervision and i < self.up - 1:
                self.add_module(f"ds_head_{i}", Conv(f, head_channels, 1, dtype=torch.float32,
                                                     init="lecun_normal", generator=generator))
            cin = f
        self.Conv_0 = Conv(cin, head_channels, 1, init=("normal", 1e-5 * head_init_scale),
                           generator=generator)

    def routed_blocks(self, width: int, times: int = 1):
        """(block, input width, times) of each ConvNormAct for an output
        ``width`` pixels wide, run ``times`` times."""
        widths = level_widths(width, self.up + 1)
        for i in range(self.up):
            for j in (2 * i, 2 * i + 1):
                yield getattr(self, f"ConvNormAct_{j}"), widths[self.up - 1 - i], times

    def forward(self, bottleneck, skips):
        """-> (float32 head (N, head_channels, H, W), last features); with
        deep supervision the head is (head, *ds heads finest first)."""
        x = bottleneck
        ds = []
        for i in range(self.up):
            skip = skips[self.up - 1 - i]
            if self.upsample == "expand":
                x = getattr(self, f"expand_{i}")(x)
                x = nn.functional.gelu(getattr(self, self.norm_names[i])(x), approximate="tanh")
            else:
                x = upsample_linear(x, (2, 2))
            x = torch.cat([x, skip], 1)
            x = getattr(self, f"ConvNormAct_{2 * i}")(x)
            x = getattr(self, f"ConvNormAct_{2 * i + 1}")(x)
            if self.deep_supervision and i < self.up - 1:
                factor = 2 ** (self.up - 1 - i)
                ds.append(upsample_linear(getattr(self, f"ds_head_{i}")(x.float()),
                                          (factor, factor)))
        head = self.Conv_0(x.float())
        if self.deep_supervision:
            return (head, *reversed(ds)), x
        return head, x


class SkipFuse(nn.Module):
    """Fuse (query, memory, correlation) skips into one feature map, in the
    mode ``mode`` (see the module docstring). Without the correlation
    (``use_corr=False``) ``split``, ``project`` and ``mean1`` take the
    ``concat`` module, as the JAX package does. ``hoisted_q``: ``split``'s
    query conv runs outside (``q_pre``) and has no parameters here."""

    def __init__(self, channels, mode="concat", norm="group", dtype=torch.float32, radius=4,
                 stride=1, use_corr=True, generator=None, conv_impl="native",
                 fused_norm_act=False, hoisted_q=False):
        super().__init__()
        if mode not in CORR_FUSE:
            raise ValueError(f"unknown corr_fuse mode {mode!r} (one of {CORR_FUSE})")
        if mode == "fused_cm" and norm not in ("group", "batch"):
            raise ValueError(f"corr_fuse='fused_cm' needs GroupNorm, got norm={norm!r}")
        if not use_corr and mode in ("split", "project", "mean1"):
            mode = "concat"
        self.mode, self.radius, self.stride, self.use_corr = mode, radius, stride, use_corr
        self.compute_dtype = dtype
        c, k2 = channels, (2 * radius + 1) ** 2 if use_corr else 0
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        if mode == "split":
            if not hoisted_q:
                self.conv_q = Conv(c, c, 3, dtype=dtype, generator=generator)
            self.conv_m = Conv(c, c, 3, bias=False, dtype=dtype, generator=generator)
            self.conv_corr = Conv(k2, c, 3, bias=False, dtype=dtype, generator=generator)
            self.norm_name = add_norm(self, norm, c, 0)
        elif mode == "project":
            self.corr_proj = Conv(k2, c, 1, bias=False, dtype=dtype, generator=generator)
            self.ConvNormAct_0 = ConvNormAct(3 * c, c, 1, norm, dtype, generator, **routed)
        elif mode == "mean1":
            self.ConvNormAct_0 = ConvNormAct(2 * c + 1, c, 1, norm, dtype, generator, **routed)
        else:  # concat routes as ConvNormAct; concat_cm (and fused_cm's tree) never do
            self.ConvNormAct_0 = ConvNormAct(2 * c + k2, c, 1, norm, dtype, generator,
                                             **(routed if mode == "concat" else {}))

    def forward(self, q, m, q_pre=None):
        """-> (fused features, the correlation volume or None)."""
        dt = self.compute_dtype
        q, m = q.to(dt), m.to(dt)
        if self.mode == "fused_cm":
            cna = self.ConvNormAct_0
            gn = getattr(cna, cna.norm_name)
            return fused_skip_fuse(q, m, cna.Conv_0.weight, cna.Conv_0.bias, gn.weight, gn.bias,
                                   self.radius, self.stride), None
        corr = (local_correlation_volume(q, m, self.radius, self.stride).to(dt)
                if self.use_corr else None)
        if self.mode == "split":
            y = (q_pre if q_pre is not None else self.conv_q(q)) + self.conv_m(m) \
                + self.conv_corr(corr)
            return leaky_relu(getattr(self, self.norm_name)(y)), corr
        if self.mode == "project":
            parts = [q, m, self.corr_proj(corr)]
        elif self.mode == "mean1":
            parts = [q, m, corr.mean(1, keepdim=True, dtype=torch.float32).to(dt)]
        else:
            parts = [q, m] + ([] if corr is None else [corr])
        return self.ConvNormAct_0(torch.cat(parts, 1)), corr


class SegFlowStep(nn.Module):
    """One temporal step: memory encoder on the warped state, per-level
    corr + skip fuse, two cross-attention bottlenecks, ConvGRU, flow decoder."""

    def __init__(self, cfg: SegFlowModelConfig, generator=None, conv_impl="native",
                 fused_norm_act=False):
        super().__init__()
        dt = compute_dtype(cfg)
        dims, d = cfg.out_encoder_dims, cfg.d_model
        self.cfg = cfg
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        mode = cfg.corr_fuse
        if mode == "fused_cm" and not cfg.use_cost_volume:
            mode = "concat_cm"  # nothing to fuse in-kernel; same parameters
        self.memory_encoder = Encoder(6, dims, cfg.norm, dt, generator, **routed)
        for lvl, c in enumerate(dims):
            self.add_module(f"skip_fuse_{lvl}", SkipFuse(
                c, mode, cfg.norm, dt, cfg.corr_radius[lvl], cfg.corr_stride[lvl],
                cfg.use_cost_volume, generator, hoisted_q=cfg.fuse_q_hoist, **routed))
        self.dist_embed = Dense(8, dims[-1], dt, generator)
        args = (d, cfg.bottleneck_heads, cfg.dim_feedforward, dt)
        self.bottleneck_prev = CrossAttentionLayer(*args, generator=generator)
        self.bottleneck_ed = CrossAttentionLayer(*args, generator=generator)
        self.ConvNormAct_0 = ConvNormAct(2 * d, d, 1, cfg.norm, dt, generator, **routed)
        if cfg.use_gru:
            self.gru = ConvGRUCell(d, d, dt, generator)
        self.flow_decoder = Decoder(d, dims, 2, cfg.norm, dt, generator=generator,
                                    deep_supervision=cfg.deep_supervision,
                                    upsample=cfg.dec_upsample, **routed)
        self.levels = len(dims)
        self.compute_dtype = dt

    def _sim(self, lvl, q, m, corr, sows):
        """Sow the level's similarity map: the best local correlation of
        each pixel, float32 (computed by K1 where the fuse did not return
        the volume: ``fused_cm``, and levels the prime step skips)."""
        if corr is None:
            sf = getattr(self, f"skip_fuse_{lvl}")
            dt = self.compute_dtype
            corr = local_correlation_volume(q.to(dt), m.to(dt), sf.radius, sf.stride)
        sows[f"sim_{lvl}"] = corr.float().amax(1)

    def forward(self, carry, frame, q_skips, dist, q_pre=None, prime: bool = False,
                sows: dict | None = None, full_sims: bool = False):
        """carry = (hidden, cum_flow, prev_bottleneck, x0, prev_frame);
        frame (B, 1, H, W); q_skips (and q_pre, split + fuse_q_hoist) per
        level (B, C, h, w); dist (B,). ``sows``: a dict to fill with this
        frame's intermediates (flax names); ``full_sims``: the prime step
        sows every level's similarity map, as JAX's full frame-0 step does."""
        cfg, dt = self.cfg, self.compute_dtype
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
            q, m = q_skips[lvl], m_skips[lvl]
            if prime and lvl < self.levels - 1:
                if sows is not None and full_sims and cfg.use_cost_volume:
                    self._sim(lvl, q, m, None, sows)
                fused.append(None)  # feeds only the flow decoder, which prime skips
                continue
            f, corr = getattr(self, f"skip_fuse_{lvl}")(q, m, None if q_pre is None
                                                         else q_pre[lvl])
            fused.append(f)
            if sows is not None and cfg.use_cost_volume:
                self._sim(lvl, q, m, corr, sows)
        cur = fused[-1]
        freqs = 2.0 ** torch.arange(4, device=dist.device, dtype=torch.float32)
        ang = dist.float()[:, None] * freqs
        demb = torch.cat([torch.sin(ang), torch.cos(ang)], 1)  # (B, 8)
        cur = cur + self.dist_embed(demb.to(dt))[:, :, None, None]

        want = sows is not None
        b1 = self.bottleneck_prev(cur, prev_bottleneck, prev_bottleneck, return_attn_map=want)
        b2 = self.bottleneck_ed(cur, m_skips[-1], hidden, return_attn_map=want)
        if want:
            (b1, a1), (b2, a2) = b1, b2
            if cfg.attn_fused:  # JAX's pair-batched layer sows both on a pair axis
                sows["bottleneck_dual"] = {"attn_weights": torch.stack([a1, a2], 1)}
            else:
                sows["bottleneck_prev"] = {"attn_weights": a1}
                sows["bottleneck_ed"] = {"attn_weights": a2}
        bottleneck = self.ConvNormAct_0(torch.cat([b1, b2], 1).to(dt))
        if cfg.use_gru:
            hidden = self.gru(hidden.to(dt), bottleneck)
            dec_in = hidden
        else:
            dec_in = bottleneck

        if prime:
            zflow = torch.zeros_like(cum_flow)
            out = {"flow": zflow, "cum_flow": cum_flow, "registered": frame[:, 0]}
            if cfg.deep_supervision:
                out["flow_ds"] = (zflow,) * max(self.levels - 2, 0)
            return (hidden, cum_flow, cur, x0, frame), out
        flow_out, _ = self.flow_decoder(dec_in, fused)
        dflow, flow_ds = (flow_out[0], flow_out[1:]) if cfg.deep_supervision else (flow_out, ())
        cum_flow = cum_flow + dflow
        out = {
            "flow": dflow,
            "cum_flow": cum_flow,
            "registered": warp_image_cm(frame, cum_flow, padding="border")[:, 0],
        }
        if cfg.deep_supervision:
            out["flow_ds"] = tuple(flow_ds)
        return (hidden, cum_flow, cur, x0, frame), out


def _stack_sows(per_frame: list[dict], path: str) -> dict:
    """Per-frame intermediates -> the JAX collection's layout for ``path``:
    "scan" stacks each map over T (``(B, T, ...)`` in a 1-tuple), "loop"
    keeps one ``(B, ...)`` entry a call, "while1" one ``(B, 1, ...)`` entry
    a call. A frame that sowed no map (the prime step's skipped levels) adds
    no entry."""
    keys = []
    for sows in per_frame:
        keys += [k for k in sows if k not in keys]
    out = {}
    for k in keys:
        vals = [s[k] for s in per_frame if k in s]
        if isinstance(vals[0], dict):
            out[k] = _stack_sows(vals, path)
        elif path == "scan":
            out[k] = (torch.stack(vals, 1),)
        elif path == "while1":
            out[k] = tuple(v[:, None] for v in vals)
        else:
            out[k] = tuple(vals)
    return out


class SegFlow(nn.Module):
    """Full video model. Build on the CPU (parameters are drawn from
    ``generator`` as flax initializes them), then move with ``.to(device)``.
    Gradients reach every parameter in every mode but ``fused_cm``, which
    refuses them (run it under ``torch.inference_mode()`` or ``no_grad()``).
    ``conv_impl`` and ``fused_norm_act`` are the JAX package's switches
    (module docstring); ``None`` reads ``CSOF_CONV2D_IMPL`` (default
    ``native``) and ``CSOF_FUSED_NORM`` as the JAX package reads them."""

    def __init__(self, cfg: SegFlowModelConfig = SegFlowModelConfig(), num_classes: int = 4,
                 generator: torch.Generator | None = None, conv_impl: str | None = None,
                 fused_norm_act: bool | None = None):
        super().__init__()
        # attn_fused is a program form of the same math (the JAX package
        # stacks the two bottlenecks' parameters under bottleneck_dual):
        # it runs the two CrossAttentionLayers, and load_flax_params unstacks
        # its checkpoints
        if cfg.out_encoder_dims[-1] != cfg.d_model:
            raise ValueError("SegFlow carries the bottleneck features as the next step's "
                             "attention input, so out_encoder_dims[-1] must equal d_model")
        conv_impl, fused_norm_act, _ = kernel_switches(2, conv_impl, fused_norm_act)
        routed = dict(conv_impl=conv_impl, fused_norm_act=fused_norm_act)
        self.cfg, self.num_classes = cfg, num_classes
        dt = compute_dtype(cfg)
        dims = cfg.out_encoder_dims
        self.query_encoder = Encoder(1, dims, cfg.norm, dt, generator, **routed)
        self.seg_decoder = Decoder(dims[-1], dims, num_classes, cfg.norm, dt,
                                   head_init_scale=1e5, generator=generator,
                                   deep_supervision=cfg.deep_supervision,
                                   upsample=cfg.dec_upsample, **routed)
        self.hoist_q = cfg.corr_fuse == "split" and cfg.fuse_q_hoist
        if self.hoist_q:
            for lvl, c in enumerate(dims):
                self.add_module(f"fuse_q_{lvl}", Conv(c, c, 3, dtype=dt, generator=generator))
        # the flax scope of the shared step module
        self.step_name = "ScanCheckpointSegFlowStep_0" if cfg.remat else "ScanSegFlowStep_0"
        self.add_module(self.step_name, SegFlowStep(cfg, generator, **routed))
        self.compute_dtype = dt

    def forward(self, video: torch.Tensor, distance: torch.Tensor | None = None,
                intermediates: bool = False):
        """video (B, T, H, W, 1); distance (B, T) inter-frame spacing or None.
        With ``intermediates``, returns (outputs, {"intermediates": ...}):
        JAX's ``mutable=["intermediates"]`` collection of a batched apply,
        ``sim_{lvl}`` (B, h, w) and the bottlenecks' ``attn_weights`` (B,
        hb, wb) under the step's scope, laid out as the configuration's
        temporal path lays them out (``temporal_path``, ``_stack_sows``)."""
        cfg, dt = self.cfg, self.compute_dtype
        b, t, h, w, _ = video.shape
        scale = 2 ** (len(cfg.out_encoder_dims) - 1)
        # frame-major (T, B, 1, H, W): per-frame slices of the skips are contiguous
        frames = video.permute(1, 0, 4, 2, 3).contiguous()
        q_flat = self.query_encoder(frames.view(t * b, 1, h, w).to(dt))
        seg_out, _ = self.seg_decoder(q_flat[-1], q_flat)
        seg_heads = seg_out if cfg.deep_supervision else (seg_out,)
        seg_heads = [s.view(t, b, -1, h, w).permute(1, 0, 3, 4, 2) for s in seg_heads]
        q_skips = [s.view(t, b, *s.shape[1:]) for s in q_flat]
        q_pre = None
        if self.hoist_q:
            q_pre = [getattr(self, f"fuse_q_{lvl}")(s).view(t, b, *s.shape[1:])
                     for lvl, s in enumerate(q_flat)]
        if distance is None:
            distance = torch.zeros((b, t), dtype=torch.float32, device=video.device)

        step = getattr(self, self.step_name)
        path = temporal_path(cfg, t)
        hb, wb = h // scale, w // scale
        x0 = frames[0]
        carry = (
            torch.zeros((b, cfg.d_model, hb, wb), dtype=dt, device=video.device),
            torch.zeros((b, 2, h, w), dtype=torch.float32, device=video.device),
            torch.zeros((b, cfg.d_model, hb, wb), dtype=dt, device=video.device),
            x0, x0,
        )
        outs, per_frame = [], []
        for i in range(t):
            sows = {} if intermediates else None
            args = (carry, frames[i], [s[i] for s in q_skips], distance[:, i],
                    None if q_pre is None else [p[i] for p in q_pre])
            kw = dict(prime=i == 0, sows=sows, full_sims=path == "scan" or cfg.remat)
            if cfg.remat and torch.is_grad_enabled():
                carry, o = checkpoint(step, *args, use_reentrant=False, **kw)
            else:
                carry, o = step(*args, **kw)
            outs.append(o)
            per_frame.append(sows)
        res = {k: torch.stack([o[k] for o in outs], 1) for k in ("flow", "cum_flow",
                                                                 "registered")}
        res["seg_logits"] = seg_heads[0]
        if cfg.deep_supervision:
            res["flow_ds"] = tuple(torch.stack([o["flow_ds"][k] for o in outs], 1)
                                   for k in range(len(outs[0]["flow_ds"])))
            res["seg_ds"] = tuple(seg_heads[1:])
        if intermediates:
            return res, {"intermediates": {self.step_name: _stack_sows(per_frame, path)}}
        return res

    def kernel_launches(self, t: int, width: int, backward: bool = False) -> dict[str, int]:
        """K5 and K6 launches of one forward of ``t`` frames ``width`` pixels
        wide, counted from the modules without running them (the batch does
        not change them: the query encoder and the segmentation decoder run
        once over all frames, the step once a frame). With ``backward``,
        also ``K6_dx``: one dx for each K6 conv whose input needs a
        gradient, which is every one but the query encoder's first (its
        input is the video) and the memory encoder's first at frames 0 and
        1 (their input holds no flow yet), and ``K6_dw``: one dw for each
        K6 conv of the forward; under ``remat`` the backward runs each
        step's forward again, so the step's K5 and K6 count twice."""
        levels = len(self.cfg.out_encoder_dims)
        widths = [width]
        for _ in range(levels - 1):
            widths.append((widths[-1] - 1) // 2 + 1)
        step = getattr(self, self.step_name)
        k5 = k6 = dx = 0

        def count(block, w_in, times=1, dx_times=None):
            nonlocal k5, k6, dx
            k5 += times * block.fused_norm_act
            uses = block.uses_k6(w_in)
            k6 += times * uses
            dx += (times if dx_times is None else dx_times) * uses

        def encoder(enc, times, first_dx):
            for i in range(levels):
                count(getattr(enc, f"ConvNormAct_{2 * i}"), widths[max(i - 1, 0)], times,
                      first_dx if i == 0 else None)
                count(getattr(enc, f"ConvNormAct_{2 * i + 1}"), widths[i], times)

        def decoder(dec, times):
            for i in range(dec.up):
                w_i = widths[levels - 2 - i]
                count(getattr(dec, f"ConvNormAct_{2 * i}"), w_i, times)
                count(getattr(dec, f"ConvNormAct_{2 * i + 1}"), w_i, times)

        encoder(self.query_encoder, 1, 0)
        decoder(self.seg_decoder, 1)
        outside = (k5, k6)
        encoder(step.memory_encoder, t, max(t - 2, 0))
        for lvl in range(levels):  # the prime step fuses the last level only
            sf = getattr(step, f"skip_fuse_{lvl}")
            if hasattr(sf, "ConvNormAct_0") and sf.mode != "fused_cm":
                count(sf.ConvNormAct_0, widths[lvl], t if lvl == levels - 1 else t - 1)
        count(step.ConvNormAct_0, widths[-1], t)
        decoder(step.flow_decoder, t - 1)
        dw = k6
        if backward and self.cfg.remat:
            k5, k6 = 2 * k5 - outside[0], 2 * k6 - outside[1]
        return {"K5": k5, "K6": k6, **({"K6_dx": dx, "K6_dw": dw} if backward else {})}
