#!/usr/bin/env python3
"""The least time an NVIDIA H100 could take for the work of each TPU kernel
of the repo, from its shapes and the card's data-sheet peaks.

    python3 -m csof_tpu_torch.bounds

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate of the fastest unit that can do them (a
multiply-add is 2). bf16 work counts on the bf16 tensor cores: convolutions,
and the correlation's window products too, which a kernel can run as one
banded GEMM per window row. float32 convolutions (K6) count on the tensor
cores as 3xTF32, three TF32 products for float32 accuracy (3 x FLOPs at the
TF32 peak), as K6 runs them; their FLOPs on the FP32 cores stay as a note.
Other float32 work counts on the FP32 cores.
Pure arithmetic: it needs no card. ``chip_smoke.py`` computes the bounds of
the ported kernels with the same functions at the shapes it times.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, 700 W): HBM bytes/s, FP32-core,
#: bf16 tensor-core and TF32 tensor-core FLOP/s
HBM_BPS, FP32_FLOPS, BF16_TC_FLOPS, TF32_TC_FLOPS = 3.35e12, 67e12, 989e12, 495e12
RADIUS = 4
#: (C, H, W, stride) of the three SegFlow skip levels at the 128^2 ROI
SEGFLOW_LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
#: one forward of the Task002 2d U-Net at its serving batch (8 tiles x 4
#: mirrors = 32, patch 320x256, base 32, 6 pools, cap 480): K5 at every
#: ConvNormAct, as ((C, H, W), launches); K6 at the stride-1 3x3 convs with
#: Co < 128 on inputs at least 32 wide, as ((Ci, Co, H, W), launches)
UNET_BATCH = 32
UNET_K5_SHAPES = [((32, 320, 256), 4), ((64, 160, 128), 4), ((128, 80, 64), 4),
                  ((256, 40, 32), 4), ((480, 20, 16), 4), ((480, 10, 8), 4), ((480, 5, 4), 2)]
UNET_K6_SHAPES = [((1, 32, 320, 256), 1), ((32, 32, 320, 256), 2), ((64, 32, 320, 256), 1),
                  ((64, 64, 160, 128), 2), ((128, 64, 160, 128), 1)]
#: K4's planes of 128x128, (N, what they are): the SegFlow NCC loss at the
#: training batch (B=4 x (T-1)=5 frames) and at the bench geometry (8 cines x
#: (12-1) frames)
K4_SHAPES = [(20, "one SegFlow train loss: B=4 x 5 frames"),
             (88, "the SegFlow loss at the bench geometry: 8 cines x 11 frames")]
#: one training step of the same U-Net at its training batch: K6 forward at
#: the shapes above, and K6's dx (the kernel on dy with the flipped weight,
#: no bias) for each of them but the first conv, whose input is the data, as
#: ((Ci', Co', H, W) of the dx launch = (Co, Ci, H, W) of its conv, launches)
UNET_TRAIN_BATCH = 40
UNET_K6_DX_SHAPES = [((32, 32, 320, 256), 2), ((32, 64, 320, 256), 1),
                     ((64, 64, 160, 128), 2), ((64, 128, 160, 128), 1)]


#: the Task002 3d_fullres U-Net (``task002_heart_3d``: patch 80x192x160,
#: base 32, cap 320, pools (1, 2, 2) then (2, 2, 2)) under
#: CSOF_CONV2D_IMPL=pallas: K6 at every z tap of its routed convs ((1, 3, 3)
#: one tap, (3, 3, 3) three), each launch on (batch x 80 z slices) planes
#: without bias, as ((Ci, Co, H, W), launches): level 0 (192x160: the
#: encoder's two (1, 3, 3) convs, the decoder's two (3, 3, 3)) and level 1
#: (96x80, 80 slices: the encoder's stride-1 conv, the decoder's two); 17 a
#: forward, and 16 dx a training step (all but the first conv's tap)
UNET3D_DEPTH = 80
#: the routed 3D convs themselves, ((Ci, Co, kernel, (D, H, W)), convs of
#: that shape a forward): each runs as kz K6 launches, or as one F.conv3d
UNET3D_CONVS = [((1, 32, (1, 3, 3), (80, 192, 160)), 1), ((32, 32, (1, 3, 3), (80, 192, 160)), 1),
                ((64, 32, (3, 3, 3), (80, 192, 160)), 1), ((32, 32, (3, 3, 3), (80, 192, 160)), 1),
                ((64, 64, (3, 3, 3), (80, 96, 80)), 2), ((128, 64, (3, 3, 3), (80, 96, 80)), 1)]
#: batches: a serving forward of 1 tile (``predictor.TILE_BATCH_3D``) x 8
#: mirrors, a training step of 2
UNET3D_SERVING_BATCH, UNET3D_TRAIN_BATCH = 8, 2
UNET3D_K6_SHAPES = [((1, 32, 192, 160), 1), ((32, 32, 192, 160), 4), ((64, 32, 192, 160), 3),
                    ((64, 64, 96, 80), 6), ((128, 64, 96, 80), 3)]
UNET3D_K6_DX_SHAPES = [((32, 32, 192, 160), 4), ((32, 64, 192, 160), 3), ((64, 64, 96, 80), 6),
                       ((64, 128, 96, 80), 3)]


def bound_ms(nbytes: float, fp32_flops: float, tc_flops: float = 0.0,
             tf32_flops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"); tc_flops run at the bf16 tensor-core
    peak, tf32_flops at the TF32 one."""
    t_bytes = nbytes / HBM_BPS
    t_ops = fp32_flops / FP32_FLOPS + tc_flops / BF16_TC_FLOPS + tf32_flops / TF32_TC_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def corr_work(kernel: str, b: int, c: int, h: int, w: int,
              itemsize: int) -> tuple[float, float, float, float]:
    """(bytes, FP32 FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs) of one call
    of K1 (q, m -> corr), K2 (q, m, g -> dq, dm) or K3 (q, m, float32 conv
    and norm parameters -> out) at one level, radius 4, in float32 (itemsize
    4) or bf16 (itemsize 2). The window products of a bf16 call count as
    tensor-core FLOPs, those of a float32 call as FP32 FLOPs; K3's float32
    conv counts as 3xTF32, as K3 runs it."""
    k2, hw = (2 * RADIUS + 1) ** 2, h * w
    corr_flops = 2 * k2 * c * hw * b * (2 if kernel == "K2" else 1)
    fp32, tc = (0.0, corr_flops) if itemsize == 2 else (corr_flops, 0.0)
    if kernel == "K1":
        return (2 * b * c * hw + b * k2 * hw) * itemsize, fp32, tc, 0.0
    if kernel == "K2":
        return (4 * b * c * hw + b * k2 * hw) * itemsize, fp32, tc, 0.0
    cin = 2 * c + k2
    params = (c * cin * 9 + 3 * c) * 4
    conv = 2 * cin * 9 * c * hw * b
    nbytes = 3 * b * c * hw * itemsize + params
    if itemsize == 2:
        return nbytes, fp32, tc + conv, 0.0
    return nbytes, fp32, tc, 3 * conv


def ncc_work(n: int, h: int, w: int, window: int = 9) -> tuple[float, float, float]:
    """K4: float32 I, J -> the NCC map. Five separable box sums (2(window-1)
    adds a pixel each), three products and about 20 operations of the
    closing arithmetic a pixel."""
    px = n * h * w
    return 3 * px * 4, px * (3 + 5 * 2 * (window - 1) + 20), 0.0


def ncc_loss_work(n: int, h: int, w: int, window: int = 9,
                  itemsize: int = 4) -> tuple[float, float, float]:
    """K4 in loss mode: I, J -> 1 - mean(clamp(cc)). It reads I and J (8
    bytes a pixel in float32) and writes no map; the map's operations, plus
    a clamp and an add a pixel."""
    px = n * h * w
    return 2 * px * itemsize, ncc_work(n, h, w, window)[1] + 2 * px, 0.0


def norm_act_work(n: int, c: int, h: int, w: int, itemsize: int) -> tuple[float, float, float]:
    """K5: x -> InstanceNorm + affine + LeakyReLU (sum and sum of squares,
    then a multiply-add, a compare and a multiply: about 7 operations an
    element)."""
    el = n * c * h * w
    return 2 * el * itemsize, 7 * el, 0.0


def native_norm_act_work(n: int, c: int, h: int, w: int,
                         backward: bool = False) -> tuple[float, float, float]:
    """K7: float32 z -> y = LeakyReLU(InstanceNorm(z)) and each plane's mean
    and rstd (2 passes of the tensor: mean, the two-pass variance, then a
    subtract, two multiply-adds, a compare and a multiply: about 10
    operations an element); K7 dx: z, dy, mean, rstd -> dz and two sums a
    plane (3 passes; about 14 operations an element)."""
    el, planes = n * c * h * w, n * c
    if backward:
        return 3 * el * 4 + 4 * planes * 4, 14 * el, 0.0
    return 2 * el * 4 + 2 * planes * 4, 10 * el, 0.0


def unet_native_work(backward: bool = False) -> tuple[float, float, float]:
    """K7's (with ``backward``, K7 dx's) work summed over the 26 blocks of
    one Task002 2d U-Net training step at batch 40."""
    return _summed([(native_norm_act_work(UNET_TRAIN_BATCH, *shape, backward), count)
                    for shape, count in UNET_K5_SHAPES])


def conv3x3_work(n: int, h: int, w: int, cin: int, cout: int, itemsize: int,
                 bias: bool = True) -> tuple[float, float, float, float]:
    """K6: a stride-1 3x3 SAME conv (+ bias), x and the float32 weight (and
    bias) -> y, as (bytes, FP32 FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs).
    bf16 multiply-adds count on the bf16 tensor cores, float32 ones as
    3xTF32 (three TF32 products each)."""
    px = n * h * w
    flops = 2 * 9 * cin * cout * px
    nbytes = px * (cin + cout) * itemsize + (9 * cin + bias) * cout * 4
    return (nbytes, 0.0, flops, 0.0) if itemsize == 2 else (nbytes, 0.0, 0.0, 3 * flops)


def _summed(works) -> tuple[float, ...]:
    """The sum over (work tuple, launches) pairs of launches x work."""
    return tuple(sum(count * work[i] for work, count in works) for i in range(len(works[0][0])))


def unet_forward_work(kernel: str, itemsize: int) -> tuple[float, ...]:
    """K5's (bytes, FP32 FLOPs, tensor-core FLOPs), or K6's (bytes, FP32
    FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs), summed over the launches of
    one Task002 2d U-Net forward at the serving batch."""
    if kernel == "K5":
        return _summed([(norm_act_work(UNET_BATCH, *shape, itemsize), count)
                        for shape, count in UNET_K5_SHAPES])
    return _summed([(conv3x3_work(UNET_BATCH, h, w, ci, co, itemsize), count)
                    for (ci, co, h, w), count in UNET_K6_SHAPES])


def unet_train_work(kernel: str, itemsize: int = 4) -> tuple[float, ...]:
    """(bytes, FP32 FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs) of K6's
    forward ("K6") or its dx ("K6_dx") summed over the launches of one
    Task002 2d U-Net training step at batch 40."""
    return _summed([(conv3x3_work(UNET_TRAIN_BATCH, h, w, ci, co, itemsize, bias=kernel == "K6"),
                     count)
                    for (ci, co, h, w), count in (UNET_K6_SHAPES if kernel == "K6"
                                                  else UNET_K6_DX_SHAPES)])


def unet3d_work(kernel: str, itemsize: int = 4, batch: int | None = None) -> tuple[float, ...]:
    """(bytes, FP32 FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs) of K6's z-tap
    launches ("K6", a forward at ``batch``, by default the serving batch)
    or their dx ("K6_dx", a training step, by default batch 2) in the
    Task002 3d_fullres U-Net, summed over the launches."""
    if batch is None:
        batch = UNET3D_SERVING_BATCH if kernel == "K6" else UNET3D_TRAIN_BATCH
    shapes = UNET3D_K6_SHAPES if kernel == "K6" else UNET3D_K6_DX_SHAPES
    return _summed([(conv3x3_work(batch * UNET3D_DEPTH, h, w, ci, co, itemsize, bias=False), n)
                    for (ci, co, h, w), n in shapes])


def fp32_cores_note(work) -> tuple[float, str]:
    """The bound of float32 K6 work (its 3xTF32 FLOPs / 3) on the FP32 cores,
    where K6 ran before it moved to the tensor cores: a note beside its bound."""
    return bound_ms(work[0], work[3] / 3)


def unet_forward_conv_flops(batch: int = UNET_BATCH, patch=(320, 256), levels: int = 7,
                            classes: int = 2) -> float:
    """FLOPs of every convolution of one Task002 2d U-Net forward: the 3x3
    convs of all 13 stages, the 2x2 transposed convs and the 1x1 heads."""
    feats = [min(32 * 2 ** lv, 480) for lv in range(levels)]
    px = [batch * (patch[0] >> lv) * (patch[1] >> lv) for lv in range(levels)]
    flops = 0.0
    for lv in range(levels):  # encoder stages and the bottleneck
        cin = 1 if lv == 0 else feats[lv - 1]
        flops += 2 * 9 * (cin + feats[lv]) * feats[lv] * px[lv]
    for lv in range(levels - 1):  # decoder: transposed conv, two convs, head
        flops += 2 * 4 * feats[lv + 1] * feats[lv] * px[lv + 1]
        flops += 2 * 9 * (2 * feats[lv] + feats[lv]) * feats[lv] * px[lv]
        flops += 2 * feats[lv] * classes * px[lv]
    return flops


def rows() -> list[tuple[str, str, float, str]]:
    """(kernel, shapes, bound ms, bound by) of every TPU kernel of the repo."""
    out = []
    for name, b in (("K1", 8), ("K2", 4), ("K3", 8)):
        work = [corr_work(name, b, c, h, w, 2) for c, h, w, _ in SEGFLOW_LEVELS]
        total = [sum(x) for x in zip(*work)]
        out.append((name, f"bf16, B={b}, summed over the three SegFlow levels",
                    *bound_ms(*total)))
    for name in ("K1", "K3"):
        work = [corr_work(name, 8, c, h, w, 4) for c, h, w, _ in SEGFLOW_LEVELS]
        out.append((name, "note: f32, B=8, summed over the three SegFlow levels"
                    f"{' (the conv as 3xTF32)' if name == 'K3' else ''}",
                    *bound_ms(*[sum(x) for x in zip(*work)])))
    for n, what in K4_SHAPES:
        out.append(("K4", f"f32, {n} maps of 128x128 ({what})", *bound_ms(*ncc_work(n, 128, 128))))
        out.append(("K4", f"f32 loss (no map), {n} planes of 128x128 ({what})",
                    *bound_ms(*ncc_loss_work(n, 128, 128))))
    for name, n in (("K5", 26), ("K6", 7)):
        out.append((name, f"f32{' as 3xTF32' if name == 'K6' else ''}, the {n} launches of "
                    "one Task002 2d U-Net serving forward (batch 32, 320x256)",
                    *bound_ms(*unet_forward_work(name, 4))))
    for name, what in (("K6", "forward"), ("K6_dx", "dx")):
        out.append((name, f"f32 as 3xTF32, the {what} launches of one Task002 2d U-Net "
                    "training step (batch 40, 320x256)", *bound_ms(*unet_train_work(name))))
    for name, what in (("K6", "serving forward"), ("K6", "training forward"),
                       ("K6_dx", "training dx")):
        work = unet_forward_work(name, 4) if what == "serving forward" else unet_train_work(name)
        out.append((name, f"note: f32 on the FP32 cores, the {what} launches (the bound "
                    "before K6 ran on the tensor cores)", *fp32_cores_note(work)))
    for name, what in (("K6", "serving forward"), ("K6_dx", "training dx")):
        work = unet_forward_work(name, 2) if name == "K6" else unet_train_work(name, 2)
        out.append((name, f"note: bf16, the {what} launches", *bound_ms(*work)))
    for name, what in (("K6", "the 17 z-tap launches of one Task002 3d_fullres serving "
                               "forward (1 tile x 8 mirrors of 80x192x160)"),
                       ("K6_dx", "the 16 z-tap dx launches of one Task002 3d_fullres training "
                                 "step (batch 2)")):
        out.append((name, f"f32 as 3xTF32, {what}", *bound_ms(*unet3d_work(name))))
        out.append((name, f"note: bf16, {what}", *bound_ms(*unet3d_work(name, 2))))
    for name, backward in (("K7", False), ("K7_dx", True)):
        out.append((name, "f32, the 26 launches of one Task002 2d U-Net training step (batch 40, "
                    "320x256)", *bound_ms(*unet_native_work(backward))))
    # the training shapes the first table used, kept as a note
    out.append(("K5", "note: bf16, (40, 32, 320, 256) (Task002 2d U-Net training batch, "
                "first stage)", *bound_ms(*norm_act_work(40, 32, 320, 256, 2))))
    out.append(("K6", "note: bf16, 2 x 80 planes of 192x160, 32 -> 32 channels (Task002 "
                "3d_fullres U-Net, first stage)", *bound_ms(*conv3x3_work(160, 192, 160, 32,
                                                                         32, 2))))
    return out


def main() -> int:
    for name, shapes, ms, by in rows():
        print(f"{name}: bound {ms:.6f} ms ({by}) at {shapes}")
    total, k6 = unet_forward_conv_flops(), unet_forward_work("K6", 4)[3] / 3
    print(f"U-Net: one Task002 2d serving forward (batch 32, 320x256) does {total / 1e9:.3f} "
          f"GFLOP of convolutions, {k6 / 1e9:.3f} of them in K6; float32 on the FP32 cores: "
          f"{bound_ms(0.0, total)[0]:.6f} ms; as 3xTF32 on the tensor cores: "
          f"{bound_ms(0.0, 0.0, 0.0, 3 * total)[0]:.6f} ms")
    train = unet_forward_conv_flops(UNET_TRAIN_BATCH)
    k6_train = sum(unet_train_work(k)[3] / 3 for k in ("K6", "K6_dx"))
    print(f"U-Net training step (batch 40, 320x256): {train / 1e9:.3f} GFLOP of convolutions "
          f"forward, about {3 * train / 1e9:.3f} with the backward (dx and dw each as the "
          f"forward); K6 forward + dx {k6_train / 1e9:.3f}; float32 on the FP32 cores: "
          f"{bound_ms(0.0, 3 * train)[0]:.6f} ms; as 3xTF32 on the tensor cores: "
          f"{bound_ms(0.0, 0.0, 0.0, 9 * train)[0]:.6f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
