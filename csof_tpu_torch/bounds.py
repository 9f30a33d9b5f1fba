#!/usr/bin/env python3
"""The least time an NVIDIA H100 could take for the work of each TPU kernel
of the repo, from its shapes and the card's data-sheet peaks.

    python3 -m csof_tpu_torch.bounds

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate of the fastest unit that can do them (a
multiply-add is 2). bf16 work counts on the bf16 tensor cores: convolutions,
and the correlation's window products too, which a kernel can run as one
banded GEMM per window row. float32 work counts on the FP32 cores.
Pure arithmetic: it needs no card. ``chip_smoke.py`` computes the bounds of
the ported kernels with the same functions at the shapes it times.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, 700 W): HBM bytes/s, FP32-core and
#: bf16 tensor-core FLOP/s
HBM_BPS, FP32_FLOPS, BF16_TC_FLOPS = 3.35e12, 67e12, 989e12
RADIUS = 4
#: (C, H, W, stride) of the three SegFlow skip levels at the 128^2 ROI
SEGFLOW_LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]


def bound_ms(nbytes: float, fp32_flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS
    t_ops = fp32_flops / FP32_FLOPS + tc_flops / BF16_TC_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def corr_work(kernel: str, b: int, c: int, h: int, w: int,
              itemsize: int) -> tuple[float, float, float]:
    """(bytes, FP32 FLOPs, tensor-core FLOPs) of one call of K1 (q, m ->
    corr), K2 (q, m, g -> dq, dm) or K3 (q, m, float32 conv and norm
    parameters -> out) at one level, radius 4, in float32 (itemsize 4) or
    bf16 (itemsize 2). The window products of a bf16 call count as
    tensor-core FLOPs, those of a float32 call as FP32 FLOPs."""
    k2, hw = (2 * RADIUS + 1) ** 2, h * w
    corr_flops = 2 * k2 * c * hw * b * (2 if kernel == "K2" else 1)
    fp32, tc = (0.0, corr_flops) if itemsize == 2 else (corr_flops, 0.0)
    if kernel == "K1":
        return (2 * b * c * hw + b * k2 * hw) * itemsize, fp32, tc
    if kernel == "K2":
        return (4 * b * c * hw + b * k2 * hw) * itemsize, fp32, tc
    cin = 2 * c + k2
    params = (c * cin * 9 + 3 * c) * 4
    return 3 * b * c * hw * itemsize + params, fp32, tc + 2 * cin * 9 * c * hw * b


def ncc_work(n: int, h: int, w: int, window: int = 9) -> tuple[float, float, float]:
    """K4: float32 I, J -> the NCC map. Five separable box sums (2(window-1)
    adds a pixel each), three products and about 20 operations of the
    closing arithmetic a pixel."""
    px = n * h * w
    return 3 * px * 4, px * (3 + 5 * 2 * (window - 1) + 20), 0.0


def norm_act_work(n: int, c: int, h: int, w: int, itemsize: int) -> tuple[float, float, float]:
    """K5: x -> InstanceNorm + affine + LeakyReLU (sum and sum of squares,
    then a multiply-add, a compare and a multiply: about 7 operations an
    element)."""
    el = n * c * h * w
    return 2 * el * itemsize, 7 * el, 0.0


def conv3x3_work(n: int, h: int, w: int, cin: int, cout: int,
                 itemsize: int) -> tuple[float, float, float]:
    """K6: a stride-1 3x3 SAME conv, x and weights -> y, on tensor cores."""
    px = n * h * w
    return (px * (cin + cout) + 9 * cin * cout) * itemsize, 0.0, 2 * 9 * cin * cout * px


def rows() -> list[tuple[str, str, float, str]]:
    """(kernel, shapes, bound ms, bound by) of every TPU kernel of the repo."""
    out = []
    for name, b in (("K1", 8), ("K2", 4), ("K3", 8)):
        work = [corr_work(name, b, c, h, w, 2) for c, h, w, _ in SEGFLOW_LEVELS]
        total = [sum(x) for x in zip(*work)]
        out.append((name, f"bf16, B={b}, summed over the three SegFlow levels",
                    *bound_ms(*total)))
    out.append(("K4", "f32, 20 maps of 128x128 (one SegFlow train loss: B=4 x 5 frames)",
                *bound_ms(*ncc_work(20, 128, 128))))
    out.append(("K5", "bf16, (40, 32, 320, 256) (Task002 2d U-Net, first stage)",
                *bound_ms(*norm_act_work(40, 32, 320, 256, 2))))
    out.append(("K6", "bf16, 2 x 80 planes of 192x160, 32 -> 32 channels (Task002 "
                "3d_fullres U-Net, first stage)", *bound_ms(*conv3x3_work(160, 192, 160, 32,
                                                                         32, 2))))
    return out


def main() -> int:
    for name, shapes, ms, by in rows():
        print(f"{name}: bound {ms:.6f} ms ({by}) at {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
