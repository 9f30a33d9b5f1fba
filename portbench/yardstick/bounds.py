"""The least time an NVIDIA H100 could take for one launch of a hand-written
kernel, from its shapes and the card's data-sheet peaks.

A frozen copy of the port's bound arithmetic, kept with the benchmark so
that a later change to the program cannot move its own yardstick. A bound is
the larger of two times: the bytes the call must move (each input read once,
each output written once) over the HBM rate, and its operations over the
peak rate of the unit that can do them (a multiply-add is 2). bf16 products,
the correlation's window products included, count on the bf16 tensor cores;
float32 convolutions count as 3xTF32 (three TF32 products for float32
accuracy, as K6 and K3's conv pass run them); other float32 work on the FP32
cores.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, 700 W): HBM bytes/s, FP32-core,
#: bf16 tensor-core and TF32 tensor-core FLOP/s
HBM_BPS, FP32_FLOPS, BF16_TC_FLOPS, TF32_TC_FLOPS = 3.35e12, 67e12, 989e12, 495e12
#: the whole step's ceiling for ``mfu``: bf16 on the tensor cores; float32
#: as 3xTF32, the TF32 peak over its three products (the FP32 cores' 67
#: TFLOP/s is no ceiling, since 3xTF32 runs past it)
MFU_PEAK_FLOPS = {"bfloat16": BF16_TC_FLOPS, "float32": TF32_TC_FLOPS / 3}


def bound_s(nbytes: float, fp32_flops: float, tc_flops: float = 0.0,
            tf32_flops: float = 0.0) -> float:
    """Seconds: max(bytes / HBM rate, the operations at their units' peaks)."""
    t_ops = fp32_flops / FP32_FLOPS + tc_flops / BF16_TC_FLOPS + tf32_flops / TF32_TC_FLOPS
    return max(nbytes / HBM_BPS, t_ops)


def corr_work(kernel: str, b: int, c: int, h: int, w: int, itemsize: int,
              radius: int = 4) -> tuple[float, float, float, float]:
    """(bytes, FP32 FLOPs, bf16 tensor-core FLOPs, TF32 FLOPs) of one call of
    K1 (q, m -> corr) or K3 (q, m, the float32 conv and norm parameters ->
    out: the correlation, the 3x3 conv over the concat of q, m and the
    correlation, GroupNorm and LeakyReLU) at one level."""
    k2, hw = (2 * radius + 1) ** 2, h * w
    corr_flops = 2 * k2 * c * hw * b
    fp32, tc = (0.0, corr_flops) if itemsize == 2 else (corr_flops, 0.0)
    if kernel == "K1":
        return (2 * b * c * hw + b * k2 * hw) * itemsize, fp32, tc, 0.0
    cin = 2 * c + k2
    params = (c * cin * 9 + 3 * c) * 4
    conv = 2 * cin * 9 * c * hw * b
    nbytes = 3 * b * c * hw * itemsize + params
    if itemsize == 2:
        return nbytes, fp32, tc + conv, 0.0
    return nbytes, fp32, tc, 3 * conv


def conv3x3_work(n: int, h: int, w: int, cin: int, cout: int, itemsize: int,
                 bias: bool = True) -> tuple[float, float, float, float]:
    """K6 (or its dx, which is K6 on dy without bias): a stride-1 3x3 SAME
    conv, x and the float32 weight (and bias) -> y."""
    px = n * h * w
    flops = 2 * 9 * cin * cout * px
    nbytes = px * (cin + cout) * itemsize + (9 * cin + bias) * cout * 4
    return (nbytes, 0.0, flops, 0.0) if itemsize == 2 else (nbytes, 0.0, 0.0, 3 * flops)


def norm_act_work(n: int, c: int, hw: int, itemsize: int) -> tuple[float, float, float, float]:
    """K5: x -> InstanceNorm + affine + LeakyReLU, about 7 operations an element."""
    el = n * c * hw
    return 2 * el * itemsize, 7 * el, 0.0, 0.0
