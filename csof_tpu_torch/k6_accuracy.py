#!/usr/bin/env python3
"""K6's float32 accuracy on the card across Ci, and its time at the U-Net's
shapes.

    python3 -m csof_tpu_torch.k6_accuracy

Accuracy: for Ci 1 to 256 and Co 32, 64, 128 (4 x 64 x 96 inputs, drawn as
``chip_smoke.py`` draws them: x ~ N(0, 1), a He-scaled weight, bias ~
N(0, 0.1)), the kernel and its plain version (``conv3x3_plain``: cuDNN with
TF32 off) are each held against a float64 convolution of the same float32
inputs. Each line gives max |ref|, and for both the max and RMS error and the
mean error along sign(ref) (negative: a pull toward zero, as an accumulator
that truncates gives). Time: the kernel's CUDA-event median (its weight
packing included) at the float32 and bf16 shapes of one Task002 2d U-Net
serving forward (batch 32) and of the dx of one training step (batch 40),
each summed over its launches. Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from csof_tpu_torch.bounds import (UNET_BATCH, UNET_K6_DX_SHAPES, UNET_K6_SHAPES,
                                   UNET_TRAIN_BATCH)
from csof_tpu_torch.ops.kernels import conv as k6

CIS, COS = (1, 8, 32, 64, 128, 256), (32, 64, 128)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(max abs, RMS, mean along sign(ref)) of got - ref, in float64."""
    d = got.double() - ref
    return (float(d.abs().max()), float(d.square().mean().sqrt()),
            float((d * ref.sign()).mean()))


def accuracy() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for co in COS:
        for ci in CIS:
            x = torch.randn(4, ci, 64, 96, generator=gen, device="cuda")
            w = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * ci)) ** 0.5
            b = torch.randn(co, generator=gen, device="cuda") * 0.1
            ref = F.conv2d(x.double(), w.double(), b.double(), padding=1)
            kern = errors(k6.conv3x3_cuda(x, w, b), ref)
            plain = errors(k6.conv3x3_plain(x, w, b), ref)
            print(f"[accuracy] float32 Ci {ci:3d} Co {co:3d}: max|ref| {float(ref.abs().max()):.3f}; "
                  "vs float64: kernel max {:.3e} rms {:.3e} signed {:+.3e}; "
                  "plain max {:.3e} rms {:.3e} signed {:+.3e}".format(*kern, *plain), flush=True)


def timing() -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for what, batch, shapes, dx in (("forward", UNET_BATCH, UNET_K6_SHAPES, False),
                                        ("dx", UNET_TRAIN_BATCH, UNET_K6_DX_SHAPES, True)):
            total, parts = 0.0, []
            for (ci, co, h, w), count in shapes:
                x = torch.randn(batch, ci, h, w, generator=gen, device="cuda").to(dtype)
                if dx:  # the dx launch (Ci', Co') is the conv (Co, Ci)'s: weight (Ci', Co', 3, 3)
                    wt = torch.randn(ci, co, 3, 3, generator=gen, device="cuda") * 0.05
                    ms = median_ms(lambda: k6.conv3x3_dx_cuda(x, wt))
                else:
                    wt = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * 0.05
                    b = torch.randn(co, generator=gen, device="cuda") * 0.1
                    ms = median_ms(lambda: k6.conv3x3_cuda(x, wt, b))
                total += count * ms
                parts.append(f"{ci}->{co} {h}x{w} {ms:.4f}")
            name = str(dtype).removeprefix("torch.")
            print(f"[time] K6 {what} {name}: {total:.4f} ms over the launches of one "
                  f"{'training step' if dx else 'serving forward'} ({'; '.join(parts)})",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_accuracy needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}", flush=True)
    accuracy()
    timing()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
