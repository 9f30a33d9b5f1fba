#!/usr/bin/env python3
"""Time K1 (local correlation), K3 (skip fuse), K2 (correlation backward)
and K5 (InstanceNorm + LeakyReLU) at their path's shapes on a CUDA device.

    python3 -m csof_tpu_torch.kernel_times [out.json] [--k5-plans]

K1, K3: B = 8, radius 4, (C, H, W, stride) = (32, 128, 128, 2), (64, 64, 64,
1), (128, 32, 32, 1); K2: the same levels at the SegFlow training batch, B =
4; K5: the 26 launches of one Task002 2d U-Net forward (batch 32, every
``UNET_K5_SHAPES`` entry times its launches). bfloat16 and float32, random
inputs from a seed. For each kernel and dtype: the CUDA-event median of 20
calls after 3 warm-up calls (host launch gaps included), and the device time
of the kernels one call launches (torch.profiler, the mean of 10 calls), per
shape and summed (K5: weighted by launches). Prints one JSON object (also
written to out.json) with the card's name and power limit. Only the
wrappers' public entry points are called (``corr_cuda``, ``skip_fuse_cuda``,
``corr_bwd_cuda``, ``norm_act_cuda``), so the same script times any tree of
the port that has them, for a before/after comparison in one call.
``--k5-plans`` adds K5's device time at every U-Net plane under every plan
the kernel can run (this tree only).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
BATCH, TRAIN_BATCH, RADIUS = 8, 4, 4


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
    return statistics.median(times)


def device_ms(fn, reps: int = 10, group=lambda name: "all") -> dict[str, float]:
    """Device time of the kernels one call launches, summed by
    ``group(kernel name)`` (torch.profiler, the mean of ``reps`` calls after
    a warm-up): the call's time without the host's launch gaps. A trace
    that recorded no device event (seen now and then after many traces in
    one process) is taken again, up to twice; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                key = group(e.name)
                out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if out:
            return out
    raise RuntimeError("torch.profiler recorded no device event in three traces")


def k5_plan_times(gen) -> dict:
    """K5's device ms a launch at every U-Net plane (batch 32), float32 and
    bf16, under every plan the kernel can run: a warp a plane where the
    plane allows it (at most 4096 elements), and 1, 2, 4 and 8 blocks a
    plane where a block's shared memory holds the slice."""
    from csof_tpu_torch.bounds import UNET_BATCH, UNET_K5_SHAPES
    from csof_tpu_torch.ops.kernels import norm_act as k5

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (c, h, w), _ in UNET_K5_SHAPES:
            x = torch.randn(UNET_BATCH, c, h, w, generator=gen, device="cuda").to(dtype)
            scale = torch.ones(c, device="cuda")
            bias = torch.zeros(c, device="cuda")
            plans = [k5.WARP_PLAN] if h * w <= 4096 else []  # the warp path's limit
            for k in (1, 2, 4, 8):
                try:
                    plans.append(k5.cluster_plan(h * w, dtype, k))
                except ValueError:
                    pass  # a slice too large for one block's shared memory
            for plan in plans:
                key = (f"{str(dtype).removeprefix('torch.')} {(c, h, w)} {plan.path} "
                       f"{plan.cluster}")
                res[key] = device_ms(lambda: k5.launch(x, scale, bias, plan))["all"]
            del x
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card.splitlines()[0], "levels": LEVELS, "batch": BATCH}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name in ("K1", "K3"):
            per_level, per_level_device = [], []
            for c, h, w, s in LEVELS:
                q, m = (torch.randn(BATCH, c, h, w, generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                cin = 2 * c + (2 * RADIUS + 1) ** 2
                params = [torch.randn(c, cin, 3, 3, generator=gen, device="cuda")
                          * (2.0 / (9 * cin)) ** 0.5]
                params += [torch.randn(c, generator=gen, device="cuda") * 0.1 + off
                           for off in (0.0, 1.0, 0.0)]
                if name == "K1":
                    def call():
                        return k1.corr_cuda(q, m, RADIUS, s)
                else:
                    def call():
                        return k3.skip_fuse_cuda(q, m, *params, RADIUS, s)
                per_level.append(median_ms(call))
                per_level_device.append(device_ms(call)["all"])
            out[f"{name}_{dname}_ms"] = sum(per_level)
            out[f"{name}_{dname}_per_level_ms"] = per_level
            out[f"{name}_{dname}_device_ms"] = sum(per_level_device)
            out[f"{name}_{dname}_per_level_device_ms"] = per_level_device
    from csof_tpu_torch.bounds import UNET_BATCH, UNET_K5_SHAPES
    from csof_tpu_torch.ops.kernels import norm_act as k5

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        per_level, per_level_device = [], []
        for c, h, w, s in LEVELS:
            q, m = (torch.randn(TRAIN_BATCH, c, h, w, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            g = torch.randn(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w, generator=gen,
                            device="cuda").to(dtype)

            def call():
                return k1.corr_bwd_cuda(q, m, g, RADIUS, s)
            per_level.append(median_ms(call))
            per_level_device.append(device_ms(call)["all"])
        out[f"K2_{dname}_ms"] = sum(per_level)
        out[f"K2_{dname}_per_level_ms"] = per_level
        out[f"K2_{dname}_device_ms"] = sum(per_level_device)
        out[f"K2_{dname}_per_level_device_ms"] = per_level_device
        per_shape, per_shape_device = [], []
        for (c, h, w), count in UNET_K5_SHAPES:
            x = (torch.randn(UNET_BATCH, c, h, w, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.2 * torch.randn(c, generator=gen, device="cuda")

            def call():
                return k5.norm_act_cuda(x, scale, bias)
            per_shape.append(count * median_ms(call))
            per_shape_device.append(count * device_ms(call)["all"])
            del x
        out[f"K5_{dname}_ms"] = sum(per_shape)
        out[f"K5_{dname}_per_shape_ms"] = per_shape
        out[f"K5_{dname}_device_ms"] = sum(per_shape_device)
        out[f"K5_{dname}_per_shape_device_ms"] = per_shape_device
    if "--k5-plans" in sys.argv:
        out["K5_plans"] = k5_plan_times(gen)
    line = json.dumps(out)
    print(line)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
