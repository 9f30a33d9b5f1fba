#!/usr/bin/env python3
"""Time K1 (local correlation) and K3 (skip fuse) at the three SegFlow
levels on a CUDA device.

    python3 -m csof_tpu_torch.kernel_times [out.json]

B = 8, radius 4, (C, H, W, stride) = (32, 128, 128, 2), (64, 64, 64, 1),
(128, 32, 32, 1), bfloat16 and float32, random inputs from a seed. For each
kernel and dtype: the CUDA-event median of 20 calls after 3 warm-up calls
(host launch gaps included), and the device time of the kernels one call
launches (torch.profiler, the mean of 10 calls), per level and summed over
the levels. Prints one JSON object (also written
to out.json) with the card's name and power limit. Only the wrappers'
public entry points are called (``corr_cuda``, ``skip_fuse_cuda``), so the
same script times any tree of the port that has them, for a before/after
comparison in one call.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
BATCH, RADIUS = 8, 4


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
    a warm-up): the call's time without the host's launch gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            key = group(e.name)
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


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
    line = json.dumps(out)
    print(line)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
