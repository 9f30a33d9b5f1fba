#!/usr/bin/env python3
"""Profile one SegFlow serving forward of the PyTorch port on a CUDA device.

    python3 -m csof_tpu_torch.profile_serving [out.txt]

Bench geometry (8 cines x 12 frames x 128^2, bfloat16, fused_cm, random
weights from a seed). Prints the device-time table (torch.profiler) and a
summary line: the forward's host-clock time without the profiler (median of
10), the summed kernel time of one profiled forward, the device's busy time
(the union of the kernels' intervals) and the busy share (busy time over the
unprofiled forward time). The summary and the table also go to out.txt.
"""

import statistics
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.inference.serving import apply_serving_config
from csof_tpu_torch.models.segflow import SegFlow


def forward_ms(model, video, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(video)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    cfg = apply_serving_config(SegFlowModelConfig(), 12)
    model = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(0)).cuda().eval()
    video = torch.from_numpy(np.random.RandomState(0).rand(8, 12, 128, 128, 1)
                             .astype(np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            model(video)
        wall = forward_ms(model, video)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(video)
            torch.cuda.synchronize()
    # device-side events, each kernel once (the aten ops' rows repeat the
    # time of the kernels they launch; user annotations are ranges, not work)
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    summed = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    summary = (f"forward {wall:.3f} ms host clock (median of 10, no profiler); "
               f"{len(kernels)} device events, summed {summed:.3f} ms, busy {busy:.3f} ms; "
               f"busy share {busy / wall:.3f}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    print(summary)
    print(table)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(summary + "\n" + table + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
