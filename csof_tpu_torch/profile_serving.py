#!/usr/bin/env python3
"""Profile one SegFlow serving forward of the PyTorch port on a CUDA device.

    python3 -m csof_tpu_torch.profile_serving [out.txt]

Bench geometry (8 cines x 12 frames x 128^2, bfloat16, fused_cm, random
weights from a seed). Prints the device-time table (torch.profiler) and a
summary line: the forward's host-clock time without the profiler (median of
10), the summed kernel time of one profiled forward, the device's busy time
(the union of the kernels' intervals) and the busy share (busy time over the
unprofiled forward time), and the launches of each hand-written kernel in
the profiled forward. The summary and the table also go to out.txt. The
model reads the kernel switches as the JAX package does:
``CSOF_CONV2D_IMPL=pallas`` runs SegFlow's routed convs as K6.
"""

import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.inference.serving import apply_serving_config
from csof_tpu_torch.models.blocks import kernel_switches
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from csof_tpu_torch.utils import profiling


def forward_ms(model, video, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(video)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_summary(prof, wall_ms: float, what: str) -> tuple[str, str]:
    """(summary line, kernel table) of a profile of one ``what`` whose
    unprofiled host-clock time is ``wall_ms``: the device events
    (``profiling.device_kernels``), their summed time, the busy time (union
    of their intervals) and the busy share of ``wall_ms``."""
    kernels = profiling.device_kernels(prof)
    summed = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    busy = profiling.busy_ms(kernels)
    summary = (f"{what} {wall_ms:.3f} ms host clock (median of 10, no profiler); "
               f"{len(kernels)} device events, summed {summed:.3f} ms, busy {busy:.3f} ms; "
               f"busy share {busy / wall_ms:.3f}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    return summary, table


def report(summary: str, table: str, path: str | None = None) -> None:
    """Print the summary and the table; also write them to ``path``, by
    default argv[1] if given."""
    print(summary)
    print(table)
    if path is None and len(sys.argv) > 1:
        path = sys.argv[1]
    if path:
        with open(path, "w") as f:
            f.write(summary + "\n" + table + "\n")


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
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(video)
            torch.cuda.synchronize()
        launches = launch_counts()
    summary, table = device_summary(prof, wall, "forward")
    report(f"{summary}; CSOF_CONV2D_IMPL={kernel_switches(2).conv_impl}, "
           f"launches {launches} ({torch.cuda.get_device_name(0)})", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
