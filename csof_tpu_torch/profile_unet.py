#!/usr/bin/env python3
"""Profile one nnU-Net Task002 2d serving forward of the PyTorch port on a
CUDA device.

    python3 -m csof_tpu_torch.profile_unet [out.txt]

The forward ``predict_2d_stack`` runs: batch 32 (8 tiles x 4 mirrors) of
320x256, float32, the full-width U-Net of ``task002_heart_2d`` (2 classes,
random weights from a seed) with kernels K5 and K6 on (``fused_norm_act``,
``conv_impl="pallas"``). Prints the device-time table (torch.profiler) and
the summary line of ``profile_serving``: the forward's host-clock time
without the profiler (median of 10 after 3 warm-up forwards), the device
events of one profiled forward, their summed time, the device's busy time
and the busy share. The summary and the table also go to out.txt.
"""

import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.plans import task002_heart_2d
from csof_tpu_torch.models.unet import unet_from_plans
from csof_tpu_torch.profile_serving import device_summary, forward_ms, report

BATCH, PATCH = 32, (320, 256)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_unet: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    net = unet_from_plans(task002_heart_2d(), fused_norm_act=True, conv_impl="pallas",
                          generator=torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(BATCH, 1, *PATCH)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            net(x)
        wall = forward_ms(net, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    summary, table = device_summary(prof, wall, "forward")
    report(f"{summary} ({torch.cuda.get_device_name(0)})", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
