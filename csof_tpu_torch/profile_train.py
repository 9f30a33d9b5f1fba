#!/usr/bin/env python3
"""Profile one SegFlow training step of the PyTorch port on a CUDA device.

    python3 -m csof_tpu_torch.profile_train [out.txt]

The training geometry of the JAX package's train bench: batch 4 x 6 frames x
128^2, bfloat16, the ExperimentConfig defaults (concat, AdamW under the
warm-up cosine schedule, grad-clip 12), weights and batch drawn from seeds.
One step is Trainer.run_iteration: batch to the device, forward, loss,
backward, clip, AdamW, and the read of the loss. Prints the device-time table
(torch.profiler) and the summary line of profile_serving: the step's
host-clock time without the profiler (median of 10 after 3 warm-up steps),
the device events of one profiled step, their summed time, the device's busy
time and the busy share, and the kernels' launches in the profiled step.
The summary and the table also go to out.txt. ``CSOF_CONV2D_IMPL=pallas``
(read by the trainer's build_model) runs SegFlow's routed convs as K6, both
ways.
"""

import statistics
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
from csof_tpu_torch.models.blocks import kernel_switches
from csof_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from csof_tpu_torch.profile_serving import device_summary, report
from csof_tpu_torch.training.trainer import Trainer

BATCH, FRAMES, HW = 4, 6, 128


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    config = ExperimentConfig(data=DataConfig(do_data_aug=False, batch_size=BATCH,
                                              video_length=FRAMES, crop_size=HW))
    rng = np.random.RandomState(0)
    batch = {
        "video": rng.rand(BATCH, FRAMES, HW, HW, 1).astype(np.float32),
        "seg": rng.randint(0, 4, (BATCH, FRAMES, HW, HW)).astype(np.int32),
        "labeled_mask": np.ones((BATCH, FRAMES), np.float32),
        "distance": rng.rand(BATCH, FRAMES).astype(np.float32),
    }
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, tmp, device="cuda").initialize()
        for _ in range(3):
            trainer.run_iteration(batch)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_iteration(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run_iteration(batch)
            torch.cuda.synchronize()
        launches = launch_counts()
    wall = statistics.median(times)
    summary, table = device_summary(prof, wall, "train step")
    report(f"{summary}; {BATCH * FRAMES / wall * 1e3:.2f} train frames/s unprofiled; "
           f"CSOF_CONV2D_IMPL={kernel_switches(2).conv_impl}, launches "
           f"{launches} ({torch.cuda.get_device_name(0)})", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
