#!/usr/bin/env python3
"""Profile one nnU-Net Task002 2d serving forward, or one training step, of
the PyTorch port on a CUDA device.

    python3 -m csof_tpu_torch.profile_unet [--3d] [out.txt]
    python3 -m csof_tpu_torch.profile_unet --train [--3d] [out.txt]

Serving: the forward ``predict_2d_stack`` runs, batch 32 (8 tiles x 4
mirrors) of 320x256, float32, the full-width U-Net of ``task002_heart_2d``
(2 classes, random weights from a seed) with kernels K5 and K6 on
(``fused_norm_act``, ``conv_impl="pallas"``).

Training (``--train``): ``Trainer.run_iteration`` of the same U-Net at its
training batch, 40 of 320x256, float32, SGD-Nesterov + poly, clip 12, K6
forward and dx on (``CSOF_CONV2D_IMPL=pallas``; K5 has no backward and stays
off), on a batch drawn from a seed. Besides the table it prints the device
time of the step's kernels in groups by kernel name (K6 forward, K6 dx,
cuDNN dgrad and wgrad, other convolutions, elementwise, reductions, the
optimizer) and the step's ``csof:train.*`` spans in the profiled step
(``profiling.span_times``): each phase's host ms and the device ms of the
work launched in it.

``--3d``: the Task002 3d_fullres U-Net of ``task002_heart_3d`` instead
(2 classes, base 32, cap 320, float32, remat at its default, ``save_conv``),
with K6 in the z taps (``CSOF_CONV2D_IMPL=pallas``): a serving forward of
``TILE_BATCH_3D`` tiles x 8 mirrors of 80x192x160 (``predict_case``'s tile
batch for 3-D plans), or a training step at batch 2; the peak device memory
(``max_memory_allocated``) beside the summary.

Both print the device-time table (torch.profiler) and the summary line of
``profile_serving``: the host-clock time without the profiler (median of 10
after 3 warm-ups), the device events of one profiled run, their summed time,
the device's busy time and the busy share. The summary and the table also go
to out.txt.
"""

import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.plans import task002_heart_2d, task002_heart_3d
from csof_tpu_torch.inference.predictor import TILE_BATCH_3D
from csof_tpu_torch.models.unet import unet_from_plans
from csof_tpu_torch.profile_serving import device_summary, forward_ms, report
from csof_tpu_torch.utils import profiling

BATCH, PATCH = 32, (320, 256)
TRAIN_BATCH = 40
#: 3d_fullres: serving forward batch (predict_case's tiles x 8 mirrors),
#: training batch, patch
BATCH_3D, TRAIN_BATCH_3D, PATCH_3D = 8 * TILE_BATCH_3D, 2, (80, 192, 160)
#: device kernels grouped by the first name fragment they contain
TRAIN_GROUPS = [
    ("K6 dx (conv3x3_dx_kernel)", ("conv3x3_dx_kernel",)),
    ("K6 forward (conv3x3_kernel)", ("conv3x3_kernel",)),
    ("K7 dx (inorm_lrelu_bwd_*)", ("inorm_lrelu_bwd",)),
    ("K7 (inorm_lrelu_fwd_*)", ("inorm_lrelu_fwd",)),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("other convolutions (cuDNN forward, FFT, transposed)",
     ("fprop", "fft", "convolve", "conv", "gemm", "xmma")),
    ("optimizer (multi-tensor apply)", ("multi_tensor", "foreach")),
    ("reductions (norm statistics, loss, clip norm)", ("reduce",)),
    ("elementwise (norms, LeakyReLU, loss, casts)", ("elementwise", "vectorized", "unrolled")),
]


def grouped_device_time(prof) -> list[tuple[str, float, int]]:
    """(group, ms, kernels) of the profile's device kernels by TRAIN_GROUPS,
    the rest as "other"."""
    sums = {name: [0.0, 0] for name, _ in TRAIN_GROUPS}
    sums["other"] = [0.0, 0]
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        group = next((name for name, keys in TRAIN_GROUPS if any(k in e.name for k in keys)),
                     "other")
        sums[group][0] += e.time_range.elapsed_us() / 1e3
        sums[group][1] += 1
    return [(name, ms, n) for name, (ms, n) in sums.items()]


def peak_gib() -> str:
    return f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def train_main(out_path, three_d: bool = False) -> int:
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.training.trainer import Trainer

    os.environ["CSOF_CONV2D_IMPL"] = "pallas"
    os.environ.pop("CSOF_FUSED_NORM", None)
    batch_n, patch = (TRAIN_BATCH_3D, PATCH_3D) if three_d else (TRAIN_BATCH, PATCH)
    config = ExperimentConfig(model="unet3d" if three_d else "unet2d", optim=OptimConfig(
        optimizer="sgd", scheduler="poly", initial_lr=1e-2, weight_decay=3e-5),
        data=DataConfig(do_data_aug=False))
    rng = np.random.RandomState(0)
    seg = np.zeros((batch_n, *patch), np.int32)
    seg[..., 100:200, 80:150 if three_d else 170] = 1
    batch = {"data": (rng.randn(batch_n, *patch, 1) + seg[..., None]).astype(np.float32),
             "seg": seg}
    plans = task002_heart_3d() if three_d else task002_heart_2d()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, tmp, plans=plans, device="cuda").initialize()
        for _ in range(3):
            trainer.run_iteration(batch)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_iteration(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run_iteration(batch)
            torch.cuda.synchronize()
    wall = statistics.median(times)
    summary, table = device_summary(prof, wall, "train step")
    groups = grouped_device_time(prof)
    spans = profiling.span_times(prof)
    rate = (f"{batch_n / wall * 1e3:.3f} train patches/s" if three_d
            else f"{TRAIN_BATCH / wall * 1e3:.2f} train slices/s")
    lines = [f"{summary}; {rate} unprofiled; {peak_gib()} ({torch.cuda.get_device_name(0)})",
             "device time by kernel group (ms, kernels): "
             + "; ".join(f"{name} {ms:.3f} ({n})" for name, ms, n in groups),
             "spans of the profiled step (host ms / device ms): "
             + "; ".join(f"{k} {v['host_ms']:.3f} / {v['device_ms']:.3f}"
                         for k, v in spans.items())]
    report("\n".join(lines), table, out_path)
    return 0


def main() -> int:
    args = sys.argv[1:]
    train, three_d = "--train" in args, "--3d" in args
    args = [a for a in args if a not in ("--train", "--3d")]
    out_path = args[0] if args else None
    if not torch.cuda.is_available():
        print("profile_unet: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    if train:
        return train_main(out_path, three_d)
    plans, shape = ((task002_heart_3d(), (BATCH_3D, 1, *PATCH_3D)) if three_d
                    else (task002_heart_2d(), (BATCH, 1, *PATCH)))
    net = unet_from_plans(plans, fused_norm_act=True, conv_impl="pallas",
                          generator=torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            net(x)
        wall = forward_ms(net, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    summary, table = device_summary(prof, wall, "forward")
    report(f"{summary}; {peak_gib()} ({torch.cuda.get_device_name(0)})", table, out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
