#!/usr/bin/env python3
"""Profile the flow models of the PyTorch port on a CUDA device.

    python3 -m csof_tpu_torch.profile_flow [out_prefix]
    python3 -m csof_tpu_torch.profile_flow --launches

One RAFT forward at ``RaftModelConfig()`` (bf16, 12 iterations) over 8
pairs of 224^2, one VoxelMorph ``register_sequence`` at
``VoxelMorphModelConfig()`` (bf16, diffeomorphic, 7 steps) over a 17-frame
cine at 192^2, one FinalFlow forward at ``FinalFlowConfig()`` over 8 x 12
x 128^2, and one forward of MTL (conv encoder) and of the temporal model
under ``CSOF_CONV2D_IMPL=pallas`` in bf16 at phase 33's geometries, random
weights from a seed (the geometries of ``chip_smoke.py`` phases 29-31, 33). For each: the device-time table (torch.profiler), and a
summary line: the host-clock time without the profiler (median of 10), the
summed kernel time of one profiled call, the busy time (the union of its
kernels' intervals), the busy share, and the device time by group
(grid_sample: the correlation lookup's and the warps'; convs, gathers,
matmuls, elementwise and the rest). Written to
``out_prefix_{raft,voxelmorph,finalflow,mtl,temporal}.txt`` if given.

``--launches`` prints one JSON line instead: for RAFT and VoxelMorph the
host-clock ms, the device events and the busy ms of one call (``raft``,
``voxelmorph``); under ``finalflow`` the K5 and K6 kernels among the device
events of one FinalFlow forward at that geometry (``kernel_times.
device_events``), for each bottleneck and ``diffeomorphic`` under
``CSOF_CONV2D_IMPL=pallas`` and for instance norm with ``CSOF_FUSED_NORM=1``
too, beside ``FinalFlow.kernel_launches``; under ``family`` the same for
each model of :data:`FAMILY_RUNS` (MTL with the conv and the Swin encoder,
the temporal model, the deformable layer; ``chip_smoke.py`` phase 33's
geometries) in float32 and bfloat16 with both switches on, with its
host-clock ms, device events and busy ms. ``chip_smoke.py`` phases 29-31
and 33 take these from a fresh process, since a process that has taken many
traces can lose kernels from its later ones.
"""

import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.config.experiment import RaftModelConfig, VoxelMorphModelConfig
from csof_tpu_torch.models.deformable import DeformableTransformerLayer
from csof_tpu_torch.models.finalflow import FinalFlow, FinalFlowConfig
from csof_tpu_torch.models.mtl import MTLConfig, MTLModel
from csof_tpu_torch.models.raft import RAFT
from csof_tpu_torch.models.temporal import TemporalVideoSegModel
from csof_tpu_torch.models.voxelmorph import VoxelMorph, register_sequence
from csof_tpu_torch.utils import profiling

#: device-time groups, first match by kernel name (cuDNN's sampler before its convs)
GROUPS = (("grid_sample", ("grid_sampler", "bilinear_sampler")),
          ("conv (cuDNN, K6)", ("conv3x3", "cudnn", "xmma", "implicit_gemm", "fprop", "wgrad",
                                "dgrad", "nchwToNhwc", "nhwcToNchw", "cutlass")),
          ("gather / scatter", ("gather", "scatter", "index")),
          ("matmul", ("gemm", "matmul", "bmm")),
          ("norm / reduce", ("reduce", "norm", "softmax", "mean", "sum")),
          ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill",
                           "Memcpy", "Memset")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def device_trace(fn) -> tuple[float, list]:
    """(host-clock ms of fn(), median of 10 without the profiler; the
    device kernels of one profiled call), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return statistics.median(times), profiling.device_kernels(prof), prof


def profile_call(fn, what: str) -> tuple[str, str]:
    wall, kernels, prof = device_trace(fn)
    summed = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    busy = profiling.busy_ms(kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        g = group_of(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    by_group = ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(),
                                                              key=lambda kv: -kv[1]))
    summary = (f"{what}: {wall:.3f} ms host clock (median of 10, no profiler); "
               f"{len(kernels)} device events, summed {summed:.3f} ms, busy {busy:.3f} ms, "
               f"busy share {busy / wall:.3f}; by group (ms): {by_group} "
               f"({torch.cuda.get_device_name(0)})")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30)
    return summary, table


def flow_calls() -> list:
    """[(name, fn, what)]: the RAFT forward, VoxelMorph's register_sequence
    and the FinalFlow forward at chip_smoke.py's geometries, random weights
    and inputs from seed 0, on the card."""
    rng = np.random.RandomState(0)
    raft = RAFT(RaftModelConfig(), generator=torch.Generator().manual_seed(0)).cuda().eval()
    a = torch.from_numpy(rng.rand(8, 224, 224, 1).astype(np.float32)).cuda()
    b = torch.roll(a, (2, 3), (1, 2))
    vxm = VoxelMorph(VoxelMorphModelConfig(),
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    cine = torch.from_numpy(rng.rand(17, 192, 192, 1).astype(np.float32)).cuda()
    ff = FinalFlow(FinalFlowConfig(), generator=torch.Generator().manual_seed(0)).cuda().eval()
    video = torch.from_numpy(rng.rand(8, 12, 128, 128, 1).astype(np.float32)).cuda()
    mtl = family_model("mtl conv", "bfloat16", True).cuda().eval()
    images = family_inputs("mtl conv")[0].cuda()
    tv = family_model("temporal", "bfloat16", True).cuda().eval()
    cines = family_inputs("temporal")[0].cuda()
    return [("raft", lambda: raft(a, b), "RAFT forward (8, 224, 224, 1) x 2 bf16, 12 iters"),
            ("voxelmorph", lambda: register_sequence(vxm, cine),
             "VoxelMorph register_sequence (17, 192, 192, 1) bf16"),
            ("finalflow", lambda: ff(video), "FinalFlow forward (8, 12, 128, 128, 1) bf16"),
            ("mtl", lambda: mtl(images), f"MTL conv forward {tuple(images.shape)} bf16, pallas"),
            ("temporal", lambda: tv(cines), f"temporal forward {tuple(cines.shape)} bf16, pallas")]


#: the FinalFlow runs of chip_smoke.py phase 31: name -> (config, CSOF_FUSED_NORM)
FINALFLOW_RUNS = {"gru": (FinalFlowConfig(), False),
                  "3d": (FinalFlowConfig(bottleneck_type="3d"), False),
                  "transformer": (FinalFlowConfig(bottleneck_type="transformer"), False),
                  "gru diffeomorphic": (FinalFlowConfig(diffeomorphic=True), False),
                  "instance + K5": (FinalFlowConfig(norm="instance"), True)}


def finalflow_launches() -> dict:
    """{run: {"K5", "K6": device kernels of one forward, "want": the
    module's count}} under pallas, random weights, 8 x 12 x 128^2."""
    from csof_tpu_torch.kernel_times import device_events

    video = torch.from_numpy(np.random.RandomState(0).rand(8, 12, 128, 128, 1)
                             .astype(np.float32)).cuda()
    out = {}
    with torch.inference_mode():
        for name, (cfg, fused) in FINALFLOW_RUNS.items():
            model = FinalFlow(cfg, generator=torch.Generator().manual_seed(0),
                              conv_impl="pallas", fused_norm_act=fused).cuda().eval()
            events, _ = device_events(lambda: model(video), reps=1)
            out[name] = {"K5": sum("norm_act_" in e.name for e in events),
                         "K6": sum("conv3x3_kernel" in e.name for e in events),
                         "want": model.kernel_launches(12, 128)}
    return out


#: chip_smoke.py phase 33's geometries: MTL on nnU-Net's ACDC 2D patch (batch
#: 16 of 256 x 224, divisible by the Swin window at every level), the temporal
#: model on bench.py:98's cines (12 frames > its bus of 8), the deformable
#: layer at d = 128 over 32 x 32 query and value maps
MTL_B, MTL_HW = 16, (256, 224)
TEMPORAL_B, TEMPORAL_T, TEMPORAL_HW = 8, 12, 128
DEFORM_B, DEFORM_HW, DEFORM_DIM = 96, 32, 128
#: name -> (kind, norm); "instance" runs take CSOF_FUSED_NORM=1 with the conv switch
FAMILY_RUNS = {"mtl conv": ("mtl conv", "group"), "mtl swin": ("mtl swin", "group"),
               "mtl conv instance + K5": ("mtl conv", "instance"),
               "temporal": ("temporal", "group"), "temporal instance + K5": ("temporal", "instance"),
               "deformable": ("deformable", None)}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def family_model(name: str, dtype: str, switch: bool, seed: int = 0) -> torch.nn.Module:
    """The FAMILY_RUNS model ``name`` at full width on the CPU, random weights
    from ``seed``; ``switch``: CSOF_CONV2D_IMPL=pallas (and, for an
    instance-norm run, CSOF_FUSED_NORM=1), else both off."""
    kind, norm = FAMILY_RUNS[name]
    gen = torch.Generator().manual_seed(seed)
    routed = dict(conv_impl="pallas" if switch else "native",
                  fused_norm_act=switch and norm == "instance")
    if kind.startswith("mtl"):
        cfg = MTLConfig(encoder=kind.split()[1], norm=norm, reconstruction=True,
                        directional_field=True, dtype=dtype)
        return MTLModel(cfg, num_classes=4, input_hw=MTL_HW, generator=gen, **routed)
    if kind == "temporal":
        return TemporalVideoSegModel(norm=norm, dtype=_TORCH_DTYPES[dtype], generator=gen,
                                     **routed)
    return DeformableTransformerLayer(DEFORM_DIM, DEFORM_DIM, DEFORM_DIM,
                                      dtype=_TORCH_DTYPES[dtype], generator=gen)


def family_inputs(name: str, batch: int | None = None, seed: int = 0) -> tuple:
    """The float32 CPU inputs of run ``name`` (``batch`` cuts the batch)."""
    kind = FAMILY_RUNS[name][0]
    rng = np.random.RandomState(seed)
    if kind.startswith("mtl"):
        shapes = [(batch or MTL_B, *MTL_HW, 1)]
    elif kind == "temporal":
        shapes = [(batch or TEMPORAL_B, TEMPORAL_T, TEMPORAL_HW, TEMPORAL_HW, 1)]
    else:
        shapes = [(batch or DEFORM_B, DEFORM_HW, DEFORM_HW, DEFORM_DIM)] * 2
    return tuple(torch.from_numpy(rng.rand(*sh).astype(np.float32)) for sh in shapes)


def family_want(model) -> dict:
    """kernel_launches of a FAMILY_RUNS model at its geometry (none for the
    deformable layer, which runs no kernel of the port)."""
    if isinstance(model, MTLModel):
        return model.kernel_launches(MTL_HW[1])
    if isinstance(model, TemporalVideoSegModel):
        return model.kernel_launches(TEMPORAL_HW)
    return {"K5": 0, "K6": 0}


def family_launches() -> dict:
    """{run: {dtype: {"K5", "K6": device kernels of one forward with both
    switches on, "want", "wall_ms", "events", "busy_ms"}}} on the card."""
    from csof_tpu_torch.kernel_times import device_events

    out = {}
    with torch.inference_mode():
        for name in FAMILY_RUNS:
            args = tuple(a.cuda() for a in family_inputs(name))
            for dtype in _TORCH_DTYPES:
                model = family_model(name, dtype, True).cuda().eval()
                wall, kernels, _ = device_trace(lambda: model(*args))
                events, _ = device_events(lambda: model(*args), reps=1)
                out.setdefault(name, {})[dtype] = {
                    "K5": sum("norm_act_" in e.name for e in events),
                    "K6": sum("conv3x3_kernel" in e.name for e in events),
                    "want": family_want(model), "wall_ms": wall, "events": len(kernels),
                    "busy_ms": profiling.busy_ms(kernels)}
                del model
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flow: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--launches"]:
        import json

        out = {}
        with torch.inference_mode():
            for name, fn, _ in flow_calls()[:2]:
                wall, kernels, _ = device_trace(fn)
                out[name] = {"wall_ms": wall, "events": len(kernels),
                             "busy_ms": profiling.busy_ms(kernels)}
        out["finalflow"] = finalflow_launches()
        out["family"] = family_launches()
        print(json.dumps(out))
        return 0
    prefix = sys.argv[1] if len(sys.argv) > 1 else None
    with torch.inference_mode():
        for name, fn, what in flow_calls():
            summary, table = profile_call(fn, what)
            print(summary)
            print(table)
            if prefix:
                with open(f"{prefix}_{name}.txt", "w") as f:
                    f.write(summary + "\n" + table + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
