#!/usr/bin/env python3
"""Time K1 (local correlation), K3 (skip fuse), K2 (correlation backward),
K5 (InstanceNorm + LeakyReLU) and K4 (windowed NCC) at their path's shapes on
a CUDA device.

    python3 -m csof_tpu_torch.kernel_times [out.json] [--only=K4,K5] [--k5-plans]
        [--k4-bands]
    python3 -m csof_tpu_torch.kernel_times [out.json] --only=K6_3D
    python3 -m csof_tpu_torch.kernel_times [out.json] --only=K7

K1, K3: B = 8, radius 4, (C, H, W, stride) = (32, 128, 128, 2), (64, 64, 64,
1), (128, 32, 32, 1); K2: the same levels at the SegFlow training batch, B =
4; K5: the 26 launches of one Task002 2d U-Net forward (batch 32, every
``UNET_K5_SHAPES`` entry times its launches); K4: float32 planes of 128 x 128,
20 (the SegFlow loss at the training batch) and 88 (at the bench geometry),
window 9, as the map (``ncc_map_cuda``) and as the loss (``ncc_loss_kernel``
on (N, 128, 128, 1)). bfloat16 and float32 (K4: float32), random inputs from
a seed. For each kernel and dtype: the CUDA-event median of 20 calls after 3
warm-up calls (host launch gaps included), and the device time of the
kernels one call launches (torch.profiler, the mean of 10 calls), per shape
and summed (K5: weighted by launches); for K4 also the host time a call
(``time.perf_counter`` over 1000 calls, no synchronize). Prints one JSON
object (also written to out.json) with the card's name and power limit. Only
the wrappers' public entry points are called (``corr_cuda``,
``skip_fuse_cuda``, ``corr_bwd_cuda``, ``norm_act_cuda``, ``ncc_map_cuda``,
``ncc_loss_kernel``), so the same script times any tree of the port that has
them, for a before/after comparison in one call. ``--only`` times the named
kernels alone. ``--k5-plans`` adds K5's device time at every U-Net plane
under every plan the kernel can run, ``--k4-bands`` K4's device time at 88
planes under bands of 9 to 63 rows (this tree only). ``K6_3D`` (only when
named) times K6 in the z taps of the Task002 3d_fullres U-Net
(``bounds.UNET3D_K6_SHAPES``): the forward's 17 launches at the serving
batch (16 x 80 planes) and the training step's 16 dx at batch 2, the
plain version beside each, and each routed 3D conv (``bounds.UNET3D_CONVS``,
batch 2) through the tap route (``ConvNormAct._k6_taps``: the copies, the
K6 launches, the sum) beside one ``F.conv3d``, the library call. ``K7``
(only when named) times K7 and K7 dx at the 26 blocks of a Task002 2d U-Net
training step (batch 40, ``UNET_K5_SHAPES``' planes): each kernel's device
ms per shape and summed over the launches, against their bounds
(``bounds.unet_native_work``), and a forward and backward through the
autograd function (with dgamma and dbeta) beside the eager
``leaky_relu(InstanceNorm(z))`` they replace, in device ms.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
BATCH, TRAIN_BATCH, RADIUS = 8, 4, 4
K4_PLANES = (20, 88)
#: calls in the trace that names K4's device kernels and counts its launches a call
K4_CALLS = 10


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


#: host calls that launch a kernel, as torch.profiler names them
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


#: the kernel ``torch.cuda._sleep`` launches (ATen's ``spin_kernel``)
_SENTINEL = "spin_kernel"


def device_events(fn, reps: int = 10) -> tuple[list, int]:
    """The device events (kernels, copies, fills) of ``reps`` calls of fn
    after a warm-up (torch.profiler), and the kernels the host launched in
    that trace. Each trace opens and closes with a short spin kernel that is
    left out of both: on some machines every trace loses its last kernel
    (seen as 9 kernels for 10 launches in each trace, and no kernel at all
    in a trace of one call), so fn's kernels are never a trace's first or
    last. A trace whose kernels still fall short of the launches (seen
    after many traces in one process: some or all of a run's kernels
    missing, which would read as a shorter time) is taken again, up to
    twice; the fullest of the three is returned, with a line on stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: tuple[list, int] = ([], 0)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and _SENTINEL not in e.name]
        launched = max(sum(e.device_type == DeviceType.CPU and e.name.startswith(_LAUNCHES)
                           for e in events) - 2, 0)  # less the two spin kernels
        if dev and kernel_count(dev) >= launched:  # launched 0: no host API calls traced
            return dev, launched
        if len(dev) >= len(best[0]):
            best = (dev, launched)
    print(f"device_events: the fullest of three traces holds {kernel_count(best[0])} kernels "
          f"for {best[1]} launches", file=sys.stderr)
    return best


def kernel_count(events) -> int:
    """The kernels among device events (not copies or fills)."""
    return sum(not e.name.startswith(("Memcpy", "Memset")) for e in events)


def queued_ms(fn, reps: int = 10) -> float:
    """Device ms a call by CUDA events, with the ``reps`` calls queued behind
    a spin kernel that lasts about twice the host's time to launch them, so
    that the device runs them back to back: the call's time without the
    host's launch gaps (the device's own gaps between kernels included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # cycles: twice host_s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10, group=lambda name: "all") -> dict[str, float]:
    """Device time of the kernels one call launches, summed by
    ``group(kernel name)`` (the mean of ``reps`` calls, ``device_events``):
    the call's time without the host's launch gaps. Where the trace lost
    kernels, the sums are scaled by launches over kernels kept, with a line
    on stderr: an estimate that assumes the lost ones were typical. Where
    all three traces lost every kernel (seen late in a long process), the
    time is ``queued_ms``'s, under the one key ``"all"``, with a line on
    stderr."""
    events, launched = device_events(fn, reps)
    kept = kernel_count(events)
    if not kept:
        print("device_ms: torch.profiler recorded no kernel in three traces; device time "
              "by CUDA events behind a spin kernel", file=sys.stderr)
        return {"all": queued_ms(fn, reps)}
    scale = launched / kept if launched > kept else 1.0
    if scale != 1.0:
        print(f"device_ms: device time scaled by {launched} launches / {kept} kernels traced",
              file=sys.stderr)
    out: dict[str, float] = {}
    for e in events:
        key = group(e.name)
        out[key] = out.get(key, 0.0) + scale * e.time_range.elapsed_us() / 1e3 / reps
    return out


def host_us(fn, reps: int = 1000) -> float:
    """Host microseconds a call: ``time.perf_counter`` over ``reps`` calls
    with no synchronize (the device runs behind; it is drained after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def k4_inputs(gen, n: int, h: int = 128, w: int = 128):
    """I in [0, 1) with a constant corner, J a noisy copy: (n, h, w) float32."""
    i = torch.rand(n, h, w, generator=gen, device="cuda")
    i[:, : h // 3, : w // 3] = 0.4
    return i, 0.7 * i + 0.3 * torch.rand(n, h, w, generator=gen, device="cuda")


def k4_times(gen) -> dict:
    """K4's events, device time and host time a call, map and loss; the
    host's kernel launches a call and the names of the device events, over
    ``K4_CALLS`` calls in one trace (a trace may lose some device events;
    the names need one of each)."""
    from csof_tpu_torch.ops.kernels import ncc as k4

    out = {}
    for n in K4_PLANES:
        i, j = k4_inputs(gen, n)
        il, jl = i[..., None], j[..., None]
        for name, call in (("map", lambda: k4.ncc_map_cuda(i, j)),
                           ("loss", lambda: k4.ncc_loss_kernel(il, jl))):
            key = f"K4_{name}_{n}"
            out[f"{key}_ms"] = median_ms(call)
            out[f"{key}_device_ms"] = device_ms(call)["all"]
            out[f"{key}_host_us"] = host_us(call)
            events, launched = device_events(call, reps=K4_CALLS)
            out[f"{key}_kernels"] = sorted({e.name for e in events})
            out[f"{key}_launches"] = launched / K4_CALLS
    return out


def k4_band_times(gen) -> dict:
    """K4's map device ms at 88 planes of 128 x 128 under bands of 9 to 63
    rows (``ncc_plan``'s own choice is 27)."""
    from csof_tpu_torch.ops.kernels import ncc as k4

    i, j = k4_inputs(gen, 88)
    res = {}
    for rows in range(9, 64, 9):
        plan = k4.ncc_plan(88, 128, 128, 9, 4, band_rows=rows)
        out = torch.empty_like(i)
        res[str(rows)] = device_ms(lambda: k4.launch(i, j, out, None, 88, 1, 9, 1e-3,
                                                     plan))["all"]
    return res


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


def k7_times(gen) -> dict:
    """K7 and K7 dx at the Task002 2d U-Net training step's 26 blocks (batch
    40), float32: per shape and summed over the launches, each kernel's
    device ms, a forward and backward through the autograd function and
    through the eager module and activation (device ms: the kernels, the
    parameter-gradient sums and their accumulation), and the bounds."""
    from csof_tpu_torch.bounds import UNET_K5_SHAPES, UNET_TRAIN_BATCH, bound_ms, unet_native_work
    from csof_tpu_torch.models.blocks import InstanceNorm, leaky_relu
    from csof_tpu_torch.ops.kernels import norm_act as k5

    keys = ("K7", "K7_dx", "function_step", "eager_step")
    res = {f"{k}_per_shape_device_ms": [] for k in keys}
    for (c, h, w), count in UNET_K5_SHAPES:
        z = torch.randn(UNET_TRAIN_BATCH, c, h, w, generator=gen, device="cuda") * 2 + 0.5
        dy = torch.randn(UNET_TRAIN_BATCH, c, h, w, generator=gen, device="cuda") * 1e-3
        norm = InstanceNorm(c).cuda()
        with torch.no_grad():
            norm.weight.add_(0.2 * torch.randn(c, generator=gen, device="cuda"))
            norm.bias.add_(0.2 * torch.randn(c, generator=gen, device="cuda"))
        wb = (norm.weight.detach(), norm.bias.detach())
        _, mean, rstd = k5.native_forward_cuda(z, *wb)

        def step(fn):
            zz = z.detach().requires_grad_()
            fn(zz).backward(dy)

        calls = {"K7": lambda: k5.native_forward_cuda(z, *wb),
                 "K7_dx": lambda: k5.native_backward_cuda(z, dy, mean, rstd, *wb),
                 "function_step": lambda: step(
                     lambda t: k5.native_norm_act(t, norm.weight, norm.bias)),
                 "eager_step": lambda: step(lambda t: leaky_relu(norm(t)))}
        for key, call in calls.items():
            res[f"{key}_per_shape_device_ms"].append(count * device_ms(call)["all"])
        del z, dy, mean, rstd
    for key in keys:
        res[f"{key}_device_ms"] = sum(res[f"{key}_per_shape_device_ms"])
    res["K7_bound_ms"] = bound_ms(*unet_native_work())[0]
    res["K7_dx_bound_ms"] = bound_ms(*unet_native_work(True))[0]
    return res


def k6_3d_times(gen) -> dict:
    """K6 at the Task002 3d_fullres z taps, float32 and bf16: per shape and
    summed over the launches (weights N(0, 2/(9 Ci)), no bias), the kernel's
    and the plain version's CUDA-event ms and the kernel's device ms; and per
    routed 3D conv the tap route's ms, ``F.conv3d``'s and ``conv3d_input``'s
    at batch 2 and ``F.conv3d``'s at the serving batch."""
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import (
        UNET3D_CONVS,
        UNET3D_DEPTH,
        UNET3D_K6_DX_SHAPES,
        UNET3D_K6_SHAPES,
        UNET3D_SERVING_BATCH,
        UNET3D_TRAIN_BATCH,
    )
    from csof_tpu_torch.models.blocks import ConvNormAct
    from csof_tpu_torch.ops.kernels import conv as k6

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for key, shapes, batch in (("K6_3D", UNET3D_K6_SHAPES, UNET3D_SERVING_BATCH),
                                   ("K6_dx_3D", UNET3D_K6_DX_SHAPES, UNET3D_TRAIN_BATCH)):
            rows = []
            for (ci, co, h, w), count in shapes:
                n = batch * UNET3D_DEPTH
                x = torch.randn(n, ci, h, w, generator=gen, device="cuda").to(dtype)
                wt = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (2 / (9 * ci)) ** .5
                if key == "K6_3D":
                    def call():
                        return k6.conv3x3_cuda(x, wt)

                    def plain():
                        return k6.conv3x3_plain(x, wt)
                else:  # x is dy, Ci' = co of the dx launch: the weight is the forward's
                    wt = wt.transpose(0, 1).contiguous()

                    def call():
                        return k6.conv3x3_dx_cuda(x, wt)

                    def plain():
                        return k6.conv3x3_dx_plain(x, wt)
                rows.append({"shape": [n, ci, co, h, w], "launches": count,
                             "ms": median_ms(call), "plain_ms": median_ms(plain),
                             "device_ms": device_ms(call)["all"]})
                del x
            out[f"{key}_{dname}"] = rows
            for field in ("ms", "plain_ms", "device_ms"):
                out[f"{key}_{dname}_{field}"] = sum(r["launches"] * r[field] for r in rows)
        convs = []
        for (ci, co, kernel, (d, h, w)), count in UNET3D_CONVS:
            block = ConvNormAct(ci, co, 1, "instance", dtype, kernel_size=kernel,
                                conv_impl="pallas").cuda()
            pad = (kernel[0] // 2, 1, 1)
            conv, bias = block.Conv_0, block.Conv_0.bias.to(dtype)
            wt = conv.weight.to(dtype)
            row = {"conv": [ci, co, list(kernel), [d, h, w]], "convs": count}
            with torch.no_grad():
                x = torch.randn(UNET3D_TRAIN_BATCH, ci, d, h, w, generator=gen,
                                device="cuda").to(dtype)
                row["route_ms"] = median_ms(lambda: block._k6_taps(x))
                row["conv3d_ms"] = median_ms(lambda: F.conv3d(x, wt, bias, 1, pad))
                dy = torch.randn(UNET3D_TRAIN_BATCH, co, d, h, w, generator=gen,
                                 device="cuda").to(dtype)
                row["dgrad3d_ms"] = median_ms(lambda: torch.nn.grad.conv3d_input(
                    x.shape, wt, dy, 1, pad))
                del x, dy
                x = torch.randn(UNET3D_SERVING_BATCH, ci, d, h, w, generator=gen,
                                device="cuda").to(dtype)
                row["conv3d_serving_ms"] = median_ms(lambda: F.conv3d(x, wt, bias, 1, pad),
                                                     reps=5, warmup=1)
                del x
            convs.append(row)
        out[f"K6_3D_convs_{dname}"] = convs
        for field in ("route_ms", "conv3d_ms", "dgrad3d_ms", "conv3d_serving_ms"):
            out[f"K6_3D_convs_{dname}_{field}"] = sum(c["convs"] * c[field] for c in convs)
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
    only = [a.removeprefix("--only=").split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    wanted = set(only[-1]) if only else {"K1", "K2", "K3", "K4", "K5"}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name in sorted({"K1", "K3"} & wanted):
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
        for c, h, w, s in LEVELS if "K2" in wanted else []:
            q, m = (torch.randn(TRAIN_BATCH, c, h, w, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            g = torch.randn(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w, generator=gen,
                            device="cuda").to(dtype)

            def call():
                return k1.corr_bwd_cuda(q, m, g, RADIUS, s)
            per_level.append(median_ms(call))
            per_level_device.append(device_ms(call)["all"])
        if "K2" in wanted:
            out[f"K2_{dname}_ms"] = sum(per_level)
            out[f"K2_{dname}_per_level_ms"] = per_level
            out[f"K2_{dname}_device_ms"] = sum(per_level_device)
            out[f"K2_{dname}_per_level_device_ms"] = per_level_device
        if "K5" not in wanted:
            continue
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
    if "K4" in wanted:
        out.update(k4_times(gen))
    if "K6_3D" in wanted:
        out.update(k6_3d_times(gen))
    if "K7" in wanted:
        out.update(k7_times(gen))
    if "--k5-plans" in sys.argv:
        out["K5_plans"] = k5_plan_times(gen)
    if "--k4-bands" in sys.argv:
        out["K4_band_device_ms"] = k4_band_times(gen)
    line = json.dumps(out)
    print(line)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
