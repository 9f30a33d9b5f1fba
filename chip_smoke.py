#!/usr/bin/env python3
"""Drive the PyTorch port's SegFlow serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   float32 checks. Without a CUDA device the script exits non-zero.
2. build: compile the CUDA kernels (K1 corr, K3 skip fuse) from csof_tpu_torch/csrc.
3. kernels: each kernel against its plain PyTorch version at the three
   SegFlow level geometries (B=8, radius 4) and two ragged shapes, in float32
   and bfloat16, with the median time of kernel and plain version.
4. serving: the flagship SegFlow (bench geometry, bfloat16, 4 classes, random
   weights from a seed) serves 3 synthetic cine requests through
   predict_and_export_case; the output files must exist, all outputs must be
   finite, and each request must launch K3 (and K1) 136 times.
5. parity: the same full-width weights, float32, one (1, 3, 128, 128, 1)
   video: the GPU forward (kernels) against the CPU forward (plain versions).
6. throughput: forward at (8, 12, 128, 128, 1) bfloat16, frames/s from the
   median of 10 timed forwards.

Then one JSON line with each kernel's launches, error and times, and, last,
the device line. Any failure exits non-zero before the last line.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RADIUS = 4
BATCH = 8
#: (C, H, W, stride) of the three SegFlow skip levels at the 128^2 ROI
LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
RAGGED = [(32, 24, 24, 1), (16, 20, 36, 2)]
#: (atol, rtol) per check. K1: the kernel and the plain version round the
#: same float32 sum taken in another order, so bfloat16 may differ by one
#: unit in the last place (2^-7 relative). K3: a one-ulp flip of a bfloat16
#: pre-norm value is scaled by 1/std of its group.
TOL = {
    ("K1", "float32"): (1e-4, 1e-4),
    ("K1", "bfloat16"): (1e-2, 1e-2),
    ("K3", "float32"): (1e-4, 1e-4),
    ("K3", "bfloat16"): (5e-2, 5e-2),
}
MODEL_TOL = (2e-3, 2e-3)  # GPU vs CPU float32 forward: reduction order only
T_FRAMES, DEPTH, CINE_HW = 12, 8, (160, 176)
LAUNCHES_PER_REQUEST = 136  # 34 skip fuses per forward x 4 TTA forwards


class PhaseError(RuntimeError):
    pass


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(label: str, name: str, got, ref, atol: float, rtol: float) -> float:
    """Print the max abs and rel error; fail outside atol + rtol * |ref|."""
    import torch

    got, ref = got.float(), ref.float()
    expect(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    expect(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    phase(label, f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=atol {atol:g} + rtol {rtol:g} -> {'ok' if ok else 'FAIL'}")
    expect(ok, f"{name}: outside tolerance")
    return max_abs


def check_kernels(card: str) -> dict:
    """Phase 3. Returns per kernel: max abs error over all checks and the
    summed bf16 time over the three level shapes (one SegFlow step)."""
    import torch

    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in ("K1", "K3")}

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for (c, h, w, s) in LEVELS + RAGGED:
            timed = (c, h, w, s) in LEVELS and dtype == torch.bfloat16
            q = rand(BATCH, c, h, w).to(dtype)
            m = rand(BATCH, c, h, w).to(dtype)
            cin = 2 * c + (2 * RADIUS + 1) ** 2
            wt = rand(c, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5)
            bias, gw, gb = rand(c, std=0.1), 1.0 + rand(c, std=0.1), rand(c, std=0.1)
            tag = f"{dname} B={BATCH} C={c} {h}x{w} r={RADIUS} s={s}"
            runs = {
                "K1": (lambda: k1.corr_cuda(q, m, RADIUS, s),
                       lambda: k1.corr_plain(q, m, RADIUS, s)),
                "K3": (lambda: k3.skip_fuse_cuda(q, m, wt, bias, gw, gb, RADIUS, s),
                       lambda: k3.skip_fuse_plain(q, m, wt, bias, gw, gb, RADIUS, s)),
            }
            for kname, (kern, plain) in runs.items():
                got = kern()
                torch.cuda.synchronize()
                ref = plain()
                atol, rtol = TOL[(kname, dname)]
                err = compare("kernels", f"{kname} {tag}", got, ref, atol, rtol)
                res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)
                if timed:
                    # plain, kernel, kernel, plain: drift cancels in the pair
                    p1, t1 = median_ms(plain), median_ms(kern)
                    t2, p2 = median_ms(kern), median_ms(plain)
                    t, p = (t1 + t2) / 2, (p1 + p2) / 2
                    res[kname]["ms"] += t
                    res[kname]["plain_ms"] += p
                    phase("kernels", f"{kname} {tag}: kernel {t:.4f} ms, plain {p:.4f} ms "
                          f"({card})")
    torch.cuda.synchronize()
    return res


def synthetic_cine(rng: np.random.RandomState) -> np.ndarray:
    """(T, D, H, W) float32 cine: a bright disk whose radius beats over the
    cycle on a noisy background, off-centre so the ROI crop moves."""
    h, w = CINE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * 0.45 + rng.uniform(-8, 8), w * 0.55 + rng.uniform(-8, 8)
    out = np.empty((T_FRAMES, DEPTH, h, w), np.float32)
    for t in range(T_FRAMES):
        radius = 22 + 6 * np.cos(2 * np.pi * t / T_FRAMES)
        for d in range(DEPTH):
            r = radius * (1.0 - 0.05 * d)
            disk = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.float32)
            out[t, d] = 200.0 * disk + 30.0 * rng.rand(h, w)
    return out


def serve(model, card: str) -> dict:
    """Phase 4: 3 requests through predict_and_export_case."""
    import torch

    from csof_tpu_torch.inference.flow_predictor import FlowPredictor, predict_and_export_case
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    predictor = FlowPredictor(model, crop_size=128, device=torch.device("cuda"))
    rng = np.random.RandomState(0)
    cines = [synthetic_cine(rng) for _ in range(3)]
    props = {"spacing_after_resampling": (10.0, 1.5, 1.5)}
    with tempfile.TemporaryDirectory() as tmp:
        k1.launches = 0
        k3.launches = 0
        per_request = []
        for i, cine in enumerate(cines):
            before = k3.launches
            t0 = time.perf_counter()
            res = predict_and_export_case(predictor, cine, props, tmp, f"case{i}")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            per_request.append(k3.launches - before)
            for sub, ext in (("Flow", ".npz"), ("Registered", ".nii.gz"),
                             ("Segmentation", ".nii.gz")):
                expect((Path(tmp) / sub / f"case{i}{ext}").is_file(), f"missing {sub} output")
            for key in ("softmax", "flow", "registered"):
                expect(bool(np.isfinite(res[key]).all()), f"request {i}: non-finite {key}")
            expect(res["seg"].shape == cine.shape, f"seg shape {res['seg'].shape}")
            expect(res["flow"].shape == (*cine.shape, 2), f"flow shape {res['flow'].shape}")
            phase("serving", f"request {i}: cine {cine.shape} -> {secs:.3f} s host clock, "
                  f"K3 launches {per_request[-1]}, classes present "
                  f"{sorted(np.unique(res['seg']).tolist())} ({card})")
        counts = {"K1": k1.launches, "K3": k3.launches}
    expect(per_request == [LAUNCHES_PER_REQUEST] * 3,
           f"K3 launches per request {per_request}, expected {LAUNCHES_PER_REQUEST}")
    for name, n in counts.items():
        expect(n == 3 * LAUNCHES_PER_REQUEST, f"{name} launched {n} times in the serving run")
    phase("serving", f"launches in the serving run: {counts}")
    return counts


def parity(model_cpu) -> None:
    """Phase 5: float32 forward, GPU kernels vs CPU plain versions."""
    import dataclasses

    import torch

    from csof_tpu_torch.models.segflow import SegFlow

    cfg32 = dataclasses.replace(model_cpu.cfg, dtype="float32")
    cpu = SegFlow(cfg32, model_cpu.num_classes)
    cpu.load_state_dict(model_cpu.state_dict())
    gpu = copy.deepcopy(cpu).cuda()
    video = np.random.RandomState(1).rand(1, 3, 128, 128, 1).astype(np.float32)
    with torch.inference_mode():
        out_gpu = gpu(torch.from_numpy(video).cuda())
        torch.cuda.synchronize()
        out_cpu = cpu(torch.from_numpy(video))
    for key in ("seg_logits", "flow", "cum_flow", "registered"):
        got = out_gpu[key].cpu()
        compare("parity", f"{key} {tuple(got.shape)} GPU vs CPU", got, out_cpu[key], *MODEL_TOL)


def throughput(model, card: str) -> float:
    """Phase 6: frames/s of the bf16 serving forward at the bench geometry."""
    import torch

    video = torch.from_numpy(
        np.random.RandomState(0).rand(BATCH, T_FRAMES, 128, 128, 1).astype(np.float32)
    ).cuda()
    times = []
    with torch.inference_mode():
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(video)
            torch.cuda.synchronize()
            if i >= 3:  # 3 warm-up forwards
                times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    fps = BATCH * T_FRAMES / med
    phase("throughput", f"forward (8, 12, 128, 128, 1) bf16: median {med * 1e3:.3f} ms over "
          f"{len(times)} reps (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
          f"{fps:.2f} frames/s on {card}")
    return fps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from csof_tpu_torch.config.experiment import SegFlowModelConfig
        from csof_tpu_torch.inference.serving import apply_serving_config
        from csof_tpu_torch.models.segflow import SegFlow
        from csof_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the csof_tpu_torch package is missing: {e}", file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    phase("build", f"{lib.name}: nvcc {_build.last_build_seconds:.1f} s, "
          f"ready in {time.perf_counter() - t0:.1f} s")

    kernels = check_kernels(card)

    cfg = apply_serving_config(SegFlowModelConfig(), T_FRAMES)
    expect(cfg.corr_fuse == "fused_cm", f"serving config runs {cfg.corr_fuse}")
    model_cpu = SegFlow(cfg, num_classes=4, generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(model_cpu).cuda().eval()
    counts = serve(model, card)
    parity(model_cpu)
    throughput(model, card)

    sources = {
        "K1": ("local_correlation", "csof_tpu_torch/csrc/corr.cu",
               "csof_tpu/ops/pallas/corr.py:131"),
        "K3": ("fused_skip_fuse", "csof_tpu_torch/csrc/skipfuse.cu",
               "csof_tpu/ops/pallas/skipfuse.py:236"),
    }
    line = {"kernels": [
        {"name": f"{k} {name}", "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], "max_abs_err": kernels[k]["max_abs_err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"]}
        for k, (name, src, rep) in sources.items()
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
