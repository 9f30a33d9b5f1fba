#!/usr/bin/env python3
"""Drive the PyTorch port's SegFlow serving and training paths and its
nnU-Net 2D serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   float32 checks. Without a CUDA device the script exits non-zero.
2. build: compile the CUDA kernels (K1 corr, K2 corr backward, K3 skip fuse,
   K5 norm + activation, K6 3x3 conv) from csof_tpu_torch/csrc, one nvcc per
   source, all started together.
3. kernels: each kernel against its plain PyTorch version at the three
   SegFlow level geometries (K1, K3: B=8; K2: the training batch, B=4;
   radius 4) and two ragged shapes, in float32 and bfloat16, with the median
   time of kernel and plain version; the correlation's autograd gradients on
   the card (K1 forward, K2 backward) against autograd of the plain forward.
4. serving: the flagship SegFlow (bench geometry, bfloat16, 4 classes, random
   weights from a seed) serves 3 synthetic cine requests through
   predict_and_export_case; the output files must exist, all outputs must be
   finite, and each request must launch K3 (and K1) 136 times.
5. parity: the same full-width weights, float32, one (1, 3, 128, 128, 1)
   video: the GPU forward (kernels) against the CPU forward (plain versions).
6. throughput: forward at (8, 12, 128, 128, 1) bfloat16, frames/s from the
   median of 10 timed forwards.
7. train, 8. train parity: 14 steps of Trainer.run_training at full width,
   and the float32 loss and gradients GPU vs CPU.
9. unet kernels: K5 and K6 against their plain versions at every distinct
   shape of one Task002 2d U-Net forward (batch 32) and two ragged shapes, in
   float32 and bfloat16, with the median time of kernel, plain version and
   library call (K6: F.conv2d; K5: F.instance_norm + F.leaky_relu, a
   two-call note).
10. unet serving: the full-width Task002 2d U-Net (2 classes, float32,
   random weights, both kernel switches on) serves 2 synthetic cases
   (1, 40, 320, 320) at 1.25 mm in plane through predict_case; outputs
   finite, files written, 26 K5 and 7 K6 launches per forward.
11. unet parity: float32 logits of 2 tiles, GPU (kernels) vs CPU (plain
   versions), and the shapes each kernel was launched at.
12. unet throughput: slices/s of predict_2d_stack (host clock, median of 5)
   and the CUDA-event time of one batch-32 forward.

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
TRAIN_BATCH, TRAIN_T, TRAIN_HW = 4, 6, 128
#: (C, H, W, stride) of the three SegFlow skip levels at the 128^2 ROI
LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
RAGGED = [(32, 24, 24, 1), (16, 20, 36, 2)]
#: (atol, rtol) per check. K1, K2: the kernel and the plain version round the
#: same float32 sum taken in another order, so bfloat16 may differ by one
#: unit in the last place (2^-7 relative; K2's sums of 81 terms are larger,
#: hence its larger atol). K3: a one-ulp flip of a bfloat16 pre-norm value
#: is scaled by 1/std of its group.
TOL = {
    ("K1", "float32"): (1e-4, 1e-4),
    ("K1", "bfloat16"): (1e-2, 1e-2),
    ("K3", "float32"): (1e-4, 1e-4),
    ("K3", "bfloat16"): (5e-2, 5e-2),
    ("K2", "float32"): (1e-4, 1e-4),
    ("K2", "bfloat16"): (2e-2, 1e-2),
}
MODEL_TOL = (2e-3, 2e-3)  # GPU vs CPU float32 forward: reduction order only
#: GPU vs CPU float32 loss (relative) and gradients (|diff| <= GRAD_TOL *
#: max|leaf| + 1e-6 per leaf): reduction order only, as in the CPU tests
#: against JAX
LOSS_RTOL, GRAD_TOL = 1e-4, 2e-3
T_FRAMES, DEPTH, CINE_HW = 12, 8, (160, 176)
#: K5 and K6 (atol, rtol): the same float32 sums in another order; bf16
#: rounds once (K5: one bf16 ulp after a normalization by 1/std; K6: the
#: conv sum and the bias add)
UNET_TOL = {
    ("K5", "float32"): (2e-5, 2e-5),
    ("K5", "bfloat16"): (2e-2, 8e-3),
    ("K6", "float32"): (1e-4, 1e-4),
    ("K6", "bfloat16"): (2e-2, 1e-2),
}
#: ragged shapes beside the served ones: K5 (N, C, H, W), K6 (N, Ci, Co, H, W)
K5_RAGGED = [(3, 7, 33, 129), (5, 3, 17, 9)]
K6_RAGGED = [(3, 13, 40, 17, 23), (2, 1, 5, 9, 70)]
UNET_CASES, UNET_DEPTH, UNET_HW, UNET_SPACING = 2, 40, (320, 320), 1.25
UNET_TILE_BATCH = 8  # PredictorConfig's default, which predict_case serves with
LAUNCHES_PER_REQUEST = 136  # 34 skip fuses per forward x 4 TTA forwards
#: K1 (forward) and K2 (backward) per train step: the frame-0 prime step
#: runs only the bottleneck level's skip fuse, every later frame all three
CORR_PER_STEP = 1 + 3 * (TRAIN_T - 1)
TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH, TRAIN_WARMUP = 2, 7, 2


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


def timed_pair(kern, plain) -> tuple[float, float]:
    """Median ms of kernel and plain version, in the order plain, kernel,
    kernel, plain, so that drift cancels in the pair."""
    p1, t1 = median_ms(plain), median_ms(kern)
    t2, p2 = median_ms(kern), median_ms(plain)
    return (t1 + t2) / 2, (p1 + p2) / 2


def check_kernels(card: str) -> dict:
    """Phase 3. Returns per kernel: max abs error over all checks, the
    summed bf16 time of kernel and plain version over the three level shapes
    (one SegFlow step), its bound (csof_tpu_torch/bounds.py) at those shapes,
    and (K3) the library conv's time."""
    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import bound_ms, corr_work
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": None, "library_ms": None, "bytes": 0.0, "fp32": 0.0, "tc": 0.0}
           for k in ("K1", "K2", "K3")}
    res["K3"]["library_ms"] = 0.0

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
            # K2 at the training batch, with a cotangent of the corr's shape
            qt, mt = q[:TRAIN_BATCH].contiguous(), m[:TRAIN_BATCH].contiguous()
            g = rand(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w).to(dtype)
            runs = {
                "K1": (BATCH, lambda: k1.corr_cuda(q, m, RADIUS, s),
                       lambda: k1.corr_plain(q, m, RADIUS, s)),
                "K3": (BATCH, lambda: k3.skip_fuse_cuda(q, m, wt, bias, gw, gb, RADIUS, s),
                       lambda: k3.skip_fuse_plain(q, m, wt, bias, gw, gb, RADIUS, s)),
                "K2": (TRAIN_BATCH, lambda: k1.corr_bwd_cuda(qt, mt, g, RADIUS, s),
                       lambda: k1.corr_bwd_plain(qt, mt, g, RADIUS, s)),
            }
            for kname, (b, kern, plain) in runs.items():
                tag = f"{dname} B={b} C={c} {h}x{w} r={RADIUS} s={s}"
                got = kern()
                torch.cuda.synchronize()
                ref = plain()
                atol, rtol = TOL[(kname, dname)]
                if kname == "K2":
                    err = max(compare("kernels", f"K2 {name} {tag}", a, r, atol, rtol)
                              for name, a, r in zip(("dq", "dm"), got, ref))
                else:
                    err = compare("kernels", f"{kname} {tag}", got, ref, atol, rtol)
                r = res[kname]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if timed:
                    t, p = timed_pair(kern, plain)
                    r["ms"] += t
                    r["plain_ms"] += p
                    work = corr_work(kname, b, c, h, w, 2)
                    for key, v in zip(("bytes", "fp32", "tc"), work):
                        r[key] += v
                    extra = ""
                    if kname == "K3":
                        x = torch.cat([q, m, k1.corr_cuda(q, m, RADIUS, s)], 1)
                        wb = wt.to(dtype)
                        lib = median_ms(lambda: F.conv2d(x, wb, padding=1))
                        r["library_ms"] += lib
                        extra = f", library F.conv2d over the {cin}-channel concat {lib:.4f} ms"
                    phase("kernels", f"{kname} {tag}: kernel {t:.4f} ms, plain {p:.4f} ms"
                          f"{extra} ({card})")
    for r in res.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("fp32"), r.pop("tc"))

    # the autograd path: CorrFunction (K1 forward, K2 backward) against
    # autograd of the plain forward, float32
    c, h, w, s = LEVELS[0]
    q = rand(TRAIN_BATCH, c, h, w).requires_grad_(True)
    m = rand(TRAIN_BATCH, c, h, w).requires_grad_(True)
    g = rand(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w)
    got = torch.autograd.grad((k1.CorrFunction.apply(q, m, RADIUS, s) * g).sum(), (q, m))
    ref = torch.autograd.grad((k1.corr_plain(q, m, RADIUS, s) * g).sum(), (q, m))
    for name, a, b in zip(("dq", "dm"), got, ref):
        compare("kernels", f"CorrFunction autograd {name} float32 B={TRAIN_BATCH} C={c} "
                f"{h}x{w} s={s} vs autograd of corr_plain", a, b, *TOL[("K2", "float32")])
    torch.cuda.synchronize()
    return res


def synthetic_cine(rng: np.random.RandomState) -> np.ndarray:
    """(T, D, H, W) float32 cine: a bright disk whose radius beats over the
    cycle on a noisy background, off-centre so the ROI crop moves (the disk
    is where the cine exceeds 100)."""
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
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    predictor = FlowPredictor(model, crop_size=128, device=torch.device("cuda"))
    rng = np.random.RandomState(0)
    cines = [synthetic_cine(rng) for _ in range(3)]
    props = {"spacing_after_resampling": (10.0, 1.5, 1.5)}
    with tempfile.TemporaryDirectory() as tmp:
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
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
    others = {"K2": k1.bwd_launches, "K5": k5.launches, "K6": k6.launches}
    expect(others == {"K2": 0, "K5": 0, "K6": 0}, f"launched while serving: {others}")
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


def synthetic_videos(n: int = 4) -> dict:
    """Training cines for VideoChunkLoader: the serving cines with the disk
    as label 1, ED at frame 0 and ES at the smallest disk."""
    rng = np.random.RandomState(2)
    videos = {}
    for i in range(n):
        cine = synthetic_cine(rng)
        videos[f"synthetic{i}"] = {"frames": cine, "seg": (cine > 100).astype(np.int32),
                                   "ed": 0, "es": T_FRAMES // 2}
    return videos


def train(card: str) -> dict:
    """Phase 7: Trainer.run_training at full width, bf16, batch 4 x 6 x 128^2."""
    import dataclasses

    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3
    from csof_tpu_torch.training import checkpoint as ckpt
    from csof_tpu_torch.training.trainer import Trainer

    config = ExperimentConfig(
        data=DataConfig(do_data_aug=False, batch_size=TRAIN_BATCH, video_length=TRAIN_T,
                        crop_size=TRAIN_HW),
        num_batches_per_epoch=TRAIN_STEPS_PER_EPOCH, max_num_epochs=TRAIN_EPOCHS)
    expect(config.segflow.corr_fuse == "concat" and config.segflow.dtype == "bfloat16",
           f"default config trains {config.segflow.corr_fuse} {config.segflow.dtype}")
    loader = VideoChunkLoader(synthetic_videos(), config.data.video_length,
                              config.data.batch_size, config.data.crop_size, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, tmp, device="cuda").initialize()
        trainer.checkpoint_every = TRAIN_EPOCHS  # so that the run writes "latest" too
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        step = trainer.run_iteration
        losses, event_ms = [], []

        def timed_step(batch, train=True):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, aux = step(batch, train)  # ends in a read of the loss: synchronised
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
            losses.append(loss)
            return loss, aux

        trainer.run_iteration = timed_step
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
        hist = trainer.run_training(loader, log_fn=lambda msg: phase("train", msg))
        counts = {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches,
                  "K5": k5.launches, "K6": k6.launches}
        n = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
        expect(len(losses) == n and all(np.isfinite(losses)), f"losses {losses}")
        expect(counts == {"K1": CORR_PER_STEP * n, "K2": CORR_PER_STEP * n, "K3": 0, "K5": 0,
                          "K6": 0},
               f"launches in the train run {counts}, expected {CORR_PER_STEP} K1 and K2 "
               f"per step over {n} steps")
        after = trainer.model.state_dict()
        changed = sum(not torch.equal(after[k], v) for k, v in before.items())
        grads = [p for p in trainer.model.parameters() if p.grad is not None
                 and bool(p.grad.abs().sum() > 0)]
        expect(changed >= len(grads) > 0,
               f"{changed} of {len(before)} tensors changed, {len(grads)} had gradients")
        for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
            expect((Path(tmp) / name).is_file() and (Path(tmp) / (name + ".json")).is_file(),
                   f"checkpoint {name} or its sidecar missing")
        fresh = Trainer(config, tmp, device="cuda")
        meta = fresh.load_checkpoint()
        expect(meta["epoch"] == TRAIN_EPOCHS and fresh.optimizer.count == n,
               f"reloaded epoch {meta['epoch']}, step {fresh.optimizer.count}")
        expect(all(torch.equal(v, after[k]) for k, v in fresh.model.state_dict().items()),
               "the reloaded weights differ from the trained ones")
    steps = hist.step_times[TRAIN_WARMUP:]
    med = statistics.median(steps)
    frames = TRAIN_BATCH * TRAIN_T
    phase("train", f"{n} steps, losses {losses[0]:.5f} -> {losses[-1]:.5f}; {changed} of "
          f"{len(before)} parameter tensors changed; launches {counts} ({CORR_PER_STEP} K1 + "
          f"{CORR_PER_STEP} K2 per step); checkpoint triad written and reloaded")
    phase("train", f"step ({TRAIN_BATCH}, {TRAIN_T}, {TRAIN_HW}, {TRAIN_HW}, 1) bf16: median "
          f"{med * 1e3:.3f} ms host clock over {len(steps)} steps after {TRAIN_WARMUP} warm-up "
          f"(min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}) -> "
          f"{frames / med:.2f} train frames/s; CUDA-event step median "
          f"{statistics.median(event_ms[TRAIN_WARMUP:]):.3f} ms on {card}")
    return counts


def train_parity(card: str) -> None:
    """Phase 8: float32 loss and gradients, GPU kernels vs CPU plain versions."""
    import torch

    from csof_tpu_torch.config.experiment import (
        DataConfig,
        ExperimentConfig,
        LossWeights,
        SegFlowModelConfig,
    )
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.training.trainer import build_model, make_segflow_loss

    config = ExperimentConfig(
        segflow=SegFlowModelConfig(dtype="float32"), data=DataConfig(do_data_aug=False),
        loss_weights=LossWeights(image_flow_global=0.5, regularization_xy=1.0,
                                 regularization_z=0.5, seg_registered=0.3, segmentation=1.0))
    cpu = build_model(config, 4, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    batch = next(VideoChunkLoader(synthetic_videos(1), 3, 1, 64, seed=3))
    loss_fn = make_segflow_loss(config)
    before = k1.bwd_launches
    loss_gpu, _ = loss_fn(gpu, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    expect(k1.bwd_launches - before == 1 + 3 * 2, "the GPU backward did not run K2")
    loss_cpu, _ = loss_fn(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_cpu.backward()
    a, b = loss_gpu.item(), loss_cpu.item()
    expect(abs(a - b) <= LOSS_RTOL * abs(b), f"loss GPU {a} vs CPU {b}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g, r = p.grad.cpu(), cpu_params[name].grad
        expect(bool(torch.isfinite(g).all()), f"{name}: non-finite gradient")
        ratio = float((g - r).abs().max()) / (GRAD_TOL * float(r.abs().max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    phase("train parity", f"full width float32 (1, 3, 64, 64, 1), every loss term on: loss GPU "
          f"{a:.7f} vs CPU {b:.7f}; {len(cpu_params)} gradients, worst |diff| / (tol "
          f"{GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at {worst_name} "
          f"-> {'ok' if worst <= 1 else 'FAIL'} ({card})")
    expect(worst <= 1, f"gradient {worst_name} outside tolerance")


def check_unet_kernels(card: str) -> dict:
    """Phase 9. Returns per kernel: max abs error over all checks, and the
    float32 times of one U-Net forward (each served shape's median times its
    launches per forward) of kernel, plain version and library call, with
    the bound of the same work (csof_tpu_torch/bounds.py)."""
    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import (
        UNET_BATCH,
        UNET_K5_SHAPES,
        UNET_K6_SHAPES,
        bound_ms,
        unet_forward_work,
    )
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
           for k in ("K5", "K6")}
    res["K6"]["library_ms"] = 0.0
    res["K5"]["library_note_ms"] = 0.0
    per_dtype = {}

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std + mean

    runs = [("K5", (UNET_BATCH, *shape), count) for shape, count in UNET_K5_SHAPES]
    runs += [("K5", shape, 0) for shape in K5_RAGGED]
    runs += [("K6", (UNET_BATCH, *shape), count) for shape, count in UNET_K6_SHAPES]
    runs += [("K6", shape, 0) for shape in K6_RAGGED]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for kname, shape, count in runs:
            if kname == "K5":
                n, c, h, w = shape
                x = rand(n, c, h, w, std=2.0, mean=0.5).to(dtype)
                x[0, 0] = 0.25  # a constant plane
                scale, bias = 1.0 + rand(c, std=0.2), rand(c, std=0.2)
                kern = lambda: k5.norm_act_cuda(x, scale, bias)  # noqa: E731
                plain = lambda: k5.norm_act_plain(x, scale, bias)  # noqa: E731
                sd, bd = scale.to(dtype), bias.to(dtype)
                lib = lambda: F.leaky_relu(  # noqa: E731
                    F.instance_norm(x, weight=sd, bias=bd, eps=1e-5), 0.01)
                tag = f"{dname} (N, C, H, W)={shape}"
            else:
                n, ci, co, h, w = shape
                x = rand(n, ci, h, w).to(dtype)
                wt, bias = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5), rand(co, std=0.1)
                kern = lambda: k6.conv3x3_cuda(x, wt, bias)  # noqa: E731
                plain = lambda: k6.conv3x3_plain(x, wt, bias)  # noqa: E731
                wd, bd = wt.to(dtype), bias.to(dtype)
                lib = lambda: F.conv2d(x, wd, bd, padding=1)  # noqa: E731
                tag = f"{dname} (N, Ci, Co, H, W)={shape}"
            got = kern()
            torch.cuda.synchronize()
            err = compare("unet kernels", f"{kname} {tag}", got, plain(),
                          *UNET_TOL[(kname, dname)])
            r = res[kname]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if not count:
                continue
            t, p = timed_pair(kern, plain)
            lib_ms = median_ms(lib)
            tot = per_dtype.setdefault((kname, dname), [0.0, 0.0, 0.0])
            for i, v in enumerate((t, p, lib_ms)):
                tot[i] += count * v
            if dtype == torch.float32:
                r["ms"] += count * t
                r["plain_ms"] += count * p
                r["library_note_ms" if kname == "K5" else "library_ms"] += count * lib_ms
            libname = "F.instance_norm + F.leaky_relu (note)" if kname == "K5" else "F.conv2d"
            phase("unet kernels", f"{kname} {tag} x{count} per forward: kernel {t:.4f} ms, "
                  f"plain {p:.4f} ms, {libname} {lib_ms:.4f} ms ({card})")
    for kname, r in res.items():
        r["bound_ms"], r["bound_by"] = bound_ms(*unet_forward_work(kname, 4))
        for dname in ("float32", "bfloat16"):
            t, p, lib_ms = per_dtype[(kname, dname)]
            phase("unet kernels", f"{kname} {dname}, one forward ({UNET_BATCH} x 320x256): kernel "
                  f"{t:.4f} ms, plain {p:.4f} ms, library {lib_ms:.4f} ms; float32 bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
    torch.cuda.synchronize()
    return res


def synthetic_case(rng: np.random.RandomState) -> np.ndarray:
    """(z, y, x) float32 MRI-like volume: noise everywhere (nothing for the
    crop to remove) and a bright ellipsoid, the left atrium's stand-in."""
    h, w = UNET_HW
    zz, yy, xx = np.mgrid[0:UNET_DEPTH, 0:h, 0:w].astype(np.float32)
    cz, cy, cx = UNET_DEPTH / 2, h * 0.5 + rng.uniform(-20, 20), w * 0.5 + rng.uniform(-20, 20)
    blob = ((zz - cz) / 12) ** 2 + ((yy - cy) / 40) ** 2 + ((xx - cx) / 30) ** 2 <= 1
    return (20 + 30 * rng.rand(UNET_DEPTH, h, w) + 200 * blob).astype(np.float32)


def unet_forwards(shape_zyx, plans) -> int:
    """Forwards predict_2d_stack runs for a preprocessed (z, y, x) volume:
    (slices padded to the depth bucket) x (tiles a slice) over the tile batch."""
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid

    patch = plans.fullres_stage().patch_size
    bucket = bucket_image_shape(shape_zyx[1:], patch, 0.5, 32)
    jobs = -(-shape_zyx[0] // 4) * 4 * len(step_grid(patch, bucket, 0.5))
    return -(-jobs // UNET_TILE_BATCH)


def unet_serve(model, plans, card: str) -> dict:
    """Phase 10: 2 synthetic cases through predict_case."""
    import torch

    from csof_tpu_torch.inference.predictor import predict_case
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3
    from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

    per_forward = model.kernel_launches(plans.fullres_stage().patch_size[1])
    expect(per_forward == {"K5": 26, "K6": 7}, f"launches per forward {per_forward}")
    rng = np.random.RandomState(3)
    spacing_xyz = (UNET_SPACING, UNET_SPACING, 1.37)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i in range(UNET_CASES):
            files.append(Path(tmp) / f"la_{i:03d}_0000.nii.gz")
            save_nifti(synthetic_case(rng), files[-1], spacing_xyz=spacing_xyz)
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
        forwards = 0
        for i, f in enumerate(files):
            before = (k5.launches, k6.launches)
            out = Path(tmp) / f"la_{i:03d}.nii.gz"
            t0 = time.perf_counter()
            res = predict_case(plans, model, [f], out, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_fwd = unet_forwards(res["properties"]["size_after_resampling"], plans)
            forwards += n_fwd
            got = (k5.launches - before[0], k6.launches - before[1])
            expect(n_fwd == 10, f"case {i}: {n_fwd} forwards, expected 10 (40 slices x 2 tiles)")
            expect(got == (26 * n_fwd, 7 * n_fwd),
                   f"case {i}: K5, K6 launches {got}, expected {26 * n_fwd}, {7 * n_fwd}")
            expect(bool(np.isfinite(res["softmax"]).all()), f"case {i}: non-finite softmax")
            expect(res["softmax"].shape == (2, UNET_DEPTH, *UNET_HW),
                   f"case {i}: softmax shape {res['softmax'].shape}")
            expect(out.is_file(), f"case {i}: {out.name} not written")
            seg = load_nifti(out).data_czyx
            expect(seg.shape == (UNET_DEPTH, *UNET_HW), f"case {i}: written seg {seg.shape}")
            phase("unet serving", f"case {i}: (1, {UNET_DEPTH}, {UNET_HW[0]}, {UNET_HW[1]}) -> "
                  f"{secs:.3f} s host clock, {n_fwd} forwards, K5/K6 launches {got}, labels "
                  f"written {sorted(np.unique(seg).tolist())} ({card})")
        counts = {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches,
                  "K5": k5.launches, "K6": k6.launches}
    expect(counts == {"K1": 0, "K2": 0, "K3": 0, "K5": 26 * forwards, "K6": 7 * forwards},
           f"launches in the U-Net serving run {counts} over {forwards} forwards")
    phase("unet serving", f"launches in the U-Net serving run: {counts} ({forwards} forwards)")
    return counts


def unet_parity(model_cpu, card: str) -> None:
    """Phase 11: float32 logits of 2 tiles, GPU kernels vs CPU plain
    versions; the GPU forward's kernel shapes against bounds.py's lists."""
    from collections import Counter

    import torch

    from csof_tpu_torch.bounds import UNET_K5_SHAPES, UNET_K6_SHAPES
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gpu = copy.deepcopy(model_cpu).cuda()
    x = np.random.RandomState(4).randn(2, 1, 320, 256).astype(np.float32)
    shapes = {"K5": Counter(), "K6": Counter()}
    orig = (k5.norm_act_cuda, k6.conv3x3_cuda)

    def k5_census(x, *a, **k):
        shapes["K5"][tuple(x.shape[1:])] += 1
        return orig[0](x, *a, **k)

    def k6_census(x, w, *a, **k):
        shapes["K6"][(x.shape[1], w.shape[0], *x.shape[2:])] += 1
        return orig[1](x, w, *a, **k)

    k5.norm_act_cuda, k6.conv3x3_cuda = k5_census, k6_census
    try:
        with torch.inference_mode():
            out_gpu = gpu(torch.from_numpy(x).cuda())
            torch.cuda.synchronize()
    finally:
        k5.norm_act_cuda, k6.conv3x3_cuda = orig
    for name, listed in (("K5", UNET_K5_SHAPES), ("K6", UNET_K6_SHAPES)):
        expect(shapes[name] == Counter(dict(listed)),
               f"{name} launched at {dict(shapes[name])}, bounds.py lists {listed}")
    with torch.inference_mode():
        out_cpu = model_cpu(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(out_gpu, out_cpu)):
        compare("unet parity", f"head {i} {tuple(a.shape)} GPU vs CPU", a.cpu(), b, *MODEL_TOL)
    phase("unet parity", f"kernel shapes of the forward match bounds.py ({card})")


def unet_throughput(model, plans, card: str) -> float:
    """Phase 12: slices/s of predict_2d_stack on a (1, 40, 320, 320) volume,
    and the CUDA-event time of one batch-32 forward."""
    import torch

    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor

    sp = plans.fullres_stage()
    cfg = PredictorConfig(patch_size=tuple(sp.patch_size),
                          num_classes=plans.num_classes_with_background,
                          tile_batch=UNET_TILE_BATCH)
    predictor = SlidingWindowPredictor(model, cfg, "cuda")
    vol = np.random.RandomState(5).randn(1, UNET_DEPTH, *UNET_HW).astype(np.float32)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_2d_stack(vol)
        torch.cuda.synchronize()
        if i:  # 1 warm-up
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    x = torch.from_numpy(np.random.RandomState(6).randn(32, 1, *sp.patch_size)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd = median_ms(lambda: model(x), reps=10)
    phase("unet throughput", f"predict_2d_stack (1, {UNET_DEPTH}, {UNET_HW[0]}, {UNET_HW[1]}) "
          f"float32, TTA 4 flips, 10 forwards of 32: median {med:.3f} s over {len(times)} runs "
          f"(min {min(times):.3f}, max {max(times):.3f}) -> {UNET_DEPTH / med:.2f} slices/s; one "
          f"batch-32 forward {fwd:.3f} ms CUDA events (median of 10) on {card}")
    return UNET_DEPTH / med


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
    del model, model_cpu
    train_counts = train(card)
    train_parity(card)

    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans

    kernels.update(check_unet_kernels(card))
    plans = task002_heart_2d()
    unet_cpu = unet_from_plans(plans, fused_norm_act=True, conv_impl="pallas",
                               generator=torch.Generator().manual_seed(0)).eval()
    unet = copy.deepcopy(unet_cpu).cuda()
    unet_counts = unet_serve(unet, plans, card)
    unet_parity(unet_cpu, card)
    unet_throughput(unet, plans, card)

    by_path = {k: {"serving": counts.get(k, 0), "train": train_counts.get(k, 0),
                   "unet_serving": unet_counts.get(k, 0)}
               for k in ("K1", "K2", "K3", "K5", "K6")}
    sources = {
        "K1": ("local_correlation", "csof_tpu_torch/csrc/corr.cu",
               "csof_tpu/ops/pallas/corr.py:131", None),
        "K2": ("local_correlation_backward", "csof_tpu_torch/csrc/corr_bwd.cu",
               "csof_tpu/ops/pallas/corr.py:409", None),
        "K3": ("fused_skip_fuse", "csof_tpu_torch/csrc/skipfuse.cu",
               "csof_tpu/ops/pallas/skipfuse.py:236",
               "F.conv2d over the (2C+81)-channel concat: K3's conv pass only"),
        "K5": ("instance_norm_leaky_relu", "csof_tpu_torch/csrc/norm_act.cu",
               "csof_tpu/ops/pallas/norm_act.py:34",
               "none: no one PyTorch call; library_note_ms times F.instance_norm + "
               "F.leaky_relu"),
        "K6": ("conv3x3", "csof_tpu_torch/csrc/conv3x3.cu", "csof_tpu/ops/pallas/conv.py:175",
               "F.conv2d(x, w, b, padding=1)"),
    }
    line = {"kernels": [
        {"name": f"{k} {name}", "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[k].values()), "launches_by_path": by_path[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"], "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"], "library_ms": kernels[k]["library_ms"],
         **({"library_call": lib_call} if lib_call else {}),
         **({"library_note_ms": kernels[k]["library_note_ms"]}
            if "library_note_ms" in kernels[k] else {})}
        for k, (name, src, rep, lib_call) in sources.items()
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
