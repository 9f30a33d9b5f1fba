#!/usr/bin/env python3
"""Drive the PyTorch port's SegFlow serving and training paths and its
nnU-Net 2D serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   float32 checks. Without a CUDA device the script exits non-zero.
2. build: compile the CUDA kernels (K1 corr, K2 corr backward, K3 skip fuse,
   K4 NCC map, K5 norm + activation, K6 3x3 conv) from csof_tpu_torch/csrc,
   one nvcc per source, all started together; then count the tensor-core
   instructions (HGMMA) of K6's forward and dx and of K3's conv pass in the
   library's SASS (csof_tpu_torch/sass_census.py): each must have some.
3. kernels: each kernel against its plain PyTorch version at the three
   SegFlow level geometries (K1, K3: B=8; K2: the training batch, B=4;
   radius 4), two ragged shapes, and (K1, K3) shapes across the edges of
   their tilings (W, H, C, F = 12 and 130, strides 1-3, radius 1-4, B 1 and
   8), in float32 and bfloat16, with the median time of kernel and plain
   version (bf16; K1 and K3 in float32 too), K3's library conv over the
   concat and the whole K3 chain as library calls, K3's device time by pass
   (torch.profiler); K3 twice on the same inputs must give the same bits;
   the correlation's autograd gradients on the card (K1 forward, K2
   backward) against autograd of the plain forward.
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
   shape of one Task002 2d U-Net forward (batch 32) and ragged shapes (K6:
   across every tile edge of its tensor-core tiling, with and without bias,
   out_f32 on bf16), in float32 and bfloat16, with the median time of
   kernel, plain version and library call (K6: F.conv2d; K5:
   F.instance_norm + F.leaky_relu, a two-call note); K6's bound as 3xTF32
   (float32) and bf16 on the tensor cores, the FP32-core bound as a note.
10. unet serving: the full-width Task002 2d U-Net (2 classes, float32,
   random weights, both kernel switches on) serves 2 synthetic cases
   (1, 40, 320, 320) at 1.25 mm in plane through predict_case; outputs
   finite, files written, 26 K5 and 7 K6 launches per forward.
11. unet parity: float32 logits of 2 tiles, GPU (kernels) vs CPU (plain
   versions), and the shapes each kernel was launched at.
12. unet throughput: slices/s of predict_2d_stack (host clock, median of 5)
   and the CUDA-event time of one batch-32 forward.
13. unet train kernels: K6's backward (Conv3x3Function: dx by K6 on the
   flipped weight, dw and db by the library) against autograd of the plain
   version at the 4 distinct dx shapes of a Task002 2d training step (batch
   40) and ragged shapes across the tile edges, float32 and bfloat16; the
   dx time beside the plain version's and cuDNN's dgrad
   (torch.nn.grad.conv2d_input) and the bounds.
14. unet train: 4 synthetic Task002-like cases (1, 40, 320, 320) through
   run_cropping -> Preprocessor.run -> unpack_dataset -> load_dataset ->
   do_split -> SegPatchLoader, then Trainer.run_training of the full-width
   Task002 2d U-Net (float32, SGD-Nesterov + poly, CSOF_CONV2D_IMPL=pallas)
   at batch 40 x 320x256: 2 epochs x 6 steps + 2 validation batches;
   finite losses, a fg-dice in the log, 7 K6 + 6 K6-dx launches per step,
   the checkpoint triad written and reloaded; train slices/s.
15. unet train parity: full width, batch 2 of 320x256, float32: the GPU
   loss and every parameter gradient against the CPU's.
16. ncc: K4 against its plain version at 20 x 128^2 (the SegFlow loss's
   B=4 x 5 planes) and two ragged shapes, with times; then ncc_loss_kernel,
   the op's entry point, on the same planes against the port's ncc_loss.

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
#: K1 and K3 across their tilings' edges, (B, C, F, H, W, radius, stride):
#: W 5, 23, 33, 65, 70, 129 (no multiple of K1's 32 or K3's 64 columns; 5,
#: 23, 33, 65, 129 no multiple of K1's 16-byte group either), H 3, 9, 13,
#: 17 (no multiple of the rows a block), C 7, 12, 20 (K3's channel chunks
#: straddle q, m and corr), F 12 (6 groups) and 130 (two N blocks), strides
#: 1, 2 and 3, radius 1 to 4, B 1 and 8
TILING_RAGGED = [(1, 12, 12, 17, 70, 4, 1), (8, 12, 12, 9, 33, 4, 2), (2, 20, 40, 13, 65, 3, 3),
                 (1, 32, 32, 5, 129, 1, 1), (8, 7, 130, 3, 23, 2, 2), (1, 64, 64, 17, 5, 4, 1)]
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
#: ragged shapes beside the served ones: K5 (N, C, H, W), K6 (N, Ci, Co, H,
#: W, bias, out_f32 on bf16): Ci 1, 13, 130 (not a multiple of the k step,
#: more than one chunk), Co 5, 40, 128, 130 (more than one block), W 1, 23,
#: 65, 70, 129 across the 64-pixel tiles, H 1 and 17
K5_RAGGED = [(3, 7, 33, 129), (5, 3, 17, 9)]
K6_RAGGED = [(3, 13, 40, 17, 23, True, False), (2, 1, 5, 9, 70, True, False),
             (2, 130, 130, 17, 129, True, False), (2, 1, 128, 1, 65, False, False),
             (3, 13, 5, 17, 1, True, True), (2, 130, 40, 1, 70, False, True),
             (2, 1, 130, 17, 23, False, False)]
UNET_CASES, UNET_DEPTH, UNET_HW, UNET_SPACING = 2, 40, (320, 320), 1.25
UNET_TILE_BATCH = 8  # PredictorConfig's default, which predict_case serves with
#: K6's backward beside the training dx shapes: forward convs (N, Ci, Co, H,
#: W), whose dx conv is (Co, Ci): Ci' 1, 13, 130 and Co' 5, 40, 128, 130
K6_BWD_RAGGED = [(3, 13, 40, 17, 23), (2, 5, 9, 9, 70), (2, 130, 1, 17, 65),
                 (1, 128, 130, 1, 129), (2, 40, 13, 17, 1), (2, 5, 130, 1, 70)]
#: dx, dw, db (atol as a fraction of max|ref|, rtol): the same sums in another
#: order (float32); bf16: dx rounds once as the plain version, dw is rounded
#: to bf16 as the JAX VJP rounds it where autograd of the plain version is not
K6_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
UNET_TRAIN_CASES = 4
UNET_TRAIN_EPOCHS, UNET_TRAIN_STEPS, UNET_VAL_STEPS, UNET_TRAIN_WARMUP = 2, 6, 2, 2
#: K4 planes: (N, H, W); the first is the SegFlow loss's B=4 x (T-1)=5 at 128^2
NCC_SHAPES = [(20, 128, 128), (3, 33, 70), (2, 17, 9)]
NCC_ATOL = 1e-4  # cc in [0, ~1]; the same operations, division by a reciprocal in the plain
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


def k3_pass(name: str) -> str:
    """K3's pass of a kernel it launches: K1, the conv pass, the apply pass,
    or the rest (the wrapper's weight packing)."""
    return ("k1_pass" if "corr_kernel" in name else "conv_pass" if "fuse_conv_kernel" in name
            else "apply_pass" if "gn_apply_kernel" in name else "packing")


def check_kernels(card: str) -> dict:
    """Phase 3. Returns per kernel: max abs error over all checks, the
    summed bf16 time of kernel and plain version over the three level shapes
    (one SegFlow step), its bound (csof_tpu_torch/bounds.py) at those shapes,
    and (K3) the library conv's time and the whole chain as library calls;
    K1 and K3 also in float32 (f32_* keys), and K3's passes by device time."""
    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import bound_ms, corr_work
    from csof_tpu_torch.kernel_times import device_ms
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {k: {"max_abs_err": 0.0, "bound_by": None, "library_ms": None}
           for k in ("K1", "K2", "K3")}
    sums = {}  # (kernel, dtype) -> summed ms, plain ms, library ms, note ms, work

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def fuse_params(f, cin):
        return (rand(f, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5), rand(f, std=0.1),
                1.0 + rand(f, std=0.1), rand(f, std=0.1))

    def record(kname, err):
        res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for (c, h, w, s) in LEVELS + RAGGED:
            level = (c, h, w, s) in LEVELS
            q = rand(BATCH, c, h, w).to(dtype)
            m = rand(BATCH, c, h, w).to(dtype)
            cin = 2 * c + (2 * RADIUS + 1) ** 2
            wt, bias, gw, gb = fuse_params(c, cin)
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
                record(kname, err)
                # times at the level shapes: every kernel in bf16, K1 and K3
                # in float32 too
                if not level or (kname == "K2" and dtype != torch.bfloat16):
                    continue
                t, p = timed_pair(kern, plain)
                acc = sums.setdefault((kname, dname), {"ms": 0.0, "plain_ms": 0.0,
                                                        "work": [0.0] * 4})
                acc["ms"] += t
                acc["plain_ms"] += p
                work = corr_work(kname, b, c, h, w, dtype.itemsize)
                acc["work"] = [a + v for a, v in zip(acc["work"], work)]
                extra = ""
                if kname == "K3":
                    x = torch.cat([q, m, k1.corr_cuda(q, m, RADIUS, s)], 1)
                    wb, bb = wt.to(dtype), bias.to(dtype)
                    lib = median_ms(lambda: F.conv2d(x, wb, padding=1))
                    groups = k3.num_groups_for(c)

                    def chain():  # the whole function as library calls, K1's corr
                        xc = torch.cat([q, m, k1.corr_cuda(q, m, RADIUS, s)], 1)
                        yc = F.group_norm(F.conv2d(xc, wb, bb, padding=1), groups,
                                          gw.to(dtype), gb.to(dtype))
                        return F.leaky_relu(yc, 0.01)

                    note = median_ms(chain)
                    passes = device_ms(kern, group=k3_pass)
                    for key, v in (("library_ms", lib), ("library_note_ms", note),
                                   *((f"{k}_ms", v) for k, v in passes.items())):
                        acc[key] = acc.get(key, 0.0) + v
                    extra = (f", library F.conv2d over the {cin}-channel concat {lib:.4f} ms, "
                             f"library chain (K1, cat, conv2d, group_norm, leaky_relu) "
                             f"{note:.4f} ms; device ms a call by pass: "
                             + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
                phase("kernels", f"{kname} {tag}: kernel {t:.4f} ms, plain {p:.4f} ms"
                      f"{extra} ({card})")
        # across the tiling edges of K1 (32 x 4 or 8 tiles, 16-byte groups)
        # and K3's conv (64 x 2 or 4 tiles, N blocks of 32/64/128, 16- or
        # 8-channel chunks straddling q, m and corr)
        for (b, c, f, h, w, r, s) in TILING_RAGGED:
            tag = f"{dname} B={b} C={c} F={f} {h}x{w} r={r} s={s}"
            q = rand(b, c, h, w).to(dtype)
            m = rand(b, c, h, w).to(dtype)
            params = fuse_params(f, 2 * c + (2 * r + 1) ** 2)
            got = k1.corr_cuda(q, m, r, s)
            torch.cuda.synchronize()
            record("K1", compare("kernels", f"K1 {tag}", got, k1.corr_plain(q, m, r, s),
                                 *TOL[("K1", dname)]))
            got = k3.skip_fuse_cuda(q, m, *params, r, s)
            torch.cuda.synchronize()
            record("K3", compare("kernels", f"K3 {tag}", got,
                                 k3.skip_fuse_plain(q, m, *params, r, s), *TOL[("K3", dname)]))
    # determinism: K3 twice on the same inputs, the same bits
    for dtype in (torch.float32, torch.bfloat16):
        c, h, w, s = LEVELS[0]
        q, m = (rand(BATCH, c, h, w).to(dtype) for _ in range(2))
        params = fuse_params(c, 2 * c + (2 * RADIUS + 1) ** 2)
        a = k3.skip_fuse_cuda(q, m, *params, RADIUS, s)
        b = k3.skip_fuse_cuda(q, m, *params, RADIUS, s)
        torch.cuda.synchronize()
        expect(torch.equal(a, b), f"K3 {dtype}: two runs on the same inputs differ")
    phase("kernels", "K3 twice on the same inputs (float32, bfloat16): bit-identical")

    for kname in ("K1", "K2", "K3"):
        r = res[kname]
        for dname, prefix in (("bfloat16", ""), ("float32", "f32_")):
            acc = sums.get((kname, dname))
            if acc is None:
                continue
            bound, by = bound_ms(*acc.pop("work"))
            r.update({prefix + k: v for k, v in acc.items()})
            r[prefix + "bound_ms"], r[prefix + "bound_by"] = bound, by
        phase("kernels", f"{kname} summed over the three levels: bf16 {r['ms']:.4f} ms"
              + (f", f32 {r['f32_ms']:.4f} ms" if "f32_ms" in r else "")
              + f"; bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
              + (f", f32 {r['f32_bound_ms']:.6f}" if "f32_bound_ms" in r else "")
              + f" ({card})")

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
        fp32_cores_note,
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
                n, ci, co, h, w, *flags = shape
                with_bias, out_f32 = flags or (True, False)
                out_f32 = out_f32 and dtype == torch.bfloat16
                x = rand(n, ci, h, w).to(dtype)
                wt, bias = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5), rand(co, std=0.1)
                bias = bias if with_bias else None
                kern = lambda: k6.conv3x3_cuda(x, wt, bias, out_f32)  # noqa: E731
                plain = lambda: k6.conv3x3_plain(x, wt, bias, out_f32)  # noqa: E731
                wd, bd = wt.to(dtype), None if bias is None else bias.to(dtype)
                lib = lambda: F.conv2d(x, wd, bd, padding=1)  # noqa: E731
                tag = (f"{dname} (N, Ci, Co, H, W)={(n, ci, co, h, w)}"
                       + ("" if with_bias else " no bias") + (" out_f32" if out_f32 else ""))
            got = kern()
            torch.cuda.synchronize()
            err = compare("unet kernels", f"{kname} {tag}", got, plain(),
                          *UNET_TOL[(kname, "float32" if kname == "K6" and out_f32 else dname)])
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
        for dname, size in (("float32", 4), ("bfloat16", 2)):
            t, p, lib_ms = per_dtype[(kname, dname)]
            b, by = bound_ms(*unet_forward_work(kname, size))
            note = ""
            if kname == "K6" and size == 4:
                fp32_note = fp32_cores_note(unet_forward_work(kname, 4))[0]
                note = f", FP32-core bound (note) {fp32_note:.4f} ms"
            if kname == "K6" and size == 2:
                r["bf16_ms"], r["bf16_plain_ms"], r["bf16_library_ms"] = t, p, lib_ms
            phase("unet kernels", f"{kname} {dname}, one forward ({UNET_BATCH} x 320x256): kernel "
                  f"{t:.4f} ms, plain {p:.4f} ms, library {lib_ms:.4f} ms; {dname} bound "
                  f"{b:.4f} ms ({by}){note} ({card})")
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


def check_unet_train_kernels(card: str) -> dict:
    """Phase 13: Conv3x3Function's gradients against autograd of the plain
    version; the f32 dx time of one training step (each dx shape's median
    times its launches) of kernel, plain version and cuDNN's dgrad, with
    the bound of the same work."""
    import torch

    from csof_tpu_torch.bounds import (
        UNET_K6_DX_SHAPES,
        UNET_TRAIN_BATCH,
        bound_ms,
        fp32_cores_note,
        unet_train_work,
    )
    from csof_tpu_torch.ops.kernels import conv as k6

    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bf16_ms = [0.0, 0.0, 0.0]

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    # forward convs (N, Ci, Co, H, W) whose dx the step launches: the dx
    # shape (Ci', Co') is the conv's (Co, Ci)
    runs = [((UNET_TRAIN_BATCH, co_, ci_, h, w), count)
            for (ci_, co_, h, w), count in UNET_K6_DX_SHAPES]
    runs += [(shape, 0) for shape in K6_BWD_RAGGED]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for (n, ci, co, h, w), count in runs:
            x = rand(n, ci, h, w).to(dtype).requires_grad_(True)
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5).requires_grad_(True)
            b = rand(co, std=0.1).requires_grad_(True)
            dy = rand(n, co, h, w).to(dtype)
            got = torch.autograd.grad(k6.Conv3x3Function.apply(x, wt, b, False), (x, wt, b), dy)
            torch.cuda.synchronize()
            ref = torch.autograd.grad(k6.conv3x3_plain(x, wt, b), (x, wt, b), dy)
            tag = f"{dname} conv (N, Ci, Co, H, W)=({n}, {ci}, {co}, {h}, {w})"
            err = compare("unet train kernels", f"K6 dx {tag}", got[0], ref[0],
                          *UNET_TOL[("K6", dname)])
            res["max_abs_err"] = max(res["max_abs_err"], err)
            frac, rtol = K6_BWD_TOL[dname]
            for gname, a, r in (("dw", got[1], ref[1]), ("db", got[2], ref[2])):
                compare("unet train kernels", f"K6 {gname} {tag}", a, r,
                        frac * float(r.abs().max()), rtol)
            if not count:
                continue
            xd, wd, dyd = x.detach(), wt.detach(), dy.contiguous()
            kern = lambda: k6.conv3x3_dx_cuda(dyd, wd)  # noqa: E731
            plain = lambda: k6.conv3x3_dx_plain(dyd, wd)  # noqa: E731
            wl = wd.to(dtype)
            lib = lambda: torch.nn.grad.conv2d_input(xd.shape, wl, dyd, padding=1)  # noqa: E731
            t, p = timed_pair(kern, plain)
            lib_ms = median_ms(lib)
            if dtype == torch.float32:
                res["ms"] += count * t
                res["plain_ms"] += count * p
                res["library_ms"] += count * lib_ms
            else:
                bf16_ms = [a + count * v for a, v in zip(bf16_ms, (t, p, lib_ms))]
            phase("unet train kernels", f"K6 dx of {tag} x{count} per step: kernel {t:.4f} ms, "
                  f"plain {p:.4f} ms, torch.nn.grad.conv2d_input {lib_ms:.4f} ms ({card})")
    res["bound_ms"], res["bound_by"] = bound_ms(*unet_train_work("K6_dx"))
    fp32_note = fp32_cores_note(unet_train_work("K6_dx"))[0]
    bf16_bound, bf16_by = bound_ms(*unet_train_work("K6_dx", 2))
    res["bf16_ms"], res["bf16_plain_ms"], res["bf16_library_ms"] = bf16_ms
    phase("unet train kernels", f"K6 dx, one training step ({UNET_TRAIN_BATCH} x 320x256), "
          f"float32: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, conv2d_input "
          f"{res['library_ms']:.4f} ms, bound as 3xTF32 {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), FP32-core bound (note) {fp32_note:.4f} ms; "
          f"bfloat16: kernel {bf16_ms[0]:.4f} ms, plain {bf16_ms[1]:.4f} ms, conv2d_input "
          f"{bf16_ms[2]:.4f} ms, bound {bf16_bound:.4f} ms ({bf16_by}) ({card})")
    torch.cuda.synchronize()
    return res


class _TimedIter:
    """Iterator wrapper that records the host seconds of each next()."""

    def __init__(self, it):
        self.it, self.seconds = it, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        self.seconds.append(time.perf_counter() - t0)
        return item


def _kernel_modules():
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import ncc as k4
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    return k1, k3, k4, k5, k6


def _reset_counts() -> None:
    k1, k3, k4, k5, k6 = _kernel_modules()
    k1.launches = k1.bwd_launches = k3.launches = k4.launches = k5.launches = 0
    k6.launches = k6.bwd_launches = 0


def _read_counts() -> dict:
    k1, k3, k4, k5, k6 = _kernel_modules()
    return {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches, "K4": k4.launches,
            "K5": k5.launches, "K6": k6.launches, "K6_dx": k6.bwd_launches}


def unet_train_data(plans, tmp: Path) -> dict:
    """Synthetic Task002-like cases through the port's data plane: NIfTI
    files -> run_cropping -> Preprocessor.run -> unpack_dataset ->
    load_dataset. Returns the dataset dict."""
    from csof_tpu_torch.data.cropping import run_cropping
    from csof_tpu_torch.data.dataset import load_dataset, unpack_dataset
    from csof_tpu_torch.data.preprocessing import Preprocessor
    from csof_tpu_torch.utils.nifti import save_nifti

    rng = np.random.RandomState(7)
    spacing_xyz = (UNET_SPACING, UNET_SPACING, 1.37)
    cases = []
    t0 = time.perf_counter()
    for i in range(UNET_TRAIN_CASES):
        img = synthetic_case(rng)
        img_path, seg_path = tmp / f"la_{i:03d}_0000.nii", tmp / f"la_{i:03d}_seg.nii"
        save_nifti(img, img_path, spacing_xyz=spacing_xyz)
        save_nifti((img > 150).astype(np.uint8), seg_path, spacing_xyz=spacing_xyz)
        cases.append((f"la_{i:03d}", [str(img_path)], str(seg_path)))
    run_cropping(cases, tmp / "cropped")
    Preprocessor(plans).run(tmp / "cropped", tmp / "preprocessed")
    unpack_dataset(tmp / "preprocessed")
    ds = load_dataset(tmp / "preprocessed")
    expect(sorted(ds) == [c for c, _, _ in cases], f"preprocessed cases {sorted(ds)}")
    phase("unet train", f"{UNET_TRAIN_CASES} cases (1, {UNET_DEPTH}, {UNET_HW[0]}, "
          f"{UNET_HW[1]}) cropped, preprocessed and unpacked in "
          f"{time.perf_counter() - t0:.1f} s host clock")
    return ds


def unet_train(card: str) -> dict:
    """Phase 14: Trainer.run_training of the full-width Task002 2d U-Net at
    batch 40 on SegPatchLoader batches."""
    import os

    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.data.dataset import do_split
    from csof_tpu_torch.data.loaders import SegPatchLoader
    from csof_tpu_torch.training import checkpoint as ckpt
    from csof_tpu_torch.training.trainer import Trainer

    plans = task002_heart_2d()
    sp = plans.fullres_stage()
    config = ExperimentConfig(
        model="unet2d", max_num_epochs=UNET_TRAIN_EPOCHS,
        num_batches_per_epoch=UNET_TRAIN_STEPS, num_val_batches_per_epoch=UNET_VAL_STEPS,
        optim=OptimConfig(optimizer="sgd", scheduler="poly", initial_lr=1e-2,
                          weight_decay=3e-5),
        data=DataConfig(do_data_aug=False))
    n = UNET_TRAIN_EPOCHS * UNET_TRAIN_STEPS
    n_val = UNET_TRAIN_EPOCHS * UNET_VAL_STEPS
    env = {k: os.environ.pop(k, None) for k in ("CSOF_CONV2D_IMPL", "CSOF_FUSED_NORM")}
    os.environ["CSOF_CONV2D_IMPL"] = "pallas"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ds = unet_train_data(plans, Path(tmp))
            tr_keys, va_keys = do_split(list(ds), config.fold)
            train_it = _TimedIter(SegPatchLoader({k: ds[k] for k in tr_keys}, sp.patch_size,
                                                 sp.batch_size, seed=config.seed))
            val_it = SegPatchLoader({k: ds[k] for k in va_keys}, sp.patch_size, sp.batch_size,
                                    seed=config.seed + 1)
            out = Path(tmp) / "fold_0"
            trainer = Trainer(config, out, plans=plans, device="cuda").initialize()
            trainer.checkpoint_every = UNET_TRAIN_EPOCHS  # so that the run writes "latest"
            per_step = trainer.model.kernel_launches(sp.patch_size[1], backward=True)
            expect(per_step == {"K5": 0, "K6": 7, "K6_dx": 6}, f"per step {per_step}")
            step, event_ms, losses, lines = trainer.run_iteration, [], [], []

            def timed_step(batch, train=True):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, aux = step(batch, train)  # ends in a read of the loss: synchronised
                end.record()
                end.synchronize()
                if train:
                    event_ms.append(start.elapsed_time(end))
                    losses.append(loss)
                return loss, aux

            def log(msg):
                lines.append(msg)
                phase("unet train", msg)

            trainer.run_iteration = timed_step
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            hist = trainer.run_training(train_it, val_it, log_fn=log)
            counts = _read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            expect(len(losses) == n and all(np.isfinite(losses)), f"losses {losses}")
            want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 7 * (n + n_val),
                    "K6_dx": 6 * n}
            expect(counts == want, f"launches in the U-Net train run {counts}, expected {want}")
            expect(len(hist.eval_metrics) == UNET_TRAIN_EPOCHS
                   and all(np.isfinite(hist.eval_metrics)), f"fg-dice {hist.eval_metrics}")
            expect(all(" fg-dice " in line for line in lines[:UNET_TRAIN_EPOCHS]),
                   f"no fg-dice in the log {lines}")
            for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
                expect((out / name).is_file() and (out / (name + ".json")).is_file(),
                       f"checkpoint {name} or its sidecar missing")
            trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            fresh = Trainer(config, out, plans=plans, device="cuda")
            meta = fresh.load_checkpoint()
            expect(meta["epoch"] == UNET_TRAIN_EPOCHS and fresh.optimizer.count == n,
                   f"reloaded epoch {meta['epoch']}, step {fresh.optimizer.count}")
            expect(all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items()),
                   "the reloaded weights differ from the trained ones")
            del fresh, trainer, trained
    finally:
        for k, v in env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    steps = hist.step_times[UNET_TRAIN_WARMUP:]
    med = statistics.median(steps)
    load_s = train_it.seconds[UNET_TRAIN_WARMUP:]
    phase("unet train", f"{n} steps + {n_val} validation batches, losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, fg-dice {hist.eval_metrics}; launches {counts} (7 K6 + 6 K6 dx "
          f"per step, 7 K6 per validation batch); checkpoint triad written and reloaded; peak "
          f"device memory {peak_gb:.2f} GB")
    phase("unet train", f"step ({sp.batch_size}, 1, 320, 256) float32: median "
          f"{med * 1e3:.3f} ms host clock over {len(steps)} steps after {UNET_TRAIN_WARMUP} "
          f"warm-up (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}) -> "
          f"{sp.batch_size / med:.2f} train slices/s; CUDA-event step median "
          f"{statistics.median(event_ms[UNET_TRAIN_WARMUP:]):.3f} ms; SegPatchLoader batch "
          f"median {statistics.median(load_s) * 1e3:.3f} ms host clock, outside the step, on "
          f"{card}")
    return counts


def unet_train_parity(card: str) -> None:
    """Phase 15: float32 loss and every gradient of the full-width U-Net at
    batch 2 of 320x256, GPU kernels vs CPU plain versions.

    At this size a gradient leaf moves by more than GRAD_TOL under float32
    rounding alone: the deepest levels hold 5 x 4 pixels a plane, where a
    LeakyReLU input that rounding pushes across 0 changes its slope 100-fold.
    So the CPU is also run on the input scaled by 1 + 1e-7 noise (below a
    float32 ulp for most values), and the GPU's worst leaf is held to
    GRAD_TOL, or to twice the worst leaf of that CPU-vs-CPU floor where the
    floor itself exceeds it; the median leaf is held to GRAD_TOL."""
    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.trainer import make_seg_loss

    cpu = unet_from_plans(task002_heart_2d(), conv_impl="pallas", fused_norm_act=False,
                          generator=torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(8)
    seg = np.zeros((2, 320, 256), np.int32)
    seg[:, 100:200, 80:170] = 1
    data = (rng.randn(2, 1, 320, 256) + seg[:, None]).astype(np.float32)
    noisy = (data * (1 + 1e-7 * rng.randn(*data.shape))).astype(np.float32)
    loss_fn = make_seg_loss(ExperimentConfig(model="unet2d", data=DataConfig(do_data_aug=False)))

    def grads(model, x, device):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {"data": torch.from_numpy(x).to(device),
                                  "seg": torch.from_numpy(seg).to(device)})
        loss.backward()
        return loss.item(), {k: None if p.grad is None else p.grad.cpu()
                             for k, p in model.named_parameters()}

    def ratios(got, ref):
        """|diff| / (GRAD_TOL max|ref| + 1e-6) of each leaf with a gradient."""
        out = {}
        for name, r in ref.items():
            expect((got[name] is None) == (r is None), f"{name}: a gradient on one side only")
            if r is None:  # the zero-weight deep-supervision head
                continue
            expect(bool(torch.isfinite(got[name]).all()), f"{name}: non-finite gradient")
            out[name] = float((got[name] - r).abs().max()) / (GRAD_TOL * float(r.abs().max())
                                                               + 1e-6)
        return out

    before = (k6.launches, k6.bwd_launches)
    a, g_gpu = grads(gpu, data, "cuda")
    torch.cuda.synchronize()
    expect((k6.launches - before[0], k6.bwd_launches - before[1]) == (7, 6),
           "the GPU step did not run 7 K6 + 6 K6 dx")
    b, g_cpu = grads(cpu, data, "cpu")
    _, g_noisy = grads(cpu, noisy, "cpu")
    expect(abs(a - b) <= LOSS_RTOL * abs(b), f"loss GPU {a} vs CPU {b}")
    gpu_r, floor_r = ratios(g_gpu, g_cpu), ratios(g_noisy, g_cpu)
    worst_name = max(gpu_r, key=gpu_r.get)
    worst, floor, med = gpu_r[worst_name], max(floor_r.values()), statistics.median(
        gpu_r.values())
    limit = max(1.0, 2 * floor)
    ok = worst <= limit and med <= 1
    phase("unet train parity", f"full width float32 (2, 1, 320, 256): loss GPU {a:.7f} vs CPU "
          f"{b:.7f}; {len(gpu_r)} gradients, |diff| / (tol {GRAD_TOL:g} max|g| + 1e-6): worst "
          f"{worst:.3f} at {worst_name}, median {med:.4f}; CPU vs CPU on the input x (1 + 1e-7 "
          f"noise): worst {floor:.3f} at {max(floor_r, key=floor_r.get)}; limit {limit:.3f} "
          f"-> {'ok' if ok else 'FAIL'} ({card})")
    expect(ok, f"gradient {worst_name} outside tolerance")


def check_ncc(card: str) -> tuple[dict, dict]:
    """Phase 16: K4 against its plain version, with times at the SegFlow
    loss shape; then the op's entry point, ncc_loss_kernel, driven alone."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, ncc_work
    from csof_tpu_torch.ops import losses as L
    from csof_tpu_torch.ops.kernels import ncc as k4

    rng = np.random.RandomState(9)
    res = {"max_abs_err": 0.0, "library_ms": None}
    for i, (n, h, w) in enumerate(NCC_SHAPES):
        a = rng.rand(n, h, w).astype(np.float32)
        a[:, : h // 3, : w // 3] = 0.4  # a constant region
        b = (0.7 * a + 0.3 * rng.rand(n, h, w)).astype(np.float32)
        pa, pb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        got = k4.ncc_map_cuda(pa, pb)
        torch.cuda.synchronize()
        err = compare("ncc", f"K4 float32 (N, H, W)=({n}, {h}, {w}) window 9", got,
                      k4.ncc_map_plain(pa, pb), NCC_ATOL, 0.0)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if i == 0:
            res["ms"], res["plain_ms"] = timed_pair(lambda: k4.ncc_map_cuda(pa, pb),
                                                    lambda: k4.ncc_map_plain(pa, pb))
            res["bound_ms"], res["bound_by"] = bound_ms(*ncc_work(n, h, w))
            loss_ms = median_ms(lambda: L.ncc_loss(pa[..., None], pb[..., None],
                                                   reduction="none"))
            phase("ncc", f"K4 ({n}, {h}, {w}): kernel {res['ms']:.4f} ms, plain "
                  f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms "
                  f"({res['bound_by']}); library: none (no one PyTorch call; note: the port's "
                  f"ncc_loss map, average pooling and elementwise calls, {loss_ms:.4f} ms) "
                  f"({card})")
            moving = pa[..., None]
            fixed = pb[:1].expand_as(pb)[..., None].contiguous()
    _reset_counts()
    value = k4.ncc_loss_kernel(moving, fixed)
    torch.cuda.synchronize()
    counts = _read_counts()
    ref = L.ncc_loss(moving, fixed)
    expect(abs(value.item() - ref.item()) <= 1e-5,
           f"ncc_loss_kernel {value.item()} vs ncc_loss {ref.item()}")
    expect(counts["K4"] == 1 and sum(counts.values()) == 1, f"launches {counts}")
    phase("ncc", f"ncc_loss_kernel on {tuple(moving.shape)}: {value.item():.6f} vs ncc_loss "
          f"{ref.item():.6f}; launches {counts} ({card})")
    return res, counts


#: the keys every kernel has in the kernels line; a kernel's other measured
#: numbers (bf16 or float32 times, library notes, K3's passes) follow them
_MAIN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


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
    from csof_tpu_torch.sass_census import counts

    hgmma = {}
    tc_kernels = ("conv3x3_kernel", "conv3x3_dx_kernel", "fuse_conv_kernel")
    for name, n in counts(lib).items():
        for kern in tc_kernels:
            if f"::{kern}<" in name:
                hgmma.setdefault(kern, []).append(n)
    expect(set(hgmma) == set(tc_kernels) and all(min(v) > 0 for v in hgmma.values()),
           f"K6 or K3's conv pass without tensor-core instructions: {hgmma}")
    phase("build", "HGMMA instructions per K6 and K3-conv instantiation (cuobjdump -sass): "
          f"{hgmma}")

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
    del unet, unet_cpu
    torch.cuda.empty_cache()
    kernels["K6_dx"] = check_unet_train_kernels(card)
    unet_train_counts = unet_train(card)
    unet_train_parity(card)
    kernels["K4"], ncc_counts = check_ncc(card)

    paths = {"serving": counts, "train": train_counts, "unet_serving": unet_counts,
             "unet_training": unet_train_counts, "ncc_op": ncc_counts}
    by_path = {k: {path: c.get(k, 0) for path, c in paths.items()}
               for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K6_dx")}
    sources = {
        "K1": ("local_correlation", "csof_tpu_torch/csrc/corr.cu",
               "csof_tpu/ops/pallas/corr.py:131", None),
        "K2": ("local_correlation_backward", "csof_tpu_torch/csrc/corr_bwd.cu",
               "csof_tpu/ops/pallas/corr.py:409", None),
        "K3": ("fused_skip_fuse", "csof_tpu_torch/csrc/skipfuse.cu",
               "csof_tpu/ops/pallas/skipfuse.py:236",
               "F.conv2d over the (2C+81)-channel concat: K3's conv pass only; "
               "library_note_ms: the whole function as library calls (K1's corr, "
               "torch.cat, F.conv2d, F.group_norm, F.leaky_relu)"),
        "K4": ("ncc_map", "csof_tpu_torch/csrc/ncc.cu", "csof_tpu/ops/pallas/ncc.py:49",
               "none: no one PyTorch call computes the map (on no path of the JAX package; "
               "driven alone through ncc_loss_kernel)"),
        "K5": ("instance_norm_leaky_relu", "csof_tpu_torch/csrc/norm_act.cu",
               "csof_tpu/ops/pallas/norm_act.py:34",
               "none: no one PyTorch call; library_note_ms times F.instance_norm + "
               "F.leaky_relu"),
        "K6": ("conv3x3", "csof_tpu_torch/csrc/conv3x3.cu", "csof_tpu/ops/pallas/conv.py:175",
               "F.conv2d(x, w, b, padding=1)"),
        "K6_dx": ("conv3x3_dx", "csof_tpu_torch/csrc/conv3x3.cu",
                  "csof_tpu/ops/pallas/conv.py:229",
                  "torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1) (cuDNN dgrad)"),
    }
    line = {"kernels": [
        {"name": f"{k} {name}", "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[k].values()), "launches_by_path": by_path[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"], "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"], "library_ms": kernels[k]["library_ms"],
         **({"library_call": lib_call} if lib_call else {}),
         **{key: v for key, v in kernels[k].items() if key not in _MAIN_KEYS}}
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
