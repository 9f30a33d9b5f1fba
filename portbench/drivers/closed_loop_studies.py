"""A closed loop of cine studies through the port's serving predictor.

One client sends a study, waits for the returned dict, and sends the next:
``FlowPredictor.predict_video`` (ROI crop with the mask supplied, per-frame
min-max, one batched SegFlow forward of all slices under the serving remap,
softmax, copies to the host, uncrop). Latency is the call's host time; the
images of a study are its frames x slices. The outputs of a seeded sample
of the completed requests, with a deepest study among them, are kept and,
once the window has closed and the program's state is freed, compared with
the plain float32 reference run on the same inputs and weights.
"""

from __future__ import annotations

import math
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import generator, harness
from portbench.reference import segflow as ref
from portbench.reference.common import Precision, tf32_off
from portbench.yardstick import bounds, flops


@dataclass
class State:
    predictor: object
    model: torch.nn.Module
    pool: list
    order: list
    #: (pool index, outputs) kept for the check
    kept: list = field(default_factory=list)
    deepest: tuple | None = None
    completed: list = field(default_factory=list)  # pool index of each completed request
    offered: int = 0  # requests offered to the sample

    @property
    def max_depth(self) -> int:
        return max(v.shape[1] for v, _ in self.pool)


def model_cfg(ctx) -> dict:
    return ctx.config["model"]


def reference_model(ctx, prec: Precision | None = None, device=None) -> ref.SegFlow:
    return ref.SegFlow(model_cfg(ctx), ctx.config["num_classes"], prec,
                       device=device or ctx.device)


def setup(ctx) -> State:
    from csof_tpu_torch.config.experiment import SegFlowModelConfig
    from csof_tpu_torch.inference.flow_predictor import FlowPredictor
    from csof_tpu_torch.inference.serving import apply_serving_config
    from csof_tpu_torch.models.segflow import SegFlow

    mix, cfg = ctx.traffic, ctx.config
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg(ctx).items()}
    serving = apply_serving_config(SegFlowModelConfig(**fields), mix["frames"])
    if serving.corr_fuse != cfg["serving_corr_fuse"]:
        raise RuntimeError(f"the serving remap gave corr_fuse={serving.corr_fuse!r}, the "
                           f"configuration states {cfg['serving_corr_fuse']!r}")
    model = SegFlow(serving, cfg["num_classes"], conv_impl=cfg["env"]["CSOF_CONV2D_IMPL"],
                    fused_norm_act=cfg["env"]["CSOF_FUSED_NORM"] == "1").to(ctx.device).eval()
    spec = harness.weight_spec(reference_model(ctx, device="meta"))
    model.load_state_dict(harness.draw_weights(spec, ctx.seed, ctx.device), strict=True)
    predictor = FlowPredictor(model, crop_size=cfg["crop_size"], do_mirroring=mix["tta"],
                              device=ctx.device)
    pool, order = generator.make(mix, ctx.seed, ctx.device)
    state = State(predictor, model, pool, order)
    for depth in sorted({v.shape[1] for v, _ in pool}):  # every shape the window sends
        i = next(j for j, (v, _) in enumerate(pool) if v.shape[1] == depth)
        for _ in range(2):
            predictor.predict_video(*pool[i])
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    return state


def _keep(state: State, rng, index: int, out: dict, k: int) -> None:
    """Keep the first deepest study's outputs, and a uniform sample of k of
    the other completed requests' (reservoir sampling)."""
    if state.deepest is None and state.pool[index][0].shape[1] == state.max_depth:
        state.deepest = (index, out)
        return
    state.offered += 1
    if len(state.kept) < k:
        state.kept.append((index, out))
    else:
        j = int(rng.integers(0, state.offered))
        if j < k:
            state.kept[j] = (index, out)


def window(state: State, ctx) -> dict:
    """The closed loop for ``ctx.seconds``; returns the end-to-end numbers."""
    rng = np.random.default_rng(generator.child_seed(ctx.seed, "sample"))
    mix = ctx.traffic
    latencies, images, failed, i = [], 0, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        index = state.order[i % len(state.order)]
        video, mask = state.pool[index]
        ts = time.perf_counter()
        try:
            out = state.predictor.predict_video(video, roi_mask=mask)
        except Exception:  # a failed request counts, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
            latencies.append(math.inf)
        else:
            latencies.append(time.perf_counter() - ts)
            images += video.shape[0] * video.shape[1]
            _keep(state, rng, index, out, mix["check_sample"])
            state.completed.append(index)
        i += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": i, "failed": failed, "elapsed_s": elapsed,
            "study_latency_p95_ms": harness.p95(latencies) * 1e3,
            "serve_images_per_s": images / elapsed}


def traced(state: State, ctx, window_result: dict) -> None:
    """The traced slices after the window: the model FLOPs of the window's
    requests, one profiled slice with the kernels' shapes recorded, and one
    slice with the forward calls timed apart from the rest."""
    from portbench import shims
    from portbench.yardstick import trace

    mix, cfg = ctx.traffic, ctx.config
    items = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                         for k, v in model_cfg(ctx).items()))
    per_slice = flops.segflow_forward_flops(items, cfg["num_classes"], 1, mix["frames"],
                                            cfg["crop_size"])
    passes = 4 if mix["tta"] else 1
    done = sum(state.pool[i][0].shape[1] for i in state.completed)
    ctx.record["window_flops"] = per_slice * done * passes
    ctx.record["window_s"] = window_result["elapsed_s"]
    ctx.record["peak_flops"] = bounds.MFU_PEAK_FLOPS[cfg["dtype"]]

    picks = [state.order[j % len(state.order)] for j in range(mix["traced_requests"])]

    def serve():
        for index in picks:
            with torch.profiler.record_function("portbench: predict_video"):
                state.predictor.predict_video(*state.pool[index])

    with shims.LaunchRecorder() as rec, shims.Annotated(state.model, "portbench: forward"):
        _, sl = trace.profiled(serve)
    print(f"traced slice: {sl.summary()}", file=sys.stderr)
    ctx.record["slice"] = sl
    ctx.record["slice_images"] = sum(state.pool[i][0].shape[0] * state.pool[i][0].shape[1]
                                     for i in picks)
    ctx.record["launch_bounds"] = rec.bounds()

    host_ms = []
    for index in picks:
        with shims.ForwardSpans(state.model) as spans:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.predictor.predict_video(*state.pool[index])
            total = time.perf_counter() - t0
        host_ms.append((total - sum(spans.spans)) * 1e3)
    ctx.record["predictor_host_ms"] = host_ms


def free(state: State) -> list:
    """Drop the program's state; return the outputs kept for the check."""
    kept = state.kept + ([state.deepest] if state.deepest is not None else [])
    state.predictor = state.model = None
    harness.free_device()
    return kept


def reference_outputs(ctx, model: ref.SegFlow, video: np.ndarray, mask: np.ndarray) -> dict:
    crops, (y0, x0) = ref.crop_inputs(video, mask, ctx.config["crop_size"])
    out = ref.network_outputs(model, torch.from_numpy(crops).to(ctx.device))
    out["window"] = (y0, x0)
    return out


def _rel_rms(a: np.ndarray, b: np.ndarray) -> float:
    d = (a.astype(np.float64) - b).ravel()
    return float(np.sqrt(d @ d) / max(np.sqrt(b.astype(np.float64).ravel() @ b.ravel()), 1e-30))


def compare(ctx, out: dict, want: dict) -> dict[str, float]:
    """The numbers of one request: program ``out`` (the predictor's dict,
    full field of view) against the reference's ``want`` (in its crop)."""
    cs = ctx.config["crop_size"]
    y0, x0 = want["window"]
    rec = out["roi_record"]
    win = (slice(y0, y0 + cs), slice(x0, x0 + cs))
    soft = np.moveaxis(out["softmax"][(..., *win)], 0, -1)
    flow = out["flow"][:, :, win[0], win[1]]
    reg = out["registered"][(..., *win)]
    outside = np.ones(out["registered"].shape[-2:], bool)
    outside[win] = False
    fill = np.abs(out["softmax"][0][..., outside] - 1.0).max(initial=0.0)
    fill = max(fill, np.abs(out["softmax"][1:][..., outside]).max(initial=0.0),
               np.abs(out["flow"][:, :, outside]).max(initial=0.0),
               np.abs(out["registered"][..., outside]).max(initial=0.0))
    return {"window_mismatch": float((rec["y0"], rec["x0"]) != (y0, x0)),
            "outside_fill_gap": float(fill),
            "softmax_rel_rms": _rel_rms(soft, want["softmax"]),
            "flow_rel_rms": _rel_rms(flow, want["flow"]),
            "registered_rel_rms": _rel_rms(reg, want["registered"])}


def worst(readings: list[dict]) -> dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]} if readings else {}


def check(ctx, state: State, kept: list) -> dict[str, float]:
    """Every kept output against the float32 reference (TF32 off)."""
    if ctx.device != "cpu":
        tf32_off()
    model = reference_model(ctx)
    spec = harness.weight_spec(model)
    model.load_state_dict(harness.draw_weights(spec, ctx.seed, ctx.device))
    return worst([compare(ctx, out, reference_outputs(ctx, model, *state.pool[index]))
                  for index, out in kept])  # none kept: no numbers, so not correct


def control(ctx, state: State, indices: list) -> dict[str, float]:
    """The control: the reference with every product's operands in fp8,
    put in the program's place and judged as the program is."""
    tf32_off()
    exact = reference_model(ctx)
    low = reference_model(ctx, Precision("fp8"))
    weights = harness.draw_weights(harness.weight_spec(exact), ctx.seed, ctx.device)
    exact.load_state_dict(weights)
    low.load_state_dict(weights)
    readings = []
    for index in indices:
        video, mask = state.pool[index]
        want = reference_outputs(ctx, exact, video, mask)
        got = reference_outputs(ctx, low, video, mask)
        readings.append(compare(ctx, _as_served(ctx, got, video.shape), want))
    return worst(readings)


def _as_served(ctx, out: dict, shape) -> dict:
    """Reference outputs (in the crop) laid out as the predictor returns them."""
    t, d, h, w = shape
    cs = ctx.config["crop_size"]
    y0, x0 = out["window"]
    c = out["softmax"].shape[-1]
    soft = np.zeros((c, t, d, h, w), np.float32)
    soft[0] = 1.0
    soft[:, :, :, y0:y0 + cs, x0:x0 + cs] = np.moveaxis(out["softmax"], -1, 0)
    flow = np.zeros((t, d, h, w, 2), np.float32)
    flow[:, :, y0:y0 + cs, x0:x0 + cs] = out["flow"]
    reg = np.zeros((t, d, h, w), np.float32)
    reg[..., y0:y0 + cs, x0:x0 + cs] = out["registered"]
    return {"softmax": soft, "flow": flow, "registered": reg,
            "roi_record": {"y0": y0, "x0": x0}}
