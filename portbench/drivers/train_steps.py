"""Back-to-back training steps of the port's nnU-Net trainer.

Set-up builds one ``Trainer`` (the plans' U-Net, SGD-Nesterov under the poly
schedule, clip 12), loads the weights drawn from the seed, and drives it
through its first steps with ``Trainer.run_iteration`` on the first batches
of a seeded pool of host batches, every row different; those steps are the
warm-up and the ones the check follows. The window then runs the same call
on the pool, cycled, each step ending in the loss read that
``run_iteration`` does. Once the window has closed and the program's state
is freed, the plain reference repeats the first steps from the same weights
on the same batches: each step's loss, the first gradient as the optimizer
was handed it (worked out from its momentum after one step) and the
parameters' change over those steps are compared leaf by leaf.
"""

from __future__ import annotations

import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

from portbench import generator, harness
from portbench.reference import unet as ref
from portbench.reference.common import tf32_off
from portbench.yardstick import bounds, flops


@dataclass
class State:
    trainer: object
    pool: list
    tmp: object
    losses: list = field(default_factory=list)
    p0: list = field(default_factory=list)
    buf1: list = field(default_factory=list)
    p_last: list = field(default_factory=list)
    names: list = field(default_factory=list)


def reference_model(ctx, device=None) -> ref.UNet2d:
    m = ctx.config["model"]
    return ref.UNet2d(m["base_num_features"], m["max_features"], len(m["pool_op_kernel_sizes"]),
                      ctx.config["num_classes"], device=device or ctx.device)


def _mix(ctx) -> dict:
    """The traffic mix with the plan's batch and patch, which its batches take."""
    m = ctx.config["model"]
    return {**ctx.traffic, "batch": m["batch_size"], "patch": m["patch_size"]}


def setup(ctx) -> State:
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.training.trainer import Trainer

    cfg, mix = ctx.config, _mix(ctx)
    plans = task002_heart_2d(cfg["num_classes"] - 1)
    stage = plans.plans_per_stage[0]
    stage.batch_size, stage.patch_size = mix["batch"], tuple(mix["patch"])
    m = cfg["model"]
    plans.base_num_features = m["base_num_features"]
    stage.pool_op_kernel_sizes = m["pool_op_kernel_sizes"]
    stage.conv_kernel_sizes = m["conv_kernel_sizes"]
    config = ExperimentConfig(
        model="unet2d", deep_supervision=True, seed=generator.child_seed(ctx.seed, "config"),
        max_num_epochs=cfg["max_num_epochs"], num_batches_per_epoch=cfg["num_batches_per_epoch"],
        optim=OptimConfig(**cfg["optim"]), data=DataConfig(do_data_aug=mix["augmentation"]))
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(config, tmp.name, plans=plans, device=ctx.device).initialize()
    spec = harness.weight_spec(reference_model(ctx, device="meta"))
    trainer.model.load_state_dict(harness.draw_weights(spec, ctx.seed, ctx.device), strict=True)
    state = State(trainer, generator.make(mix, ctx.seed, ctx.device), tmp)
    params = trainer.optimizer.params
    state.names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    state.p0 = [p.detach().clone() for p in params]
    for k in range(mix["checked_steps"]):
        state.losses.append(trainer.run_iteration(state.pool[k])[0])
        if k == 0:
            st = trainer.optimizer.inner.state
            state.buf1 = [st[p]["momentum_buffer"].clone() for p in params]
    state.p_last = [p.detach().clone() for p in params]
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    return state


def window(state: State, ctx) -> dict:
    mix = _mix(ctx)
    first = mix["checked_steps"]
    steps, failed, i = 0, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        try:
            state.trainer.run_iteration(state.pool[(first + i) % len(state.pool)])
        except Exception:  # a failed step counts, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
        else:
            steps += 1
        i += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": i, "failed": failed, "elapsed_s": elapsed,
            "train_images_per_s": mix["batch"] * steps / elapsed, "steps": steps}


def traced(state: State, ctx, window_result: dict) -> None:
    """Model FLOPs of the window's steps; one profiled slice of steps with
    the kernels' shapes recorded; the optimizer's device time by CUDA events."""
    from portbench import shims
    from portbench.yardstick import trace

    mix, m = _mix(ctx), ctx.config["model"]
    per_step = flops.unet_step_flops(m["base_num_features"], m["max_features"],
                                     len(m["pool_op_kernel_sizes"]), ctx.config["num_classes"],
                                     mix["batch"], tuple(mix["patch"]))
    ctx.record["window_flops"] = per_step * window_result["steps"]
    ctx.record["window_s"] = window_result["elapsed_s"]
    ctx.record["peak_flops"] = bounds.MFU_PEAK_FLOPS[ctx.config["dtype"]]
    n = mix["traced_steps"]

    def steps():
        for j in range(n):
            with torch.profiler.record_function("portbench: run_iteration"):
                state.trainer.run_iteration(state.pool[j % len(state.pool)])

    with shims.LaunchRecorder() as rec:
        _, sl = trace.profiled(steps)
    print(f"traced slice: {sl.summary()}", file=sys.stderr)
    ctx.record["slice"] = sl
    ctx.record["slice_images"] = n * mix["batch"]
    ctx.record["launch_bounds"] = rec.bounds()
    with shims.CudaEventTimer(state.trainer.optimizer, "step") as timer:
        steps()
    ctx.record["optimizer_ms"] = timer.ms()


def free(state: State) -> dict:
    """Drop the program's state; return what the check needs of it."""
    wd = state.trainer.config.optim.weight_decay
    prog = {"losses": state.losses, "names": state.names,
            "grads": [b - wd * p for b, p in zip(state.buf1, state.p0)],
            "delta": [b - a for a, b in zip(state.p0, state.p_last)]}
    state.trainer = state.p0 = state.buf1 = state.p_last = None
    state.tmp.cleanup()
    harness.free_device()
    return prog


def reference_steps(ctx, pool: list, rows: int | None = None) -> dict:
    """The reference's first steps from the seed's weights on the pool's
    first batches: losses, first clipped gradients, parameter change.
    ``rows`` takes only the first rows of each batch (a planted fault)."""
    cfg, mix = ctx.config, ctx.traffic
    model = reference_model(ctx)
    model.load_state_dict(harness.draw_weights(harness.weight_spec(model), ctx.seed, ctx.device))
    o = cfg["optim"]
    total = cfg["max_num_epochs"] * cfg["num_batches_per_epoch"]
    opt = ref.SGD(model.parameters(),
                  lambda c: ref.poly_lr(o["initial_lr"], c, total, o["poly_exponent"]),
                  o["sgd_momentum"], o["weight_decay"], o["grad_clip_norm"])
    p0 = [p.detach().clone() for p in model.parameters()]
    losses = []
    for k in range(mix["checked_steps"]):
        data = torch.from_numpy(pool[k]["data"][:rows]).to(ctx.device).movedim(-1, 1).contiguous()
        seg = torch.from_numpy(pool[k]["seg"][:rows]).to(ctx.device)
        for p in model.parameters():
            p.grad = None
        loss = ref.loss(model, data, seg)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "names": [n for n, _ in model.named_parameters()],
            "grads": opt.first_grads,
            "delta": [p.detach() - a for a, p in zip(p0, model.parameters())]}


def _norms(tensors) -> torch.Tensor:
    return torch.stack([t.double().norm() for t in tensors]).cpu()


def readings(got: dict, want: dict) -> dict[str, float]:
    """Worst-leaf gaps of ``got`` against the reference ``want``: the gap of
    two norms over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's (conv biases under InstanceNorm, the
    zero-weight head) move by round-off alone and are left out."""
    if got["names"] != want["names"]:
        raise RuntimeError("the program's and the reference's parameters differ in name or order")
    g_ref, g_got = _norms(want["grads"]), _norms(got["grads"])
    d_ref, d_got = _norms(want["delta"]), _norms(got["delta"])
    keep = g_ref >= 1e-3 * g_ref.median()
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
           "leaves_left_out": float((~keep).sum())}
    for key, r, p in (("grad_gap", g_ref, g_got), ("update_gap", d_ref, d_got)):
        denom = torch.maximum(r, r[keep].median())
        out[key] = float(((p - r).abs() / denom)[keep].max())
    return out


def check(ctx, state: State, prog: dict) -> dict[str, float]:
    if ctx.device != "cpu":
        tf32_off()
    return readings(prog, reference_steps(ctx, state.pool))


def control(ctx, state: State) -> dict[str, float]:
    """The control: the reference with TF32 on, put in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    low = reference_steps(ctx, state.pool)
    tf32_off()
    return readings(low, reference_steps(ctx, state.pool))


def half_batch_fault(ctx, state: State) -> dict[str, float]:
    """A planted fault, in the reference put in the program's place: each
    step's loss over the first half of its batch alone."""
    tf32_off()
    half = reference_steps(ctx, state.pool, rows=len(state.pool[0]["seg"]) // 2)
    return readings(half, reference_steps(ctx, state.pool))
