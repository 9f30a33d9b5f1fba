"""Back-to-back training steps of the port's nnU-Net trainer on 3-D patches.

The 3-D counterpart of ``train_steps``, whose window, freeing and readings
it runs as they are. Set-up builds one ``Trainer`` of ``model="unet3d"`` on
the 3d_fullres plans (``task002_heart_3d`` with the configuration's pools
and kernels set on it, those of nnU-Net v1's planner; the plans' U-Net
with the remat that
``unet_from_plans`` turns on for a 3-D plan, SGD-Nesterov under the poly
schedule, clip 12), loads the weights drawn from the seed, and drives it
through its first steps with ``Trainer.run_iteration`` on the first batches
of a seeded pool of host batches of 3-D phantoms (``phantom_volumes``);
those steps are the warm-up and the ones the check follows. The window then
runs the same call on the pool, cycled, each step ending in its loss read.
Once the window has closed and the program's state is freed, the plain 3-D
reference (``reference/unet3d.py``) repeats the first steps from the same
weights on the same batches, compared leaf by leaf as the 2-D cell compares
them.
"""

from __future__ import annotations

import sys
import tempfile

import torch

from portbench import generator, harness
from portbench.drivers.train_steps import State, _mix, free, readings, window  # noqa: F401
from portbench.reference import unet3d as ref
from portbench.reference.common import tf32_off
from portbench.yardstick import bounds, flops3d


def phantom_volumes(mix: dict, seed: int, device) -> list[dict]:
    """``pool`` host batches {"data": (N, D, H, W, 1) float32, "seg": (N, D,
    H, W) int32}: one ellipsoid foreground a patch (the left atrium of
    Task02) at a seeded centre, radii and contrast, under seeded noise,
    z-scored a patch, labels 0/1, every row different; drawn on the device
    a batch at a time and kept on the host."""
    gen = torch.Generator(device=device).manual_seed(generator.child_seed(seed, "volumes"))
    n, (d, h, w) = mix["batch"], mix["patch"]
    zz = torch.arange(d, device=device, dtype=torch.float32).view(1, d, 1, 1)
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, w)
    out = []
    for _ in range(mix["pool"]):
        u = torch.rand((8, n, 1, 1, 1), generator=gen, device=device)
        cz, cy, cx = d * (0.3 + 0.4 * u[0]), h * (0.3 + 0.4 * u[1]), w * (0.3 + 0.4 * u[2])
        rz, ry, rx = d * (0.08 + 0.12 * u[3]), h * (0.06 + 0.12 * u[4]), w * (0.06 + 0.12 * u[5])
        seg = (((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        img = seg * (0.6 + 0.8 * u[6]) + (0.2 + 0.3 * u[7]) * torch.randn(
            (n, d, h, w), generator=gen, device=device)
        img = (img - img.mean((1, 2, 3), keepdim=True)) / img.std((1, 2, 3), keepdim=True)
        out.append({"data": img[..., None].float().cpu().numpy(),
                    "seg": seg.to(torch.int32).cpu().numpy()})
    return out


def reference_model(ctx, device=None) -> ref.UNet3d:
    m = ctx.config["model"]
    return ref.UNet3d(m["base_num_features"], m["max_features"], m["pool_op_kernel_sizes"],
                      m["conv_kernel_sizes"], ctx.config["num_classes"],
                      device=device or ctx.device)


def setup(ctx) -> State:
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.training.trainer import Trainer

    cfg, mix, m = ctx.config, _mix(ctx), ctx.config["model"]
    plans = task002_heart_3d(cfg["num_classes"] - 1)
    stage = plans.plans_per_stage[0]
    stage.batch_size, stage.patch_size = mix["batch"], tuple(mix["patch"])
    plans.base_num_features = m["base_num_features"]
    stage.pool_op_kernel_sizes = m["pool_op_kernel_sizes"]
    stage.conv_kernel_sizes = m["conv_kernel_sizes"]
    config = ExperimentConfig(
        model="unet3d", deep_supervision=True, seed=generator.child_seed(ctx.seed, "config"),
        max_num_epochs=cfg["max_num_epochs"], num_batches_per_epoch=cfg["num_batches_per_epoch"],
        optim=OptimConfig(**cfg["optim"]), data=DataConfig(do_data_aug=mix["augmentation"]))
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(config, tmp.name, plans=plans, device=ctx.device).initialize()
    net = trainer.model
    print(f"model: unet3d, remat {net.remat} ({net.remat_policy}), conv "
          f"{net.StackedConvs_0.ConvNormAct_0.conv_impl}", file=sys.stderr)
    spec = harness.weight_spec(reference_model(ctx, device="meta"))
    net.load_state_dict(harness.draw_weights(spec, ctx.seed, ctx.device), strict=True)
    state = State(trainer, phantom_volumes(mix, ctx.seed, ctx.device), tmp)
    params = trainer.optimizer.params
    state.names = [n for n, p in net.named_parameters() if p.requires_grad]
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


def traced(state: State, ctx, window_result: dict) -> None:
    """Model FLOPs of the window's steps; one profiled slice of steps with
    the kernels' shapes recorded; the optimizer's device time by CUDA events
    (``optimizer_ms.train``)."""
    from portbench import shims
    from portbench.yardstick import trace

    mix, m = _mix(ctx), ctx.config["model"]
    per_step = flops3d.unet3d_step_flops(
        m["base_num_features"], m["max_features"],
        tuple(tuple(p) for p in m["pool_op_kernel_sizes"]),
        tuple(tuple(k) for k in m["conv_kernel_sizes"]), ctx.config["num_classes"],
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
    step's loss over the first half of its batch alone (one patch of two)."""
    tf32_off()
    half = reference_steps(ctx, state.pool, rows=len(state.pool[0]["seg"]) // 2)
    return readings(half, reference_steps(ctx, state.pool))
