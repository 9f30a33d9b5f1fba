"""The plain references against the port's models at a tiny size on the CPU,
float32, from the same weights."""

import torch

from portbench import harness
from portbench.drivers import closed_loop_studies, train_steps
from portbench.reference import unet as ref_unet
from portbench.tests import tiny


def test_segflow_reference_matches_the_ports_serving_forward():
    from csof_tpu_torch.config.experiment import SegFlowModelConfig
    from csof_tpu_torch.inference.serving import apply_serving_config
    from csof_tpu_torch.models.segflow import SegFlow

    ctx, _ = tiny.context("segflow-review", seed=5)
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in ctx.config["model"].items()}
    cfg = apply_serving_config(SegFlowModelConfig(**{**fields, "dtype": "float32"}), 4)
    assert cfg.corr_fuse == "fused_cm"
    port = SegFlow(cfg, 4, conv_impl="native", fused_norm_act=False).eval()
    ref = closed_loop_studies.reference_model(ctx)
    weights = harness.draw_weights(harness.weight_spec(ref), 5, "cpu")
    port.load_state_dict(weights, strict=True)
    ref.load_state_dict(weights, strict=True)
    video = torch.rand((2, 4, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        a, b = port(video), ref(video)
    # float32 on both sides; the flow recurs through three warps, so its
    # round-off grows a little each frame
    for key in ("seg_logits", "cum_flow", "registered"):
        scale = b[key].abs().max()
        assert (a[key] - b[key]).abs().max() <= 1e-4 * scale, key


def test_unet_reference_matches_the_ports_unet_and_loss():
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops import losses as L

    ctx, _ = tiny.context("unet2d-train-b40")
    plans = task002_heart_2d(1)
    stage = plans.plans_per_stage[0]
    plans.base_num_features = 4
    stage.pool_op_kernel_sizes = [[2, 2]] * 3
    stage.conv_kernel_sizes = [[3, 3]] * 4
    port = unet_from_plans(plans, conv_impl="native", fused_norm_act=False)
    ref = train_steps.reference_model(ctx)
    weights = harness.draw_weights(harness.weight_spec(ref), 3, "cpu")
    port.load_state_dict(weights, strict=True)
    ref.load_state_dict(weights, strict=True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1, 32, 32), generator=gen)
    seg = (torch.rand((3, 32, 32), generator=gen) > 0.7).long()
    outs = port(x)
    heads = ref(x)
    for a, b in zip(outs, heads):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    targets = L.downsample_seg_for_ds(seg, port.pool_kernel_sizes)
    want = L.deep_supervision_loss([o.movedim(1, -1) for o in outs], targets, L.dice_and_ce_loss)
    got = float(ref_unet.loss(ref, x, seg).detach())
    assert abs(got - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
