"""The 3-D training cell (``unet3d-train-b2``) at a tiny size on the CPU:
the plain 3-D reference against the port's U-Net, loss and gradients from
the same weights; a tiny run of its driver, sound and with each fault the
cell can have, judged under the cell's own limits; its FLOP count by hand.

The tiny size keeps the plan's shape: base 4, kernels (3, 3, 3) at every
level, pools (2, 2, 2) then (1, 2, 2) (z pooled less than y and x),
patches of 8 x 32 x 32, batch 2, so that K6's route (an input at least 32
wide) is taken at level 0, by three z taps in each of its four blocks. The
overrides live here.
"""

import importlib

import numpy as np
import pytest
import torch

from portbench import harness, run
from portbench.drivers import train_steps_3d
from portbench.reference import unet3d as ref
from portbench.tests import tiny
from portbench.yardstick import flops3d

CELL = "unet3d-train-b2"
POOLS = [[2, 2, 2], [1, 2, 2]]
KERNELS = [[3, 3, 3], [3, 3, 3], [3, 3, 3]]
PATCH = [8, 32, 32]
TINY = ({"model": {"base_num_features": 4, "pool_op_kernel_sizes": POOLS,
                   "conv_kernel_sizes": KERNELS, "patch_size": PATCH, "batch_size": 2}},
        {"pool": 4})
#: heads: both sides float32, the port's convs (its K6 tap sum or F.conv3d)
#: summed in another order than the reference's F.conv3d: a few float32
#: ulps of the largest logit. A bfloat16 forward misses by more than 1e-3.
HEAD_TOL = 1e-5
#: the loss, relative: float32 sums of the same terms in another order
LOSS_TOL = 1e-5
#: each gradient leaf within GRAD_TOL of its largest entry (plus 1e-7 for
#: the leaves that are zero but for round-off: conv biases under
#: InstanceNorm): the float32 round-off of two backward passes
GRAD_TOL = 1e-4


def context(seed: int = 7, seconds: float = 0.5):
    """(the tiny run's context on the CPU, the cell's driver module)."""
    config, traffic = tiny.load(CELL)
    config, traffic = tiny._merge(config, TINY[0]), tiny._merge(traffic, TINY[1])
    harness.set_env(config["env"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return harness.Context(CELL, config, traffic, seed, seconds, False, device="cpu"), driver


def measure(seed: int = 7, seconds: float = 0.5) -> dict:
    ctx, driver = context(seed, seconds)
    out = run.measure(ctx, driver)
    correct, checks = harness.judge(out["readings"], harness.read_limits(CELL))
    return {**out, "correct": correct and out["result"]["failed"] == 0, "checks": checks}


def _port(conv_impl: str, remat: bool, dtype=torch.float32):
    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.models.unet import unet_from_plans

    plans = task002_heart_3d(1)
    stage = plans.plans_per_stage[0]
    plans.base_num_features = 4
    stage.pool_op_kernel_sizes, stage.conv_kernel_sizes = POOLS, KERNELS
    stage.patch_size = tuple(PATCH)
    return unet_from_plans(plans, conv_impl=conv_impl, fused_norm_act=False, remat=remat,
                           dtype=dtype)


def _batch():
    ctx, _ = context()
    b = train_steps_3d.phantom_volumes({**ctx.traffic, "batch": 2, "patch": PATCH}, 11, "cpu")[0]
    return (torch.from_numpy(b["data"]).movedim(-1, 1).contiguous(),
            torch.from_numpy(b["seg"]))


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "save_conv"])
@pytest.mark.parametrize("conv_impl", ["native", "pallas"])
def test_reference_matches_the_ports_heads_loss_and_every_gradient(conv_impl, remat,
                                                                   monkeypatch):
    from csof_tpu_torch.config.experiment import ExperimentConfig
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.trainer import make_seg_loss

    ctx, _ = context()
    reference = train_steps_3d.reference_model(ctx)
    weights = harness.draw_weights(harness.weight_spec(reference), 3, "cpu")
    reference.load_state_dict(weights, strict=True)
    port = _port(conv_impl, remat)
    port.load_state_dict(weights, strict=True)
    assert [n for n, _ in port.named_parameters()] == [n for n, _ in reference.named_parameters()]
    data, seg = _batch()
    assert 0 < int(seg.sum()) < seg.numel()

    taps = []
    real = k6.conv3x3_plain

    def counted(*args):
        taps.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(k6, "conv3x3_plain", counted)
    with torch.no_grad():
        got, want = port(data), reference(data)
    # pallas: one K6 (here its plain version) a z tap of level 0's four blocks
    assert len(taps) == (12 if conv_impl == "pallas" else 0)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= HEAD_TOL * b.abs().max()

    loss_fn = make_seg_loss(ExperimentConfig(model="unet3d"))
    loss, _ = loss_fn(port, {"data": data, "seg": seg})
    loss.backward()
    want_loss = ref.loss(reference, data, seg)
    want_loss.backward()
    assert abs(loss.item() - want_loss.item()) <= LOSS_TOL * abs(want_loss.item())
    grads = dict(reference.named_parameters())
    for name, p in port.named_parameters():
        r = grads[name].grad
        if r is None:  # the zero-weight coarsest head: no gradient on either side
            assert p.grad is None, name
            continue
        err = (p.grad - r).abs().max()
        assert err <= GRAD_TOL * r.abs().max() + 1e-7, f"{name}: {float(err):.3e}"


def test_a_bfloat16_forward_fails_the_head_tolerance():
    ctx, _ = context()
    reference = train_steps_3d.reference_model(ctx)
    weights = harness.draw_weights(harness.weight_spec(reference), 3, "cpu")
    reference.load_state_dict(weights, strict=True)
    port = _port("pallas", True, dtype=torch.bfloat16)
    port.load_state_dict(weights, strict=True)
    data, _ = _batch()
    with torch.no_grad():
        got, want = port(data), reference(data)
    assert (got[0] - want[0]).abs().max() > 100 * HEAD_TOL * want[0].abs().max()


def test_sound_run_is_correct():
    out = measure(seed=2**31 + 19)
    assert out["correct"], out["checks"]
    assert out["result"]["steps"] > 0


def _optimizer_does_nothing(monkeypatch):
    from csof_tpu_torch.training.schedules import Optimizer

    def step(self):
        for p in self.params:  # the state the optimizer keeps, left as it is
            self.inner.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.count += 1

    monkeypatch.setattr(Optimizer, "step", step)


def _half_of_the_batch(monkeypatch):
    from csof_tpu_torch.training.trainer import Trainer

    inner = Trainer._to_device

    def half(self, batch):
        out = inner(self, batch)
        return {k: v[: len(v) // 2] for k, v in out.items()}

    monkeypatch.setattr(Trainer, "_to_device", half)


@pytest.mark.parametrize("fault", [_optimizer_does_nothing, _half_of_the_batch],
                         ids=["state_unchanged", "half_batch"])
def test_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = measure()
    assert not out["correct"], out["checks"]


def test_planted_half_batch_reads_over_the_limits():
    ctx, driver = context(seed=5)
    state = driver.setup(ctx)
    readings = driver.half_batch_fault(ctx, state)
    assert not harness.judge(readings, harness.read_limits(CELL))[0]


def test_phantoms_repeat_with_the_seed_and_rows_differ():
    mix = {"batch": 2, "patch": [6, 20, 16], "pool": 3}
    a = train_steps_3d.phantom_volumes(mix, 2**33 + 5, "cpu")
    b = train_steps_3d.phantom_volumes(mix, 2**33 + 5, "cpu")
    c = train_steps_3d.phantom_volumes(mix, 6, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x["data"], y["data"]) and np.array_equal(x["seg"], y["seg"])
    assert not np.array_equal(a[0]["data"], c[0]["data"])
    rows = np.concatenate([x["data"] for x in a]).reshape(6, -1)
    assert len({r.tobytes() for r in rows}) == 6
    assert a[0]["data"].shape == (2, 6, 20, 16, 1) and a[0]["seg"].dtype == np.int32
    assert set(np.unique(np.concatenate([x["seg"] for x in a]))) == {0, 1}
    z = a[0]["data"][0]
    assert abs(float(z.mean())) < 1e-5 and abs(float(z.std()) - 1.0) < 1e-3


def test_unet3d_step_flops_by_hand():
    # a 1-pool 3-D U-Net (base 2: 2 and 4 features), pool (1, 2, 2), kernels
    # (1, 3, 3) then (3, 3, 3), 2 classes, batch 1 at 2 x 4 x 4: two convs
    # at each level, a (1, 2, 2) transposed conv, two (3, 3, 3) decoder
    # convs and a 1x1x1 head; the backward adds a weight gradient of every
    # conv and a data gradient of all but the first
    px0, px1 = 2 * 4 * 4, 2 * 2 * 2
    enc = 2 * 9 * 1 * 2 * px0 + 2 * 9 * 2 * 2 * px0
    mid = 2 * 27 * 2 * 4 * px1 + 2 * 27 * 4 * 4 * px1
    dec = 2 * 4 * 4 * 2 * px1 + 2 * 27 * 4 * 2 * px0 + 2 * 27 * 2 * 2 * px0 + 2 * 2 * 2 * px0
    first = 2 * 9 * 1 * 2 * px0
    got = flops3d.unet3d_step_flops(2, 320, ((1, 2, 2),), ((1, 3, 3), (3, 3, 3)), 2, 1, (2, 4, 4))
    assert got == 3 * (enc + mid + dec) - first


def test_the_plans_step_counts_about_6_7_tflop():
    config, _ = tiny.load(CELL)
    m = config["model"]
    got = flops3d.unet3d_step_flops(
        m["base_num_features"], m["max_features"],
        tuple(tuple(p) for p in m["pool_op_kernel_sizes"]),
        tuple(tuple(k) for k in m["conv_kernel_sizes"]), config["num_classes"],
        m["batch_size"], tuple(m["patch_size"]))
    assert 6.6e12 < got < 6.8e12
    net = ref.UNet3d(m["base_num_features"], m["max_features"], m["pool_op_kernel_sizes"],
                     m["conv_kernel_sizes"], config["num_classes"], device="meta")
    assert sum(p.numel() for p in net.parameters()) == 30_785_984


def test_the_configuration_is_the_v1_planners_plan_of_task002():
    """The pools and kernels are what nnU-Net v1's planner gives Task02's
    median spacing (1.37 x 1.25 x 1.25 mm) at the 80 x 192 x 160 patch."""
    from csof_tpu_torch.data.planning import get_pool_and_conv_props

    config, _ = tiny.load(CELL)
    m = config["model"]
    per_axis, pools, kernels, padded, _ = get_pool_and_conv_props((1.37, 1.25, 1.25),
                                                                   m["patch_size"])
    assert per_axis == [4, 5, 5] and padded == m["patch_size"]
    assert (pools, kernels) == (m["pool_op_kernel_sizes"], m["conv_kernel_sizes"])
