"""A tiny run of each cell on the CPU, driven as a benchmark run is (set-up,
window, freeing, check) but past the look for a card: sound, it comes out
correct; with the timed path broken underneath, once for each fault the
cell can have, it comes out not correct. The control (the reference in the
precision below the configuration's, in the program's place) fails the
cell's limits too: on the CPU for the bf16 serving cell, on a card for the
float32 training cell, whose control is TF32."""

import pytest
import torch

from portbench.tests import tiny


def test_sound_serving_run_is_correct():
    assert tiny.measure("segflow-review")["correct"]


def test_sound_training_run_is_correct():
    assert tiny.measure("unet2d-train-b40")["correct"]


def _answer_altered(monkeypatch):
    from csof_tpu_torch.inference.flow_predictor import FlowPredictor

    inner = FlowPredictor.predict_video

    def altered(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        out["flow"] = out["flow"] + 0.5
        return out

    monkeypatch.setattr(FlowPredictor, "predict_video", altered)


def _half_of_the_slices(monkeypatch):
    from csof_tpu_torch.models.segflow import SegFlow

    inner = SegFlow.forward

    def half(self, video, *args, **kwargs):
        n = video.shape[0]
        m = max(n // 2, 1)
        out = inner(self, video[:m], *args, **kwargs)  # the other slices copy these
        return {k: v.repeat(-(-n // m), *(1,) * (v.dim() - 1))[:n] for k, v in out.items()}

    monkeypatch.setattr(SegFlow, "forward", half)


def _step_state_unchanged(monkeypatch):
    from csof_tpu_torch.models.segflow import SegFlowStep

    inner = SegFlowStep.forward

    def frozen(self, carry, *args, **kwargs):
        _, out = inner(self, carry, *args, **kwargs)
        return carry, out

    monkeypatch.setattr(SegFlowStep, "forward", frozen)


@pytest.mark.parametrize("fault", [_answer_altered, _half_of_the_slices, _step_state_unchanged],
                         ids=["answer_altered", "half_batch", "state_unchanged"])
def test_serving_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.measure("segflow-review")["correct"]


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
def test_training_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.measure("unet2d-train-b40")["correct"]


def test_serving_control_fails_the_limits():
    from portbench import harness

    ctx, driver = tiny.context("segflow-review", seed=3)
    harness.set_flags(ctx.config["torch_flags"], cuda=False)
    state = driver.setup(ctx)
    readings = driver.control(ctx, state, list(range(len(state.pool))))
    assert not harness.judge(readings, harness.read_limits("segflow-review"))[0]


@pytest.mark.cuda
def test_training_control_fails_the_limits_on_a_card():
    from portbench import harness

    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a card: on the CPU float32 has no TF32")
    ctx, driver = tiny.context("unet2d-train-b40", seed=3)
    ctx.device = "cuda"
    harness.set_flags(ctx.config["torch_flags"])
    state = driver.setup(ctx)
    readings = driver.control(ctx, state)
    assert not harness.judge(readings, harness.read_limits("unet2d-train-b40"))[0]
