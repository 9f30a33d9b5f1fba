"""The port's profiling utilities (``csof_tpu_torch/utils/profiling.py``) on
the CPU: the step timer, the throughput protocol's keys, the FLOP count of
a convolution, a trace file written by the TensorBoard handler, and the
program's spans: off without a profiler, the train step's phases in order
under one, and ``span_times`` on a hand-built event list."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_threads
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from csof_tpu_torch.utils import profiling

torch_threads.pin()


def test_step_timer_keeps_a_rolling_window():
    timer = profiling.StepTimer(window=3)
    assert timer.mean != timer.mean  # nan before any step
    timer.stop()  # a stop without a start records nothing
    for _ in range(5):
        timer.start()
        time.sleep(0.001)
        timer.stop()
    assert len(timer.times) == 3 and timer.mean >= 0.001


def _conv_case():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 12, 10, generator=gen)
    w = torch.randn(5, 3, 3, 3, generator=gen)
    return x, w


def test_estimate_flops_of_a_conv_and_none_where_uncountable():
    x, w = _conv_case()
    n, ci, h, wd = x.shape
    co = w.shape[0]
    assert profiling.estimate_flops(lambda a: F.conv2d(a, w, padding=1), x) == (
        2 * n * co * ci * 9 * h * wd)

    def broken(a):
        raise RuntimeError("no")

    assert profiling.estimate_flops(broken, x) is None


def test_get_throughput_on_the_cpu_returns_the_jax_keys():
    x, w = _conv_case()
    res = profiling.get_throughput(lambda a: {"y": F.conv2d(a, w, padding=1)}, (x,),
                                   frames_per_call=2, warmup=1, reps=3)
    assert set(res) == {"fps", "sec_per_call", "gflops_per_call", "device"}
    assert res["fps"] > 0 and res["sec_per_call"] > 0 and res["device"] == "cpu"
    assert res["gflops_per_call"] == pytest.approx(2 * 2 * 5 * 3 * 9 * 12 * 10 / 1e9)
    profiling.fetch_sync({"a": [None, x]})


def test_trace_writes_a_trace_file(tmp_path):
    x, w = _conv_case()
    with profiling.trace(tmp_path):
        F.conv2d(x, w, padding=1).sum().item()
    files = list(tmp_path.glob("*.pt.trace.json*"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_span_is_one_shared_no_op_and_enters_no_record_function_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    first = profiling.span("train.step")
    assert profiling.span("train.forward") is first is profiling.no_span("train.step")
    with first:
        with profiling.span("train.loss"):  # nests: the no-op holds no state
            pass


def test_span_is_a_record_function_on_the_profilers_clock_while_it_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
            with profiling.no_span("skipped"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("csof:outer") == names.count("csof:inner") == 1
    assert "csof:skipped" not in names
    times = profiling.span_times(prof)
    assert set(times) == {"outer", "inner"}
    assert times["outer"]["calls"] == times["inner"]["calls"] == 1
    assert times["outer"]["host_ms"] >= times["inner"]["host_ms"] > 0
    assert times["outer"]["device_ms"] == times["inner"]["device_ms"] == 0.0


STEP_SPANS = ["input", "forward", "loss", "backward", "optimizer", "loss_read"]


def _tiny_unet_trainer(tmp_path):
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.training.trainer import Trainer

    plans = task002_heart_2d()
    stage = plans.plans_per_stage[0]
    stage.batch_size, stage.patch_size = 2, (16, 16)
    stage.pool_op_kernel_sizes, stage.conv_kernel_sizes = [[2, 2]] * 2, [[3, 3]] * 3
    plans.base_num_features = 4
    config = ExperimentConfig(model="unet2d", optim=OptimConfig(optimizer="sgd",
                                                                 scheduler="poly"),
                              data=DataConfig(do_data_aug=False))
    trainer = Trainer(config, tmp_path, plans=plans, device="cpu").initialize()
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(2, 16, 16, 1).astype(np.float32),
             "seg": rng.randint(0, 2, (2, 16, 16)).astype(np.int32)}
    return trainer, batch


def _spans(prof) -> list:
    """(name, start, end) of the csof: spans of a profile, by start."""
    return sorted(((e.name[len(profiling.SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda s: s[1])


def _step_children(spans: list) -> list:
    """The names of the spans inside the one train.step span, by start."""
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == 1
    _, lo, hi = steps[0]
    inside = [s for s in spans if s[0] != "train.step"]
    assert all(lo <= s and e <= hi for _, s, e in inside)
    for (_, _, e0), (_, s1, _) in zip(inside, inside[1:]):
        assert e0 <= s1  # one after another, none nested
    return [name for name, _, _ in inside]


def test_a_unet_train_step_opens_its_phases_in_order_inside_train_step(tmp_path):
    trainer, batch = _tiny_unet_trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = trainer.run_iteration(batch)
    assert np.isfinite(loss)
    assert _step_children(_spans(prof)) == [f"train.{n}" for n in STEP_SPANS]
    times = profiling.span_times(prof)
    assert set(times) == {"train.step", *(f"train.{n}" for n in STEP_SPANS)}
    assert all(t["calls"] == 1 and t["host_ms"] > 0 for t in times.values())
    assert len(trainer.history.step_times) == 1


def test_an_evaluation_opens_no_span(tmp_path):
    trainer, batch = _tiny_unet_trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, aux = trainer.run_iteration(batch, train=False)
    assert np.isfinite(loss) and set(aux) == {"tp", "fp", "fn"}
    assert _spans(prof) == [] and profiling.span_times(prof) == {}
    assert trainer.history.step_times == []


def test_another_kinds_whole_loss_is_its_forward_span(tmp_path):
    from csof_tpu_torch.config.experiment import ExperimentConfig, VoxelMorphModelConfig
    from csof_tpu_torch.training.trainer import Trainer

    config = ExperimentConfig(model="voxelmorph", voxelmorph=VoxelMorphModelConfig(
        enc_features=(4, 8, 8), dec_features=(8, 8, 8, 4), int_steps=2, dtype="float32"))
    trainer = Trainer(config, tmp_path, device="cpu").initialize()
    rng = np.random.RandomState(1)
    batch = {"moving": rng.rand(2, 16, 16, 1).astype(np.float32),
             "fixed": rng.rand(2, 16, 16, 1).astype(np.float32)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_iteration(batch)
    assert _step_children(_spans(prof)) == [f"train.{n}" for n in STEP_SPANS if n != "loss"]


class _Event:
    """A stand-in of the profiler's Kineto event: times in ns."""

    def __init__(self, name, device, corr, start, end, annotation=False):
        self._v = (name, device, corr, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]

    def end_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_span_times_attributes_each_launch_to_the_innermost_span_open_at_it():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("csof:train.step", cpu, 1, 0, 10_000_000),
        _Event("csof:train.forward", cpu, 2, 1_000_000, 4_000_000),
        _Event("csof:train.backward", cpu, 3, 5_000_000, 9_000_000),
        # launches: in forward, in step between phases, on another thread in
        # backward, and one before any span
        _Event("cudaLaunchKernel", cpu, 101, 2_000_000, 2_010_000),
        _Event("cudaMemcpyAsync", cpu, 102, 4_500_000, 4_510_000),
        _Event("cudaLaunchKernel", cpu, 103, 6_000_000, 6_010_000),
        _Event("cuLaunchKernel", cpu, 104, -1_000_000, -990_000),
        # an ATen op whose own id equals a launch's: never a launch
        _Event("aten::mul", cpu, 105, 7_000_000, 7_100_000),
        _Event("conv_kernel", cuda, 101, 2_100_000, 3_600_000),
        _Event("Memcpy HtoD", cuda, 102, 4_600_000, 4_850_000),
        _Event("wgrad_kernel", cuda, 103, 6_100_000, 8_100_000),
        _Event("early_kernel", cuda, 104, 100_000, 200_000),
        _Event("no_launch_kernel", cuda, 105, 8_200_000, 8_300_000),
        _Event("csof:train.forward", cuda, 2, 2_100_000, 3_600_000, annotation=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    times = profiling.span_times(prof)
    assert times == {
        "train.step": {"calls": 1, "host_ms": 10.0, "device_ms": 0.25},
        "train.forward": {"calls": 1, "host_ms": 3.0, "device_ms": 1.5},
        "train.backward": {"calls": 1, "host_ms": 4.0, "device_ms": 2.0},
    }
