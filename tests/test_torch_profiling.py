"""The port's profiling utilities (``csof_tpu_torch/utils/profiling.py``) on
the CPU: the step timer, the throughput protocol's keys, the FLOP count of
a convolution, and a trace file written by the TensorBoard handler."""

from __future__ import annotations

import time

import pytest
import torch
import torch.nn.functional as F

from csof_tpu_torch.utils import profiling


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
