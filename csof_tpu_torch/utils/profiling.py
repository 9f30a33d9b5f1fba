"""Profiling and throughput utilities (port of ``csof_tpu/utils/profiling.py``):
a ``torch.profiler`` trace for TensorBoard, the program's named spans in
such a trace and their times, a finished trace's device kernels and busy
time, a FLOP count, a synchronizing fetch, the warm-up + timed-reps
throughput protocol and a rolling step timer. Nothing here is a benchmark:
these are the tools one is built from.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``torch.profiler`` over the body (the CPU, and the card where there is
    one), written into ``log_dir`` by the TensorBoard trace handler; view it
    with ``tensorboard --logdir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))
                 ) as prof:
        yield prof


#: the prefix of the program's spans among a trace's host events
SPAN_PREFIX = "csof:"
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A named span of the program: while a ``torch.profiler`` is recording,
    ``record_function("csof:<name>")``, on the profiler's clock and in the
    same trace as the kernels launched inside it (``trace`` above shows it,
    ``span_times`` reads it); otherwise one shared no-op context, so that a
    span costs one check when nothing is recording: no allocation, no
    ``record_function``, no CUDA event."""
    if _profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def no_span(name: str):
    """The no-op context ``span`` gives when nothing is recording, for a path
    that opens no span whether or not a profiler records (an evaluation)."""
    return _NO_SPAN


def span_times(prof) -> dict[str, dict[str, float]]:
    """{span: {"calls", "host_ms", "device_ms"}} of the ``csof:`` spans in a
    finished ``torch.profiler`` profile, summed over their calls: the host
    time inside each, and the device time of the kernels, copies and fills
    launched while it was the innermost span open. A launch is found by the
    correlation id the profiler records with each device event, and placed by
    its host time on any thread (a backward's kernels are launched on
    autograd's thread while the step's thread waits inside its span)."""
    from torch.autograd import DeviceType

    spans, launched_at, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.end_ns(), name[len(SPAN_PREFIX):]))
            elif name.startswith("cu"):  # a CUDA runtime or driver call
                launched_at[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append((e.correlation_id(), e.duration_ns()))
    spans.sort()
    out = {}
    for s, e, name in spans:
        t = out.setdefault(name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += (e - s) / 1e6
    starts = [s for s, _, _ in spans]
    for corr, ns in device:
        at = launched_at.get(corr)
        if at is None:
            continue
        # spans nest: the innermost holding the launch is the latest-starting one that does
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if spans[i][1] >= at:
                out[spans[i][2]]["device_ms"] += ns / 1e6
                break
    return out


def device_kernels(prof) -> list:
    """The device events (kernels, copies, fills) of a finished
    ``torch.profiler`` profile, each once: the aten ops' rows repeat the time
    of the kernels they launch, and user annotations are ranges, not work."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def busy_ms(events) -> float:
    """The device's busy time over ``events`` (``device_kernels``): the
    length of the union of their intervals, in ms."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def estimate_flops(fn, *args) -> float | None:
    """The floating-point operations of one call of ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` from the shapes of the
    ATen operations it dispatches (convolutions and matrix products; a
    multiply-add counts two). A hand-written kernel called through ctypes
    dispatches no ATen operation, so its work is not in the count (K6 under
    ``CSOF_CONV2D_IMPL=pallas`` counts nothing for its convs). ``None``
    where the call cannot be counted, as the JAX function returns."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # noqa: BLE001 - an uncountable call has no estimate, as in JAX
        return None


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    for item in tree if isinstance(tree, (list, tuple)) else ():
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def fetch_sync(tree) -> None:
    """Wait for the device (``torch.cuda.synchronize`` where the first tensor
    of ``tree`` is on the card), then fetch one element of that tensor to
    the host: the end of a timed region."""
    leaf = _first_tensor(tree)
    if leaf is None:
        return
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.detach().reshape(-1)[:1].cpu()


def _chain(acc, out):
    """The running sum of the outputs' tensors, so that each rep's result is
    consumed."""
    if acc is None:
        return out
    if isinstance(out, torch.Tensor):
        return acc + out
    if isinstance(out, dict):
        return {k: _chain(acc[k], v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_chain(a, b) for a, b in zip(acc, out))
    return acc


def get_throughput(fn, args, frames_per_call: int, warmup: int = 2, reps: int = 20) -> dict:
    """Steady-state frames per second of ``fn(*args)``: ``warmup`` calls,
    then ``reps`` timed calls chained through an accumulator of their
    outputs. On the card the time is CUDA events' (the device's time from
    the first call's launch to the last's end); on the CPU the host clock's.
    Returns the JAX function's keys: ``fps``, ``sec_per_call``,
    ``gflops_per_call`` (``estimate_flops``; ``None`` where uncountable) and
    ``device``."""
    first = _first_tensor(args)
    cuda = first is not None and first.is_cuda
    with torch.no_grad():
        out = None
        for _ in range(warmup):
            out = fn(*args)
        fetch_sync(out if out is not None else args)
        acc = None
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            acc = _chain(acc, fn(*args))
        if cuda:
            end.record()
        fetch_sync(acc)
        dt = start.elapsed_time(end) / 1e3 if cuda else time.perf_counter() - t0
    flops = estimate_flops(fn, *args)
    device = first.device if first is not None else torch.device("cpu")
    return {
        "fps": frames_per_call * reps / dt,
        "sec_per_call": dt / reps,
        "gflops_per_call": flops / 1e9 if flops else None,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
    }


class StepTimer:
    """Rolling wall time of the last ``window`` steps (host clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self.times = self.times[-self.window:]
            self._t0 = None

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")
