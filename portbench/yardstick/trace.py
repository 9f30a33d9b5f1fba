"""Reading the device trace of a profiled slice.

``profiled`` runs a callable under ``torch.profiler`` with a short spin
kernel (``torch.cuda._sleep``, ATen's ``spin_kernel``) before and after it,
so that the slice's own kernels are never a trace's first or last: on some
machines a trace loses its last kernel. The slice's window is the time from
the end of the opening spin to the start of the closing one. Busy time is
the length of the union of the device events' intervals inside it (kernels,
copies and fills, each counted once); the idle gaps are its complement,
each named by the innermost host operation running at its middle (the
benchmark's own annotations included, so that a gap in untraced host work,
Python or numpy, takes the name of the call it fell in).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

SENTINEL = "spin_kernel"
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The (start, end) gaps of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class SliceTrace:
    """What one profiled slice left: device events (name, start us, end us)
    inside its window, the window, the kernels the host launched, and host
    operations (name, start, end, depth) for naming idle gaps."""

    events: list = field(default_factory=list)
    window_us: tuple = (0.0, 0.0)
    launched: int = 0
    host_ops: list = field(default_factory=list)
    bracketed: bool = True

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def kernels(self) -> list:
        return [e for e in self.events if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.events) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        sums: dict[str, float] = {}
        for name, s, e in self.events:
            sums[name] = sums.get(name, 0.0) + (e - s) / 1e6
        return [[n[:160], v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the longest idle gaps."""
        found = sorted(gaps([(s, e) for _, s, e in self.events], *self.window_us),
                       key=lambda g: g[0] - g[1])[:top]
        starts = [op[1] for op in self.host_ops]
        out = []
        for s, e in found:
            mid, name, best = (s + e) / 2, "host, outside any traced call", -1
            for op in self.host_ops[:bisect.bisect_right(starts, mid)]:
                if op[2] > mid and op[3] >= best:
                    name, best = op[0], op[3]
            out.append([name[:160], (e - s) / 1e6])
        return out

    def summary(self) -> str:
        return (f"{len(self.kernels())} kernels for {self.launched} launches, "
                f"bracket {'found' if self.bracketed else 'lost'}, window {self.window_s:.6f} s, "
                f"busy {self.busy_s():.6f} s")


def profiled(fn) -> tuple[object, SliceTrace]:
    """Run ``fn()`` under torch.profiler between two spin kernels; return its
    result and the slice's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        out = fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    evs = prof.events()
    dev, spins, host, launched = [], [], [], 0
    for e in evs:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            (spins if SENTINEL in e.name else dev).append((e.name, float(tr.start),
                                                           float(tr.end)))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(_LAUNCHES):
                launched += 1
            host.append((e.name, float(tr.start), float(tr.end)))
    spins.sort(key=lambda x: x[1])
    if len(spins) >= 2:
        lo, hi = spins[0][2], spins[-1][1]
    else:  # a lost bracket: the slice's own extent
        lo = min((s for _, s, _ in dev), default=0.0)
        hi = max((e for _, _, e in dev), default=0.0)
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    host.sort(key=lambda x: x[1])
    depth_host = _with_depth(host)
    return out, SliceTrace(dev, (lo, hi), max(launched - 2, 0), depth_host, len(spins) >= 2)


def _with_depth(ops: list) -> list:
    """(name, start, end, nesting depth) of host ops sorted by start."""
    out, stack = [], []
    for name, s, e in ops:
        while stack and stack[-1] <= s:
            stack.pop()
        out.append((name, s, e, len(stack)))
        stack.append(e)
    return out
