"""Reading the program's own spans in the traced run's profiled slice.

The program opens ``csof:<name>`` spans (``torch.profiler.record_function``)
while a profiler records, so the slice that ``trace.profiled`` keeps holds
them among its host operations, beside the CUDA runtime calls and the
device events. ``of`` builds a ``SpanSlice`` from that slice once a run.

Each device event (kernel, copy, fill) is attributed to the innermost span
whose host interval holds its launch, on any thread: the backward's
kernels are launched on autograd's thread while the step's thread waits
inside ``train.backward``. The slice keeps no correlation ids, so a launch
is found by order: the step runs on one stream, whose device events run in
the order the host enqueued them. The enqueuing calls (kernel launches,
copies, fills) sorted by host start, less the two spin kernels' launches
that open and close the slice, are paired with the device events sorted by
device start. The pairing stands only where the counts match, each pair is
of one kind, and no event starts before its launch; otherwise no event is
attributed and the device ms are not read. Each idle gap of the device is
named by the innermost span that holds its midpoint on the host. Nothing
here reads the program's own measurement code.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from functools import cached_property

from portbench.yardstick.trace import _LAUNCHES, busy_us, gaps

PREFIX = "csof:"
#: the span of one step; the slice's steps are counted by it
STEP = "train.step"
#: the spans of the step's compute; an idle gap outside them is at its boundary
PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")
#: the runtime or driver calls that enqueue work, by name prefix, and the
#: prefixes of the device events each kind leaves
_CALLS = {"kernel": _LAUNCHES, "copy": ("cudaMemcpy", "cuMemcpy"),
          "fill": ("cudaMemset", "cuMemset")}


def call_kind(name: str) -> str | None:
    return next((k for k, pre in _CALLS.items() if name.startswith(pre)), None)


def event_kind(name: str) -> str:
    return "copy" if name.startswith("Memcpy") else "fill" if name.startswith("Memset") else "kernel"


def pair(events: list, calls: list) -> tuple[list, str]:
    """(the host start of each device event's launch, or all None; why not)
    for ``events`` (name, start, end) and enqueuing ``calls`` (name, start),
    both of the slice, the calls with the spins' launches first and last."""
    none = [None] * len(events)
    calls = sorted(calls, key=lambda c: c[1])
    if len(calls) != len(events) + 2 or any(call_kind(calls[i][0]) != "kernel" for i in (0, -1)):
        return none, f"{len(calls)} enqueuing calls for {len(events)} device events and 2 spins"
    order = sorted(range(len(events)), key=lambda i: (events[i][1], events[i][2]))
    at = list(none)
    for i, (name, t) in zip(order, calls[1:-1]):
        ev = events[i]
        if call_kind(name) != event_kind(ev[0]) or t > ev[1]:
            return none, f"{name} at {t:.3f} us does not launch {ev[0][:60]} at {ev[1]:.3f} us"
        at[i] = t
    return at, ""


@dataclass
class SpanSlice:
    """Device events (name, start us, end us, launch us or None) inside the
    window, the spans (name without the prefix, start us, end us) sorted by
    start, the window, the steps the slice ran (its ``train.step`` spans),
    and why the launches were not paired ("" where they were)."""

    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window_us: tuple = (0.0, 0.0)
    steps: int = 0
    unpaired: str = ""

    def innermost(self, t: float | None, among=None) -> str | None:
        """The innermost span (of ``among``, or any) whose interval holds
        host time ``t``; spans nest, so it is the last by start that does."""
        found = None
        if t is None:
            return found
        for name, s, e in self.spans:
            if s > t:
                break
            if e >= t and (among is None or name in among):
                found = name
        return found

    @cached_property
    def owners(self) -> list:
        """The span each device event is attributed to, or None."""
        return [self.innermost(at) for _, _, _, at in self.device]

    def _per_step(self, pairs) -> dict[str, float]:
        out = {name: 0.0 for name, _, _ in self.spans}
        for name, us in pairs:
            if name is not None:
                out[name] += us / 1e3 / self.steps
        return out

    def host_ms(self) -> dict[str, float]:
        """Host ms a step inside each span."""
        return self._per_step((name, e - s) for name, s, e in self.spans)

    def device_ms(self) -> dict[str, float] | None:
        """Device ms a step of the events launched in each span (as its
        innermost span); None where the launches were not paired."""
        if self.unpaired:
            return None
        return self._per_step((o, e - s) for o, (_, s, e, _) in zip(self.owners, self.device))

    def idle(self) -> list[tuple[float, float]]:
        return gaps([(s, e) for _, s, e, _ in self.device], *self.window_us)

    def idle_ms(self) -> dict[str | None, float]:
        """Device-idle ms a step by the innermost span holding each gap's
        midpoint; None for the gaps outside every span."""
        out: dict[str | None, float] = {}
        for s, e in self.idle():
            name = self.innermost((s + e) / 2)
            out[name] = out.get(name, 0.0) + (e - s) / 1e3 / self.steps
        return out

    def boundary_idle_ms(self) -> float | None:
        """Device-idle ms a step whose gaps' midpoints lie outside the step's
        compute phases (``PHASES``); None where the slice has none of them."""
        if not any(name in PHASES for name, _, _ in self.spans):
            return None
        return sum(e - s for s, e in self.idle()
                   if self.innermost((s + e) / 2, PHASES) is None) / 1e3 / self.steps

    def busy_ms(self) -> float:
        """Busy ms a step: the union of the device events' intervals."""
        return busy_us((s, e) for _, s, e, _ in self.device) / 1e3 / self.steps

    def attributed(self) -> tuple[int, int]:
        """(device events attributed to a span, device events)."""
        return sum(o is not None for o in self.owners), len(self.device)

    def summary(self) -> str:
        got, total = self.attributed()
        head = f"{got} of {total} device events attributed to a span"
        if self.unpaired:
            head += f" (launches not paired: {self.unpaired})"
        host, dev, idle = self.host_ms(), self.device_ms() or {}, self.idle_ms()
        phases = sum(dev.get(p, 0.0) for p in PHASES)
        rows = "; ".join(f"{n} {host[n]:.3f} / {dev.get(n, float('nan')):.3f} / "
                         f"{idle.get(n, 0.0):.3f}" for n in host)
        return (f"{head}; per step, host / device / idle ms: {rows}; outside any span idle "
                f"{idle.get(None, 0.0):.3f}; boundary idle {self.boundary_idle_ms()}; "
                f"phases' device {phases:.3f} against busy {self.busy_ms():.3f} less input "
                f"{dev.get('train.input', 0.0):.3f}")


def build(events: list, host_ops: list, window_us: tuple) -> SpanSlice | None:
    """The spans of a slice: its device events (name, start us, end us, the
    spin kernels left out), its host operations (name, start us, end us,
    ...) and its window. None where it holds no ``csof:train.step`` span,
    as from a program that opens none."""
    spans = sorted(((op[0][len(PREFIX):], op[1], op[2]) for op in host_ops
                    if op[0].startswith(PREFIX)), key=lambda x: x[1])
    steps = sum(name == STEP for name, _, _ in spans)
    if not steps:
        return None
    calls = [(op[0], op[1]) for op in host_ops if call_kind(op[0])]
    at, why = pair(events, calls)
    device = [(n, s, e, t) for (n, s, e), t in zip(events, at)]
    return SpanSlice(device, spans, tuple(window_us), steps, why)


def of(record: dict) -> SpanSlice | None:
    """The spans of the traced run's profiled slice (``record["slice"]``),
    built at the first call and kept in the record, with one line on
    standard error; None where the run left no slice or no step span."""
    if "spans" not in record:
        sl = record.get("slice")
        sp = None if sl is None else build(sl.events, sl.host_ops, sl.window_us)
        record["spans"] = sp
        print(f"span slice: {sp.summary() if sp else 'no csof:train.step span'}", file=sys.stderr)
    return record["spans"]
