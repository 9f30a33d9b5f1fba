"""The span yardstick (``portbench/yardstick/spans.py``) and its readers on a
hand-built slice of two steps, shaped as ``trace.profiled`` keeps it:
launches inside and outside the spans, a backward launch placed by its host
time alone (autograd's thread), copies and fills, launches that cannot be
paired with the device events, and idle gaps with known midpoints."""

import importlib

import pytest

from portbench.yardstick import spans
from portbench.yardstick.trace import SliceTrace, _with_depth

PHASE_SPANS = [("train.step", 10, 99), ("train.input", 10, 20), ("train.forward", 21, 40),
               ("train.loss", 40, 45), ("train.backward", 46, 80),
               ("train.optimizer", 80, 90), ("train.loss_read", 90, 99)]
#: (enqueuing call, host us, device event, device start, end): a kernel
#: outside every span, a copy in the input, a kernel in the forward, one in
#: the loss, one that autograd's thread launches while the step's thread
#: waits in the backward, a fill and a kernel in the optimizer
LAUNCHES = [("cudaLaunchKernel", 8, "elementwise_kernel", 8.5, 9),
            ("cudaMemcpyAsync", 12, "Memcpy HtoD (Pageable -> Device)", 13, 15),
            ("cudaLaunchKernel", 25, "fprop_kernel", 26, 44),
            ("cudaLaunchKernel", 42, "reduce_kernel", 44, 47),
            ("cuLaunchKernel", 50, "wgrad_kernel", 50, 85),
            ("cudaMemsetAsync", 81, "Memset (Device)", 85, 86),
            ("cudaLaunchKernel", 82, "multi_tensor_apply_kernel", 86, 89)]
STEPS = 2
WINDOW = (5.0, 100.0 * STEPS - 5)


def _slice(launches=LAUNCHES, phase_spans=PHASE_SPANS) -> SliceTrace:
    """Two steps between the spins' launches (host 0 and 194, device [0, 5]
    and [195, 200]); device events as ``trace.profiled`` keeps them, the
    spins left out."""
    host = [("cudaLaunchKernel", 0.0, 0.5), ("cudaLaunchKernel", 194.0, 194.5)]
    events = []
    for k in range(STEPS):
        o = 100.0 * k
        host += [("portbench: run_iteration", o + 9.9, o + 99.1), ("aten::add", o + 60, o + 61)]
        host += [("csof:" + name, o + s, o + e) for name, s, e in phase_spans]
        for call, at, kernel, s, e in launches:
            host.append((call, o + at, o + at + 0.4))
            events.append((kernel, o + s, o + e))
    host.sort(key=lambda x: x[1])
    return SliceTrace(events, WINDOW, len(events), _with_depth(host), True)


def _build(sl: SliceTrace):
    return spans.build(sl.events, sl.host_ops, sl.window_us)


def test_each_device_event_goes_to_the_innermost_span_of_its_launch():
    sp = _build(_slice())
    assert sp.steps == STEPS and sp.unpaired == "" and sp.window_us == WINDOW
    assert sp.attributed() == (12, 14)
    assert sp.owners.count("train.backward") == 2 and sp.owners.count(None) == 2
    assert sp.device_ms() == pytest.approx({
        "train.step": 0.0, "train.input": 0.002, "train.forward": 0.018, "train.loss": 0.003,
        "train.backward": 0.035, "train.optimizer": 0.004, "train.loss_read": 0.0})
    assert sp.host_ms() == pytest.approx({
        "train.step": 0.089, "train.input": 0.010, "train.forward": 0.019, "train.loss": 0.005,
        "train.backward": 0.034, "train.optimizer": 0.010, "train.loss_read": 0.009})


def test_idle_gaps_go_to_the_span_at_their_midpoint_and_the_boundary_is_exact():
    sp = _build(_slice())
    # gaps: [5, 8.5] outside every span; [9, 13], [109, 113] in the input;
    # [15, 26], [115, 126] in the step between input and forward; [47, 50],
    # [147, 150] in the backward; [89, 108.5], [189, 195] in the loss read
    assert sp.idle_ms() == pytest.approx({
        None: 0.00175, "train.input": 0.004, "train.step": 0.011, "train.backward": 0.003,
        "train.loss_read": 0.01275})
    assert sp.boundary_idle_ms() == pytest.approx((3.5 + 8 + 22 + 25.5) / STEPS / 1e3)
    assert sp.busy_ms() + sum(sp.idle_ms().values()) == pytest.approx(0.190 / STEPS)
    assert "12 of 14 device events attributed" in sp.summary()


def _drop_call(launches):  # a device event with no enqueuing call recorded
    return [(("aten::empty",) + x[1:]) if i == 3 else x for i, x in enumerate(launches)]


def _wrong_kind(launches):  # a fill left by a kernel launch
    return [(("cudaLaunchKernel",) + x[1:]) if x[0] == "cudaMemsetAsync" else x
            for x in launches]


def _before_launch(launches):  # a kernel that starts before its launch
    return [x[:1] + (x[3] + 0.1,) + x[2:] if i == 2 else x for i, x in enumerate(launches)]


@pytest.mark.parametrize("broken", [_drop_call, _wrong_kind, _before_launch])
def test_launches_that_cannot_be_paired_leave_the_device_ms_unread(broken):
    sp = _build(_slice(broken(LAUNCHES)))
    assert sp.unpaired and sp.device_ms() is None and sp.attributed() == (0, 14)
    assert "launches not paired" in sp.summary()
    # what needs no pairing is read as before
    assert sp.host_ms()["train.input"] == pytest.approx(0.010)
    assert sp.boundary_idle_ms() == pytest.approx(0.0295)
    for metric in ("forward_ms", "backward_ms", "loss_ms"):
        reader = importlib.import_module(f"portbench.metrics.{metric}")
        assert reader.read({"slice": _slice(broken(LAUNCHES))}, f"{metric}.train") is None


@pytest.mark.parametrize("metric, want", [
    ("forward_ms", 0.018), ("backward_ms", 0.035), ("loss_ms", 0.003), ("input_ms", 0.010),
    ("boundary_idle_ms", 0.0295)])
def test_readers_read_the_slice_and_nothing_without_spans(metric, want):
    reader = importlib.import_module(f"portbench.metrics.{metric}")
    assert reader.read({"slice": _slice()}, f"{metric}.train") == pytest.approx(want)
    # a program that opens no span: the slice is there and the readers find nothing
    assert reader.read({"slice": _slice(phase_spans=[])}, f"{metric}.train") is None
    assert reader.read({}, f"{metric}.train") is None


def test_the_spans_are_built_once_a_run_with_one_line(capsys):
    record = {"slice": _slice()}
    first = spans.of(record)
    assert spans.of(record) is first and record["spans"] is first
    err = capsys.readouterr().err
    assert err.count("span slice:") == 1 and "12 of 14 device events attributed" in err
