"""Shims the benchmark puts around the program during a traced slice.

``LaunchRecorder`` wraps the loader of the port's kernel library, so that
every call of a C entry point of a hand-written kernel (K1, K3, K5, K6 and
its dx) is recorded with the shapes it was given, and each call's bound
(:mod:`portbench.yardstick.bounds`) follows from them. ``ForwardSpans``
times the network's forward calls on the host clock, synchronized at both
edges; ``Annotated`` names them in a profiler trace; ``CudaEventTimer``
times a method by CUDA events. Each restores what it replaced when its
``with`` block ends. None of them runs in an untraced window.
"""

from __future__ import annotations

import time

import torch

from portbench.yardstick import bounds

#: device kernels of the port's CUDA sources (``csrc/*.cu``), by name fragment
HAND_KERNELS = ("conv3x3_kernel", "conv3x3_dx_kernel", "corr_kernel", "corr_bwd_kernel",
                "fuse_conv_kernel", "gn_apply_kernel", "norm_act_small_kernel",
                "norm_act_plane_kernel", "ncc_kernel", "ncc_vertical_kernel",
                "ncc_horizontal_kernel")
_ITEMSIZE = {0: 4, 1: 2}  # the C entries' dtype codes: float32, bfloat16


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


def launch_bound(entry: str, args: tuple) -> tuple[str, float] | None:
    """(kernel, bound seconds) of one call of a C entry point, or None for an
    entry without a bound here (K4's, K2's)."""
    if entry == "csof_conv3x3_forward":
        n, ci, h, w, co, _, code, _, dx = args[4:13]
        work = bounds.conv3x3_work(n, h, w, ci, co, _ITEMSIZE[code], bias=args[2] is not None)
        return ("K6_dx" if dx else "K6"), bounds.bound_s(*work)
    if entry == "csof_corr_forward":
        b, c, h, w, radius, _, code = args[3:10]
        return "K1", bounds.bound_s(*bounds.corr_work("K1", b, c, h, w, _ITEMSIZE[code], radius))
    if entry == "csof_skipfuse_forward":
        b, c, k2, h, w = args[10:15]
        radius = (int(round(k2 ** 0.5)) - 1) // 2
        work = bounds.corr_work("K3", b, c, h, w, _ITEMSIZE[args[20]], radius)
        return "K3", bounds.bound_s(*work)
    if entry == "csof_norm_act_forward":
        planes, _, hw = args[4:7]
        return "K5", bounds.bound_s(*bounds.norm_act_work(planes, 1, hw, _ITEMSIZE[args[12]]))
    return None


class _RecordingLibrary:
    def __init__(self, lib, calls: list):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("csof_") or name == "csof_error_string":
            return fn

        def call(*args):
            self._calls.append((name, args))
            return fn(*args)

        return call


class LaunchRecorder:
    """Records (entry point, arguments) of every kernel call in its block."""

    def __init__(self):
        self.calls: list[tuple[str, tuple]] = []

    def __enter__(self):
        from csof_tpu_torch.ops.kernels import _build

        self._build, self._orig = _build, _build.load_library
        lib = self._orig()
        _build.load_library = lambda: _RecordingLibrary(lib, self.calls)
        return self

    def __exit__(self, *exc):
        self._build.load_library = self._orig
        return False

    def bounds(self) -> list[tuple[str, float]]:
        """(kernel, bound seconds) of each recorded launch. A K3 call takes the
        K1 call just before it (its correlation pass) into its own bound."""
        out: list[tuple[str, float]] = []
        for entry, args in self.calls:
            b = launch_bound(entry, args)
            if b is None:
                continue
            if b[0] == "K3" and out and out[-1][0] == "K1":
                out.pop()
            out.append(b)
        return out


class ForwardSpans:
    """Host seconds of each ``module.forward`` call in the block, with the
    device synchronized at both edges."""

    def __init__(self, module: torch.nn.Module):
        self.module, self.spans = module, []

    def __enter__(self):
        inner = self.module.forward

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.spans.append(time.perf_counter() - t0)
            return out

        self.module.forward = timed
        return self

    def __exit__(self, *exc):
        del self.module.forward  # the class's method again
        return False


class Annotated:
    """Each ``module.forward`` call in the block inside a profiler annotation."""

    def __init__(self, module: torch.nn.Module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        inner = self.module.forward

        def annotated(*args, **kwargs):
            with torch.profiler.record_function(self.name):
                return inner(*args, **kwargs)

        self.module.forward = annotated
        return self

    def __exit__(self, *exc):
        del self.module.forward
        return False


class CudaEventTimer:
    """Device milliseconds of each call of ``obj.<name>`` in the block, by
    CUDA events around it (read once the block has ended)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.events = obj, name, []

    def __enter__(self):
        inner = getattr(self.obj, self.name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)
        return False

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]
