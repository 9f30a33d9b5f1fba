"""Build and load the hand-written CUDA kernels (``csof_tpu_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded through :mod:`ctypes`.
No PyTorch header is included, so a build takes seconds. The library is built
at first use into ``csof_tpu_torch/_build/`` under a name keyed by a hash of
the sources and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, m, out, B, C, H, W, radius, stride, dtype_code, stream
    "csof_corr_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, m, g, dq, dm, B, C, H, W, radius, stride, dtype_code, stream
    "csof_corr_backward": [_P] * 5 + [_I] * 7 + [_P],
    # q, m, corr, packed w, bias, gn_scale, gn_bias, y, partial, out,
    # B, C, K2, H, W, F, groups, nb, eps, slope, dtype_code, stream
    "csof_skipfuse_forward": [_P] * 10 + [_I] * 8 + [_F, _F, _I, _P],
    # x, scale, bias, out, planes, C, HW, cluster, slice, smem, eps, slope,
    # dtype_code, stream
    "csof_norm_act_forward": [_P] * 4 + [_I] * 6 + [_F, _F, _I, _P],
    # z, gamma, beta, y, mean, rstd, planes, C, HW, cluster, slice, smem, eps,
    # slope, stream
    "csof_inorm_lrelu_forward": [_P] * 6 + [_I] * 6 + [_F, _F, _P],
    # z, dy, mean, rstd, gamma, beta, dz, pda, pdah, planes, C, HW, cluster,
    # slice, smem, slope, stream
    "csof_inorm_lrelu_backward": [_P] * 9 + [_I] * 6 + [_F, _P],
    # x, packed w, bias, out, N, Ci, H, W, Co, nb, dtype_code, out_f32, dx, stream
    "csof_conv3x3_forward": [_P] * 4 + [_I] * 9 + [_P],
    # pred, target, cc, loss, planes, C, H, W, window, eps, dtype_code,
    # threads, tile_cols, band_rows, smem, stream
    "csof_ncc_forward": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # pred, target, cc, loss, scratch, planes, C, H, W, window, eps,
    # dtype_code, threads, blocks, stream
    "csof_ncc_forward_wide": [_P] * 5 + [_I] * 5 + [_F] + [_I] * 3 + [_P],
    # window, mismatches, stream
    "csof_ncc_check_division": [_I, _P, _P],
}

#: seconds the last compile in this process took (0.0 if none ran)
last_build_seconds = 0.0


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "csof_tpu_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcsof_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in jobs:  # every compile runs to its end: none is left behind
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(obj)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                               *(obj for obj, _ in jobs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        (BUILD_DIR / (out.stem + ".log")).write_text("\n".join(logs))
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.csof_error_string.argtypes = [ctypes.c_int]
    lib.csof_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code (cudaGetLastError after
    its launches): a refused launch never runs, and a later synchronize would
    not report it."""
    if err != 0:
        msg = load_library().csof_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def _current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream, without the
    ``torch.cuda.Stream`` object ``current_stream()`` builds."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def cuda_call(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``name`` with ``args`` and the current stream of the
    CUDA ``device`` (an index is set), under a device guard only where it is
    not the current device (the guard and the stream object are most of a
    small launch's host time), and raise on a launch error."""
    guard = (contextlib.nullcontext() if device.index == torch.cuda.current_device()
             else torch.cuda.device(device))
    with guard:
        err = getattr(load_library(), name)(*args, _current_stream(device.index))
    check(err, name)
