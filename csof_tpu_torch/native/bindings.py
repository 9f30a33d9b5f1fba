"""ctypes bindings of the host data-plane library (``csof_native.cpp`` beside
this file; port of ``csof_tpu/native/bindings.py``).

The library is built with ``g++`` at first use into ``csof_tpu_torch/_build/``,
under a name keyed by a hash of the source and the flags, with the flags of
the JAX package's ``native/Makefile`` (so that both libraries compute the
same bits). A missing compiler or a failed build raises: there is no quiet
numpy fallback here; the numpy versions (``csof_tpu_torch/data/loaders.py``
``extract_patches``, ``minmax_normalize``) are the plain references the
tests hold these against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("csof_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")
#: the most worker threads a call starts (the JAX package starts this many
#: on every call)
MAX_THREADS = max(1, os.cpu_count() or 1)
#: elements of work that pay for starting one more thread: each call starts
#: its threads anew, and at a loader's call (one clip, one patch) starting
#: eight cost more than the work (``chip_smoke.py`` phase 35 (f) prints both)
ELEMENTS_PER_THREAD = 1 << 21

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "extract_patches_3d_f32": [_F32P, _I64P, _I64P, ctypes.c_int64, _I64P, _F32P, ctypes.c_int],
    "extract_patches_2d_f32": [_F32P, _I64P, _I64P, ctypes.c_int64, _I64P, _F32P, ctypes.c_int],
    "minmax_normalize_f32": [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int],
    "zscore_normalize_f32": [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int],
    "one_hot_f32": [_I32P, ctypes.c_int64, ctypes.c_int32, _F32P, ctypes.c_int],
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libcsof_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX): csof_tpu_torch's host library "
                           "is built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", lib], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.csof_native_version.restype = ctypes.c_int
    if lib.csof_native_version() != 1:
        raise RuntimeError(f"{lib._name}: unknown library version")
    return lib


def threads_for(items: int, elements: int) -> int:
    """The threads a call over ``items`` independent rows of ``elements``
    in all is given by default: one per ``ELEMENTS_PER_THREAD``, at most
    ``MAX_THREADS`` and ``items``. The results do not depend on it."""
    return max(1, min(MAX_THREADS, items, elements // ELEMENTS_PER_THREAD))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _extract(src: np.ndarray, centers, patch, nd: int, num_threads: int | None) -> np.ndarray:
    src = np.ascontiguousarray(src, np.float32)
    centers = np.ascontiguousarray(centers, np.int64).reshape(-1, nd)
    patch = np.ascontiguousarray(patch, np.int64)
    if src.ndim != nd + 1 or patch.shape != (nd,) or (patch < 1).any():
        raise ValueError(f"a {nd}-D gather needs src (c, {nd} axes) and {nd} patch sizes "
                         f"of at least 1, got {src.shape} and {patch}")
    dims = np.asarray(src.shape, np.int64)
    out = np.empty((len(centers), src.shape[0], *patch), np.float32)
    if num_threads is None:
        num_threads = threads_for(len(centers), out.size)
    fn = getattr(load_library(), f"extract_patches_{nd}d_f32")
    fn(_f32(src), _i64(dims), _i64(centers), len(centers), _i64(patch), _f32(out),
       int(num_threads))
    return out


def extract_patches_3d(src: np.ndarray, centers, patch,
                       num_threads: int | None = None) -> np.ndarray:
    """src (c, z, y, x) float32; centers (n, 3) -> (n, c, *patch): the window
    ``[center - patch // 2, + patch)`` of each center, zero past the borders.
    ``num_threads`` defaults to ``threads_for`` the work (as for every
    function here)."""
    return _extract(src, centers, patch, 3, num_threads)


def extract_patches_2d(src: np.ndarray, centers, patch,
                       num_threads: int | None = None) -> np.ndarray:
    """src (c, y, x) float32; centers (n, 2) -> (n, c, *patch), as the 3-D one."""
    return _extract(src, centers, patch, 2, num_threads)


def _rows(data: np.ndarray) -> tuple[int, int]:
    if data.dtype != np.float32 or not data.flags.c_contiguous or data.ndim < 1:
        raise ValueError("the normalizers work in place on a C-contiguous float32 array")
    return data.shape[0], int(np.prod(data.shape[1:]))


def minmax_normalize(data: np.ndarray, eps: float = 1e-8,
                     num_threads: int | None = None) -> np.ndarray:
    """In place: each leading index scaled to [0, 1] over its trailing dims,
    (x - min) * (1 / (max - min + eps))."""
    n, m = _rows(data)
    threads = threads_for(n, data.size) if num_threads is None else num_threads
    load_library().minmax_normalize_f32(_f32(data), n, m, eps, int(threads))
    return data


def zscore_normalize(data: np.ndarray, eps: float = 1e-8,
                     num_threads: int | None = None) -> np.ndarray:
    """In place: each leading index to zero mean and unit deviation (sums in
    float64), (x - mean) * (1 / (std + eps))."""
    n, m = _rows(data)
    threads = threads_for(n, data.size) if num_threads is None else num_threads
    load_library().zscore_normalize_f32(_f32(data), n, m, eps, int(threads))
    return data


def one_hot(labels: np.ndarray, num_classes: int,
            num_threads: int | None = None) -> np.ndarray:
    """int labels (...) -> float32 (..., num_classes); a label outside
    [0, num_classes) gives a zero row."""
    labels = np.ascontiguousarray(labels, np.int32)
    flat = labels.reshape(-1)
    out = np.empty((flat.shape[0], num_classes), np.float32)
    if num_threads is None:
        num_threads = threads_for(flat.shape[0], out.size)
    load_library().one_hot_f32(flat.ctypes.data_as(_I32P), flat.shape[0], num_classes,
                               _f32(out), int(num_threads))
    return out.reshape(*labels.shape, num_classes)
