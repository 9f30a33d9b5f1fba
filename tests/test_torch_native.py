"""The port's threaded C++ host library (``csof_tpu_torch/native``) against
the JAX package's (``csof_tpu/native``, the same source built with the same
flags): bit for bit; against the port's numpy versions (the loaders' plain
references) exactly where the arithmetic is the same, within a stated
rounding where it is not; the loaders that call it; a failed build raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads

from csof_tpu.data import loaders as jloaders
from csof_tpu.native import bindings as jnative
from csof_tpu_torch import native
from csof_tpu_torch.data import loaders
from csof_tpu_torch.native import bindings

torch_threads.pin()


@pytest.fixture(scope="module", autouse=True)
def jax_library_built():
    assert jnative.native_available(), "the JAX package's native library must build here"


#: (patch, centers): at the origin, the far corner, the middle, past every
#: border (partly and wholly outside), and an odd patch
GATHER_CASES = [
    ((4, 6, 5), [(0, 0, 0), (8, 10, 6), (4, 5, 3), (-9, 2, 2), (2, 14, -1), (11, 12, 9)]),
    ((3, 7, 7), [(1, 1, 1), (9, 11, 7), (-1, -3, 3)]),
    ((6, 8), [(0, 0), (10, 6), (5, 3), (-4, 20), (13, 3)]),
    ((5, 5), [(2, 2), (0, 10), (12, -2)]),
]


@pytest.mark.parametrize("patch,centers", GATHER_CASES)
def test_patch_gather_equals_the_jax_library_and_the_numpy_branch(patch, centers):
    src = np.random.RandomState(12).rand(2, 9, 11, 7).astype(np.float32)
    arr = src if len(patch) == 3 else src[:, 4].copy()
    gather, jgather = ((native.extract_patches_3d, jnative.extract_patches_3d) if len(patch) == 3
                       else (native.extract_patches_2d, jnative.extract_patches_2d))
    got = gather(arr, centers, patch, num_threads=3)
    np.testing.assert_array_equal(got, jgather(arr, np.asarray(centers), patch))
    np.testing.assert_array_equal(got, loaders.extract_patches(arr, centers, patch))
    assert got.shape == (len(centers), 2, *patch)


def test_threads_follow_the_work_and_leave_the_results_alone():
    """One thread per 2^21 elements, at most one a row and the CPU count: a
    loader's call (one patch, one clip of 6 x 128^2) starts none."""
    t = bindings.threads_for
    assert t(1, 1 << 30) == 1 and t(6, 6 * 128 * 128) == 1
    assert t(64, 64 << 21) == min(64, bindings.MAX_THREADS)
    assert t(8, 3 << 21) == min(3, bindings.MAX_THREADS)
    x = _frames()
    np.testing.assert_array_equal(native.minmax_normalize(x.copy()),
                                  native.minmax_normalize(x.copy(), num_threads=5))


def test_gather_refuses_shapes_that_do_not_fit():
    with pytest.raises(ValueError, match="2-D gather"):
        native.extract_patches_2d(np.zeros((1, 4, 4, 4), np.float32), [(0, 0)], (2, 2))
    with pytest.raises(ValueError, match="3-D gather"):
        native.extract_patches_3d(np.zeros((1, 4, 4, 4), np.float32), [(0, 0, 0)], (2, 0, 2))


def _frames(seed=14):
    x = np.random.RandomState(seed).rand(5, 6, 37).astype(np.float32) * 50 - 3
    x[2] = 7.0  # a constant frame: max - min is 0, eps alone divides
    return x


def test_normalizers_equal_the_jax_library_bit_for_bit():
    for fn, jfn in ((native.minmax_normalize, jnative.minmax_normalize),
                    (native.zscore_normalize, jnative.zscore_normalize)):
        got, ref = fn(_frames(), num_threads=4), jfn(_frames())
        np.testing.assert_array_equal(got, ref)


def test_normalizers_against_the_numpy_branch():
    """min-max: (x - min) times the float32 reciprocal of (max - min + eps)
    against numpy's division: within two roundings of a value in [0, 1]
    (2^-22); z-score: float64 sums against numpy's float32 mean and std."""
    x = _frames()
    got = native.minmax_normalize(x.copy())
    ref = loaders.minmax_normalize(x.copy())
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -22)
    assert got.min() == 0 and got[np.arange(5) != 2].max() <= 1
    z = native.zscore_normalize(x.copy())
    flat = x.reshape(5, -1)
    ref = ((flat - flat.mean(1, keepdims=True)) / (flat.std(1, keepdims=True) + 1e-8))
    np.testing.assert_allclose(z.reshape(5, -1), ref, rtol=1e-5, atol=1e-5)


def test_normalizers_refuse_arrays_they_cannot_work_in_place():
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.minmax_normalize(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.zscore_normalize(np.zeros((3, 2), np.float32).T)


def test_one_hot_equals_the_jax_library():
    labels = np.random.RandomState(5).randint(-2, 6, (3, 7, 5))
    got = native.one_hot(labels, 4, num_threads=2)
    np.testing.assert_array_equal(got, jnative.one_hot(labels, 4))
    assert got.shape == (3, 7, 5, 4) and not got[(labels < 0) | (labels >= 4)].any()


def test_video_loader_normalizes_with_the_library_as_the_jax_loader():
    """VideoChunkLoader runs the C++ min-max, as the JAX loader does: the
    same bits."""
    rng = np.random.RandomState(13)
    cines = {f"p{i}": {"frames": (100 * rng.rand(9, 2, 20, 22)).astype(np.float32),
                       "seg": None, "ed": i, "es": i + 4} for i in range(2)}
    got = next(loaders.VideoChunkLoader(cines, video_length=5, batch_size=3, crop_size=16,
                                        seed=4))
    ref = next(jloaders.VideoChunkLoader(cines, video_length=5, batch_size=3, crop_size=16,
                                         seed=4))
    np.testing.assert_array_equal(got["video"], ref["video"])


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    broken = tmp_path / "csof_native.cpp"
    broken.write_text(bindings.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(bindings, "SOURCE", broken)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    bindings.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            native.minmax_normalize(np.ones((2, 3), np.float32))
        with pytest.raises(RuntimeError, match="failed"):
            loaders.SegPatchLoader({}, (4, 4), 1)._crop_nd(np.zeros((2, 8, 8), np.float32))
        monkeypatch.setenv("CXX", "no-such-compiler")
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            bindings.build()
    finally:
        bindings.load_library.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))
