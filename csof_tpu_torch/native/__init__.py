"""The threaded C++ host library of the data plane (port of
``csof_tpu/native``): patch gather, min-max and z-score normalization,
one-hot, bound by ctypes and built with g++ at first use."""

from csof_tpu_torch.native.bindings import (
    extract_patches_2d,
    extract_patches_3d,
    minmax_normalize,
    one_hot,
    zscore_normalize,
)

__all__ = ["extract_patches_2d", "extract_patches_3d", "minmax_normalize", "zscore_normalize",
           "one_hot"]
