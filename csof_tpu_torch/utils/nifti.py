"""NIfTI-1 writer (numpy only): the ``save_nifti`` of ``csof_tpu/utils/nifti.py``,
carried here so that the port never imports the JAX package
(``tests/test_torch_serving.py`` holds the two to identical bytes).

Arrays are (z, y, x) or (t, z, y, x); ``spacing_xyz`` is the (x, y, z) voxel size.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPE_CODES = {
    np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
    np.dtype(np.float32): 16, np.dtype(np.float64): 64, np.dtype(np.int8): 256,
    np.dtype(np.uint16): 512, np.dtype(np.uint32): 768,
}


def save_nifti(data_zyx: np.ndarray, path: str | Path, affine: np.ndarray | None = None,
               spacing_xyz=None, dtype=None) -> None:
    """Write NIfTI-1 (single-file .nii, gzipped if the path ends in .gz);
    the sform carries the affine."""
    path = Path(path)
    data = np.asarray(data_zyx)
    if dtype is not None:
        data = data.astype(dtype)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype not in _DTYPE_CODES or data.dtype == np.float64:
        data = data.astype(np.float32)
    if spacing_xyz is None:
        if affine is not None:
            spacing_xyz = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
        else:
            spacing_xyz = (1.0, 1.0, 1.0)
    if affine is None:
        affine = np.diag([*spacing_xyz, 1.0])

    arr_xyz = np.asfortranarray(data.T)  # (x, y, z[, t])
    dim = [arr_xyz.ndim, *arr_xyz.shape] + [1] * (7 - arr_xyz.ndim)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[arr_xyz.dtype])
    struct.pack_into("<h", hdr, 72, arr_xyz.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing_xyz, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(arr_xyz.tobytes(order="F"))
