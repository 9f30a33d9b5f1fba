"""NIfTI-1 reader and writer (numpy only): ``load_nifti`` and ``save_nifti`` of
``csof_tpu/utils/nifti.py``, carried here so that the port never imports the
JAX package (``tests/test_torch_serving.py`` and ``tests/test_torch_unet.py``
hold the two to identical bytes and arrays).

Arrays are (z, y, x) or (t, z, y, x); ``spacing_xyz`` is the (x, y, z) voxel size.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
           256: np.int8, 512: np.uint16, 768: np.uint32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume in SimpleITK-style axis order."""

    data_czyx: np.ndarray  # (z, y, x) or (t, z, y, x)
    affine: np.ndarray  # 4x4 voxel (x, y, z) -> world map
    itk_spacing: tuple[float, ...]  # (x, y, z)
    header_dtype: np.dtype | None = None

    @property
    def spacing_zyx(self) -> tuple[float, ...]:
        return tuple(self.itk_spacing[::-1])

    @property
    def origin(self) -> tuple[float, ...]:
        return tuple(float(v) for v in self.affine[:3, 3])

    @property
    def direction(self) -> tuple[float, ...]:
        d = self.affine[:3, :3] / np.array(self.itk_spacing)[None, :]
        return tuple(float(v) for v in d.reshape(-1))


def load_nifti(path: str | Path) -> NiftiImage:
    """Read a NIfTI-1 file (.nii or .nii.gz): data scaled by scl_slope/inter,
    the affine from the sform, else the qform, else the pixdim diagonal."""
    path = Path(path)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    endian = "<"
    if struct.unpack("<i", hdr[0:4])[0] != 348:
        if struct.unpack(">i", hdr[0:4])[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"

    def unpack(fmt, off, n=1):
        vals = struct.unpack_from(endian + fmt * n, hdr, off)
        return vals[0] if n == 1 else vals

    dim = unpack("h", 40, 8)
    shape_xyz = [max(1, d) for d in dim[1:1 + max(dim[0], 3)]]
    datatype = unpack("h", 70)
    pixdim = unpack("f", 76, 8)
    vox_offset = int(unpack("f", 108))
    scl_slope, scl_inter = unpack("f", 112), unpack("f", 116)
    qform_code, sform_code = unpack("h", 252), unpack("h", 254)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape_xyz)), offset=vox_offset)
    data = data.reshape(shape_xyz, order="F")  # voxel data is Fortran-ordered over (x, y, z)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        data = data.astype(np.float32) * (scl_slope if scl_slope != 0 else 1.0) + scl_inter

    if sform_code > 0:
        srow = np.array([unpack("f", 280, 4), unpack("f", 296, 4), unpack("f", 312, 4)])
        affine = np.vstack([srow, [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = unpack("f", 256), unpack("f", 260), unpack("f", 264)
        a = np.sqrt(max(0.0, 1.0 - b * b - c * c - d * d))
        rot = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        affine = np.eye(4)
        affine[:3, :3] = rot @ np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine[:3, 3] = (unpack("f", 268), unpack("f", 272), unpack("f", 276))
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    spacing_xyz = tuple(float(abs(p)) if p != 0 else 1.0 for p in pixdim[1:4])
    return NiftiImage(data_czyx=np.ascontiguousarray(data.T), affine=affine.astype(np.float64),
                      itk_spacing=spacing_xyz, header_dtype=np.dtype(_DTYPES[datatype]))


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
