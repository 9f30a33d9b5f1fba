"""A PNG writer and reader on ``zlib`` and ``struct``, and a small raster
canvas for line plots, so that the port writes its figures without
matplotlib (which the card machine does not have).

``write_png`` (``encode_png`` for the bytes) stores 8-bit grey, RGB or RGBA
rows with filter 0; ``read_png``
reads the files it writes (8-bit grey, RGB or RGBA, filter 0 on every row).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray) -> Path:
    """Write ``image`` (H, W) grey or (H, W, 3|4) uint8 as a PNG."""
    Path(path).write_bytes(encode_png(image))
    return Path(path)


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file's bytes of ``image`` (H, W) grey or (H, W, 3|4) uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path: str | Path) -> np.ndarray:
    """(H, W, C) uint8 pixels of a PNG that ``write_png`` wrote."""
    raw = Path(path).read_bytes()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        if struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + data):
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit grey, RGB or RGBA without interlace is read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, channels).copy()


class Canvas:
    """A white RGB raster with data-to-pixel maps for a plot box."""

    def __init__(self, width: int, height: int):
        self.pixels = np.full((height, width, 3), 255, np.uint8)

    def rect(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        """Fill [x0, x1) x [y0, y1), clipped to the canvas."""
        h, w, _ = self.pixels.shape
        self.pixels[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = color

    def polyline(self, xs, ys, color, width: int = 2, dash: int = 0) -> None:
        """Connect the pixel points (xs, ys); ``dash`` > 0 draws dashes of
        that many pixels with gaps as long. A single point is a dot."""
        pts = np.stack([np.asarray(xs, float), np.asarray(ys, float)], 1)
        if len(pts) == 1:
            pts = np.concatenate([pts, pts])
        run = 0.0
        for (xa, ya), (xb, yb) in zip(pts[:-1], pts[1:]):
            steps = max(int(np.ceil(np.hypot(xb - xa, yb - ya))), 1)
            for k in range(steps + 1):
                if not dash or (run + k) % (2 * dash) < dash:
                    x = int(round(xa + (xb - xa) * k / steps))
                    y = int(round(ya + (yb - ya) * k / steps))
                    self.rect(x - width // 2, y - width // 2, x - width // 2 + width,
                              y - width // 2 + width, color)
            run += steps
