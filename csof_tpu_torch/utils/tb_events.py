"""A TensorBoard event-file writer without tensorboardX or protobuf: the
TFRecord framing with its masked CRC-32C, the ``Event`` / ``Summary``
protocol-buffer fields hand-encoded, and a GIF writer for video summaries.

The file holds what tensorboardX's ``SummaryWriter`` writes: a first event
with ``file_version = "brain.Event:2"``, then one event a summary with its
wall time and step. Scalars are ``simple_value`` summaries; images are
``Image`` summaries holding a PNG (:func:`csof_tpu_torch.utils.png.write_png`'s
encoding); a video is the animated GIF that tensorboardX writes when moviepy
is present, as an ``Image`` summary (the frames grey, in a 256-level
palette). Fields, by number:

- ``Event``: wall_time 1 (double), step 2 (int64), file_version 3
  (string), summary 5;
- ``Summary``: value 1 (repeated); ``Summary.Value``: tag 1, simple_value 2
  (float), image 4;
- ``Summary.Image``: height 1, width 2, colorspace 3, encoded_image_string 4.
"""

from __future__ import annotations

import re
import socket
import struct
import time
from pathlib import Path

import numpy as np


def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_CRC_TABLE = [int(v) for v in _crc32c_table()]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 plus 0xa282ead8."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length (uint64 LE), its masked CRC, data, data's masked CRC."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negative int64s as ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v)) if v else b""


def image_proto(height: int, width: int, colorspace: int, encoded: bytes) -> bytes:
    """A ``Summary.Image``."""
    return (_int_field(1, height) + _int_field(2, width) + _int_field(3, colorspace)
            + (_bytes_field(4, encoded) if encoded else b""))


def value_proto(tag: str, simple_value: float | None = None, image: bytes | None = None) -> bytes:
    """A ``Summary.Value`` with a scalar or an encoded ``Summary.Image``."""
    out = _bytes_field(1, tag.encode())
    if simple_value is not None:
        out += _key(2, 5) + struct.pack("<f", simple_value)
    if image is not None:
        out += _bytes_field(4, image)
    return out


def event_proto(wall_time: float, step: int = 0, file_version: str | None = None,
                values: list[bytes] | None = None) -> bytes:
    """An ``Event``: a file-version event, or a summary of ``values``."""
    out = _key(1, 1) + struct.pack("<d", wall_time) if wall_time else b""
    out += _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if values is not None:
        out += _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))
    return out


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """tensorboardX's tag cleaning: characters other than ``-/\\w.`` become
    ``_``, leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def _lzw_codes(indices: bytes, min_size: int = 8):
    """GIF's variable-width LZW codes of ``indices``, as (code, width) pairs,
    with a clear code first and whenever the table fills."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1
    table = {bytes([i]): i for i in range(clear)}
    nxt = end + 1
    yield clear, width
    w = b""
    for b in indices:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        yield table[w], width
        if nxt == 4096:
            yield clear, width
            table = {bytes([i]): i for i in range(clear)}
            nxt, width = end + 1, min_size + 1
        else:
            table[wc] = nxt
            if nxt == 1 << width and width < 12:
                width += 1
            nxt += 1
        w = bytes([b])
    if w:
        yield table[w], width
        # the decoder adds an entry on reading that code: the end code may be wider
        if nxt == 1 << width and width < 12:
            width += 1
    yield end, width


def _lzw(indices: bytes) -> bytes:
    acc = bits = 0
    out = bytearray()
    for code, width in _lzw_codes(indices):
        acc |= code << bits
        bits += width
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(frames: np.ndarray, fps: int = 4) -> bytes:
    """An animated GIF of grey uint8 frames ``(T, H, W)``: a 256-level grey
    global palette, each frame's pixels its indices, ``100 / fps``
    hundredths of a second a frame, looping."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 3:
        raise ValueError(f"write_gif takes (T, H, W) uint8 frames, got {frames.shape} "
                         f"{frames.dtype}")
    t, h, w = frames.shape
    palette = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    delay = int(round(100 / fps))
    for frame in frames:
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += b"\x08" + _sub_blocks(_lzw(frame.tobytes()))
    return out + b"\x3b"


class EventFileWriter:
    """Events to ``log_dir/events.out.tfevents.<seconds>.<host>``, as
    tensorboardX names its file; ``clock`` gives each event's wall time (a
    fixed clock makes the file's bytes reproducible)."""

    def __init__(self, log_dir: str | Path, clock=time.time):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.clock = clock
        self.path = self.log_dir / (f"events.out.tfevents.{str(clock())[:10]}."
                                    f"{socket.gethostname()}")
        self._file = open(self.path, "wb")
        self._write(event_proto(clock(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))

    def add_values(self, values: list[bytes], step: int, wall_time: float | None = None):
        self._write(event_proto(self.clock() if wall_time is None else wall_time, int(step),
                                values=values))

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()
