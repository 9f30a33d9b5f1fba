"""Read a flax msgpack checkpoint without flax or msgpack: the counterpart of
``flax.serialization.msgpack_restore``.

The decoder covers the msgpack types that flax writes: nil, bool, every
integer width, float32 and float64, str, bin, array (as a list) and map, and
flax's extension types:

- ext 1, an ndarray: a msgpack ``(shape, dtype name, C-order buffer)``;
- ext 2, a Python complex: a msgpack ``(real, imag)``;
- ext 3, a numpy scalar: as ext 1, unwrapped to a scalar.

Arrays come back as writable numpy arrays, except ``bfloat16``, which numpy
has no dtype for: its raw ``uint16`` bits become a ``torch.bfloat16`` tensor
(a 0-d one for a scalar). Flax's chunked leaves (``{"__msgpack_chunked_array__":
True, "shape", "chunks"}``, written for arrays over ``MAX_CHUNK_SIZE`` bytes)
are joined back into one array. Anything else (another ext type, the unused
byte 0xc1, a truncated or trailing buffer) raises :class:`MsgpackError`
naming the byte offset.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: byte -> (struct format, size)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed: byte -> (kind, width of the length)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class MsgpackError(ValueError):
    """A byte sequence outside the msgpack subset that flax writes."""


class _Reader:
    def __init__(self, data: bytes, base: int = 0):
        self.data = memoryview(data)
        self.pos = 0
        self.base = base  # offset of data[0] in the outermost buffer, for messages

    def fail(self, msg: str, at: int | None = None):
        raise MsgpackError(f"msgpack byte offset {self.base + (self.pos if at is None else at)}: "
                           f"{msg}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted, {len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LEN[width], width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n, at)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n, at)
            return self.ext(n, at)
        self.fail(f"byte 0x{b:02x} is not a msgpack type", at)

    def str(self, n: int, at: int) -> str:
        raw = self.take(n)
        try:
            return str(raw, "utf-8")
        except UnicodeDecodeError:
            self.fail("str is not valid UTF-8", at)

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, (str, bytes)):
                self.fail(f"map key of type {type(key).__name__} (flax writes str keys)", key_at)
            out[key] = self.value()
        return out

    def ext(self, n: int, at: int) -> Any:
        code = self.unpack(">b", 1)
        payload_at = self.base + self.pos
        payload = bytes(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(payload, payload_at)
            return arr if code == EXT_NDARRAY else _scalar(arr)
        if code == EXT_COMPLEX:
            parts = _Reader(payload, payload_at).whole()
            if not (isinstance(parts, list) and len(parts) == 2):
                self.fail(f"complex payload {parts!r} is not (real, imag)", at)
            return complex(parts[0], parts[1])
        self.fail(f"ext type {code} is not one flax writes (1 ndarray, 2 complex, 3 scalar)", at)

    def whole(self) -> Any:
        out = self.value()
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} trailing bytes after the value")
        return out


def _ndarray(payload: bytes, at: int):
    r = _Reader(payload, at)
    parts = r.whole()
    if not (isinstance(parts, list) and len(parts) == 3):
        r.fail("ndarray payload is not (shape, dtype, buffer)", 0)
    shape, name, buf = parts
    if isinstance(name, bytes):
        name = name.decode()
    if not (isinstance(shape, list) and all(isinstance(s, int) for s in shape)
            and isinstance(buf, bytes) and isinstance(name, str)):
        r.fail(f"ndarray payload of types {[type(p).__name__ for p in parts]}", 0)
    if name == "bfloat16":
        if len(buf) != 2 * int(np.prod(shape, dtype=np.int64)):
            r.fail(f"ndarray buffer of {len(buf)} bytes does not hold {shape} bfloat16", 0)
        bits = np.frombuffer(buf, np.dtype("<i2")).copy()  # the raw bits, as int16
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        r.fail(f"ndarray dtype {name!r} is not a numpy dtype", 0)
    if dtype.hasobject or np.prod(shape, dtype=np.int64) * dtype.itemsize != len(buf):
        r.fail(f"ndarray buffer of {len(buf)} bytes does not hold {shape} {name}", 0)
    return np.frombuffer(buf, dtype).reshape(shape).copy()


def _scalar(arr):
    if isinstance(arr, torch.Tensor):
        return arr.reshape(())
    return arr[()]


def _unchunk(tree):
    """Join flax's chunked leaves back into arrays, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns:
    nested dicts with str keys, lists, Python scalars and array leaves."""
    return _unchunk(_Reader(bytes(data)).whole())


def load_msgpack(path: str | Path) -> Any:
    """``msgpack_restore`` of a file's bytes."""
    return msgpack_restore(Path(path).read_bytes())
