"""Read a Flax ``serialization.to_bytes`` / ``msgpack_serialize`` file (the
JAX package's ``weights.msgpack`` and ``ckpt_*.msgpack``) with the standard
library and numpy, since neither flax nor msgpack need be installed.

The format is msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md)
with two extension types of Flax's:

* 1, an ndarray: a nested msgpack array (shape, dtype name, row-major bytes);
* 3, a numpy scalar: the same, of shape ().

An array larger than Flax's chunk size is stored as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
ndarray, ...}}`` and comes back whole.  Anything else (another extension,
a byte the spec leaves unused, trailing bytes) raises ValueError.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["read_flax_msgpack", "restore_flax_msgpack"]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")  # widened to float32 in _ndarray
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"flax msgpack: unknown array dtype {name!r}") from e
    if dt.hasobject or dt.fields is not None:
        raise ValueError(f"flax msgpack: unsupported array dtype {name!r}")
    return dt.newbyteorder("<")


def _ndarray(data: bytes) -> np.ndarray:
    value = MsgpackReader(data).read_all()
    if not (isinstance(value, list) and len(value) == 3 and isinstance(value[0], list)
            and isinstance(value[1], str) and isinstance(value[2], bytes)):
        raise ValueError("flax msgpack: an ndarray extension is not (shape, dtype name, bytes)")
    shape, name, buf = value
    arr = np.frombuffer(buf, dtype=_dtype(name)).reshape(shape)
    if name == "bfloat16":  # the upper half of a float32, exactly
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(arr.dtype.newbyteorder("="))


class MsgpackReader:
    """A msgpack decoder with Flax's extension types.  Subclasses change
    how strings come back (``text``) and what a decoded map becomes
    (``finish_map``)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("flax msgpack: truncated data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def text(self, n: int) -> Any:
        return self.take(n).decode("utf-8")

    def finish_map(self, out: dict) -> Any:
        return _unchunk(out) if out.get(_CHUNKED) is True else out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def read_all(self) -> Any:
        value = self.read()
        if self.pos != len(self.data):
            raise ValueError(f"flax msgpack: {len(self.data) - self.pos} bytes after the value")
        return value

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"flax msgpack: unsupported extension type {code}")

    def read(self) -> Any:  # noqa: C901 - one branch a msgpack format family
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}  # str
        if b in sized:
            return self.text(self.unpack(sized[b]))
        sized = {0xDC: "H", 0xDD: "I"}  # array
        if b in sized:
            return [self.read() for _ in range(self.unpack(sized[b]))]
        sized = {0xDE: "H", 0xDF: "I"}  # map
        if b in sized:
            return self.map(self.unpack(sized[b]))
        sized = {0xC7: "B", 0xC8: "H", 0xC9: "I"}  # ext
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"flax msgpack: byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            key = self.read()
            if isinstance(key, (dict, list)):
                raise ValueError("flax msgpack: a map key is a container")
            out[key] = self.read()
        return self.finish_map(out)


def _items(tree: dict, what: str) -> Tuple[Any, ...]:
    if not isinstance(tree, dict) or set(tree) != {str(i) for i in range(len(tree))}:
        raise ValueError(f"flax msgpack: a chunked array's {what} is not a map of 0..n-1")
    return tuple(tree[str(i)] for i in range(len(tree)))


def _unchunk(tree: dict) -> np.ndarray:
    if set(tree) != {_CHUNKED, "shape", "chunks"}:
        raise ValueError(f"flax msgpack: a chunked array holds keys {sorted(tree)}")
    chunks = _items(tree["chunks"], "chunks")
    if not chunks or not all(isinstance(c, np.ndarray) for c in chunks):
        raise ValueError("flax msgpack: a chunked array's chunks are not arrays")
    return np.concatenate(chunks).reshape(_items(tree["shape"], "shape"))


def restore_flax_msgpack(data: bytes) -> Any:
    """Bytes of ``flax.serialization.to_bytes`` -> the nested dicts of numpy
    arrays (writable copies) and scalars that ``msgpack_restore`` gives."""
    return MsgpackReader(data).read_all()


def read_flax_msgpack(path: str) -> Any:
    """``restore_flax_msgpack`` of a file."""
    with open(path, "rb") as f:
        return restore_flax_msgpack(f.read())
