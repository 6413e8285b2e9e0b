"""`.pack`: the framework's single-file sample store.

A dependency-free, mmap-friendly format for sequential reads and random
access by key, byte for byte the format of the JAX package's ``data/pack.py``
(either package reads the other's files):

    [ magic 'DCLRPAK1' (8B) ]
    [ record ]*                 -- raw value bytes, back to back
    [ index: n (u64) then per record: key_len u16, key utf-8,
      offset u64, length u64 ]
    [ index_offset u64 ][ magic 'DCLRPAK1' ]  -- fixed-size trailer

Values are encoded with a small typed binary codec (dicts of numpy arrays,
scalars, strings), self-describing and versioned by the magic.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["PackWriter", "PackReader", "encode_obj", "decode_obj"]

MAGIC = b"DCLRPAK1"

_T_NDARRAY = 1
_T_FLOAT = 2
_T_INT = 3
_T_STR = 4
_T_BOOL = 5
_T_DICT = 6
_T_LIST = 7
_T_NONE = 8
_T_BYTES = 9


def encode_obj(obj: Any, out: Optional[bytearray] = None) -> bytes:
    """Encode a python object tree into the typed binary format."""
    buf = out if out is not None else bytearray()

    def put(o):
        if isinstance(o, np.ndarray):
            o = np.ascontiguousarray(o)
            dt = o.dtype.str.encode()
            buf.append(_T_NDARRAY)
            buf.append(len(dt))
            buf.extend(dt)
            buf.append(o.ndim)
            buf.extend(struct.pack(f"<{o.ndim}q", *o.shape))
            buf.extend(o.tobytes())
        elif isinstance(o, (bool, np.bool_)):
            buf.append(_T_BOOL)
            buf.append(1 if o else 0)
        elif isinstance(o, (int, np.integer)):
            buf.append(_T_INT)
            buf.extend(struct.pack("<q", int(o)))
        elif isinstance(o, (float, np.floating)):
            buf.append(_T_FLOAT)
            buf.extend(struct.pack("<d", float(o)))
        elif isinstance(o, str):
            b = o.encode()
            buf.append(_T_STR)
            buf.extend(struct.pack("<I", len(b)))
            buf.extend(b)
        elif isinstance(o, bytes):
            buf.append(_T_BYTES)
            buf.extend(struct.pack("<Q", len(o)))
            buf.extend(o)
        elif isinstance(o, dict):
            buf.append(_T_DICT)
            buf.extend(struct.pack("<I", len(o)))
            for k, v in o.items():
                kb = str(k).encode()
                buf.extend(struct.pack("<H", len(kb)))
                buf.extend(kb)
                put(v)
        elif isinstance(o, (list, tuple)):
            buf.append(_T_LIST)
            buf.extend(struct.pack("<I", len(o)))
            for v in o:
                put(v)
        elif o is None:
            buf.append(_T_NONE)
        else:
            raise TypeError(f"Cannot encode type {type(o)}")

    put(obj)
    return bytes(buf) if out is None else b""


def decode_obj(data, offset: int = 0) -> Tuple[Any, int]:
    """Decode one object; returns (object, next_offset)."""

    def get(pos):
        t = data[pos]
        pos += 1
        if t == _T_NDARRAY:
            dtl = data[pos]
            pos += 1
            dt = np.dtype(bytes(data[pos:pos + dtl]).decode())
            pos += dtl
            ndim = data[pos]
            pos += 1
            shape = struct.unpack_from(f"<{ndim}q", data, pos)
            pos += 8 * ndim
            count = int(np.prod(shape))
            arr = np.frombuffer(data, dtype=dt, count=count, offset=pos).reshape(shape).copy()
            return arr, pos + count * dt.itemsize
        if t == _T_BOOL:
            return bool(data[pos]), pos + 1
        if t == _T_INT:
            return struct.unpack_from("<q", data, pos)[0], pos + 8
        if t == _T_FLOAT:
            return struct.unpack_from("<d", data, pos)[0], pos + 8
        if t == _T_STR:
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            return bytes(data[pos:pos + n]).decode(), pos + n
        if t == _T_BYTES:
            n = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
            return bytes(data[pos:pos + n]), pos + n
        if t == _T_DICT:
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            d = {}
            for _ in range(n):
                kl = struct.unpack_from("<H", data, pos)[0]
                pos += 2
                k = bytes(data[pos:pos + kl]).decode()
                pos += kl
                d[k], pos = get(pos)
            return d, pos
        if t == _T_LIST:
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            lst = []
            for _ in range(n):
                v, pos = get(pos)
                lst.append(v)
            return lst, pos
        if t == _T_NONE:
            return None, pos
        raise ValueError(f"Unknown type tag {t}")

    return get(offset)


class PackWriter:
    """Append-only writer; call close() (or use as context manager).  The
    file appears under its name only when closed."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path + ".tmp", "wb")
        self._f.write(MAGIC)
        self._index: List[Tuple[str, int, int]] = []

    def put(self, key: str, obj: Any) -> None:
        data = encode_obj(obj)
        offset = self._f.tell()
        self._f.write(data)
        self._index.append((key, offset, len(data)))

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        index_offset = self._f.tell()
        self._f.write(struct.pack("<Q", len(self._index)))
        for key, offset, length in self._index:
            kb = key.encode()
            self._f.write(struct.pack("<H", len(kb)))
            self._f.write(kb)
            self._f.write(struct.pack("<QQ", offset, length))
        self._f.write(struct.pack("<Q", index_offset))
        self._f.write(MAGIC)
        self._f.close()
        os.replace(self._path + ".tmp", self._path)

    def __enter__(self) -> "PackWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PackReader:
    """mmap-backed random-access reader; keys iterate in sorted order."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except BaseException:
            self._f.close()
            raise
        if self._mm[:8] != MAGIC or self._mm[-8:] != MAGIC:
            self.close()
            raise ValueError(f"Not a pack file: {path}")
        index_offset = struct.unpack_from("<Q", self._mm, len(self._mm) - 16)[0]
        n = struct.unpack_from("<Q", self._mm, index_offset)[0]
        pos = index_offset + 8
        self._index: Dict[str, Tuple[int, int]] = {}
        for _ in range(n):
            kl = struct.unpack_from("<H", self._mm, pos)[0]
            pos += 2
            key = self._mm[pos:pos + kl].decode()
            pos += kl
            offset, length = struct.unpack_from("<QQ", self._mm, pos)
            pos += 16
            self._index[key] = (offset, length)
        self._keys = sorted(self._index)

    @property
    def keys(self) -> List[str]:
        return self._keys

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __getitem__(self, key: str) -> Any:
        offset, _ = self._index[key]
        obj, _ = decode_obj(self._mm, offset)
        return obj

    def items(self) -> Iterator[Tuple[str, Any]]:
        for k in self._keys:
            yield k, self[k]

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self) -> "PackReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
