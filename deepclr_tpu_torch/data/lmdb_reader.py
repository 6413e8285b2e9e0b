"""Read-only LMDB file parser for reference-era datasets, with no lmdb or
msgpack package (the JAX package's ``data/lmdb_reader.py``).

The reference converts datasets with tensorpack's ``LMDBSerializer``: a
single-file LMDB environment whose entries are ``b"%08d" -> msgpack`` blobs
(numpy arrays in msgpack-numpy encoding) plus a ``b"__keys__"`` index
entry.  This module parses the on-disk LMDB B-tree directly (the layout of
liblmdb 0.9: meta pages, branch/leaf pages, overflow pages for values
larger than a page) and decodes msgpack with the reader of
``models/flax_msgpack.py``, so already-converted datasets can be moved to
``.pack`` files.

Format references: LMDB file format (mdb.c): 4096-byte pages; meta pages
at pgno 0/1 (pick the larger txnid); MDB_page header = pgno(8) pad(2)
flags(2) lower(2) upper(2); node pointer array of u16 offsets; leaf node =
lo(2) hi(2) flags(2) ksize(2) key data, data size = lo | hi<<16, F_BIGDATA
nodes store the overflow pgno instead of inline data.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from ..models.flax_msgpack import MsgpackReader

__all__ = ["LMDBFile", "decode_msgpack_numpy", "iter_reference_lmdb", "load_keys"]

_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_P_LEAF2 = 0x20
_F_BIGDATA = 0x01
_F_SUBDATA = 0x02
_MAGIC = 0xBEEFC0DE
_HDR = 16  # PAGEHDRSZ
_INVALID = 0xFFFFFFFFFFFFFFFF


class LMDBFile:
    """Iterate (key, value) pairs of a single-file LMDB environment."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = f.read()
        if len(self._data) < 2 * 4096:
            raise ValueError(f"{path}: too small to be an LMDB file")

        meta0 = self._parse_meta(0)
        meta1 = self._parse_meta(meta0["psize"])
        self._meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self._psize = self._meta["psize"]

    def _parse_meta(self, offset: int) -> Dict[str, int]:
        d = self._data
        magic, version = struct.unpack_from("<II", d, offset + 16)
        if magic != _MAGIC:
            raise ValueError(
                f"bad LMDB magic {magic:#x} at offset {offset + 16}"
            )
        if version not in (1,):  # MDB_DATA_VERSION
            raise ValueError(f"unsupported LMDB data version {version}")
        psize = struct.unpack_from("<I", d, offset + 40)[0]
        main_root = struct.unpack_from("<Q", d, offset + 128)[0]
        main_entries = struct.unpack_from("<Q", d, offset + 120)[0]
        txnid = struct.unpack_from("<Q", d, offset + 144)[0]
        return {"psize": psize, "root": main_root, "txnid": txnid,
                "entries": main_entries}

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """-> (offset, flags, lower, upper)."""
        off = pgno * self._psize
        flags, lower, upper = struct.unpack_from("<HHH", self._data, off + 10)
        return off, flags, lower, upper

    def _overflow_data(self, pgno: int, size: int) -> bytes:
        off = pgno * self._psize
        flags = struct.unpack_from("<H", self._data, off + 10)[0]
        if not flags & _P_OVERFLOW:
            raise ValueError(f"page {pgno} is not an overflow page")
        start = off + _HDR
        return self._data[start:start + size]

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags, lower, upper = self._page(pgno)
        n = (lower - _HDR) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._data, off + _HDR)

        if flags & _P_BRANCH:
            for p in ptrs:
                lo, hi, nflags = struct.unpack_from("<HHH", self._data, off + p)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            return
        if not flags & _P_LEAF or flags & _P_LEAF2:
            raise ValueError(f"unsupported page flags {flags:#x} (pgno {pgno})")

        for p in ptrs:
            node = off + p
            lo, hi, nflags, ksize = struct.unpack_from(
                "<HHHH", self._data, node
            )
            key = self._data[node + 8:node + 8 + ksize]
            dsize = lo | (hi << 16)
            if nflags & _F_SUBDATA:
                raise ValueError("sub-databases/dupsort are not supported")
            if nflags & _F_BIGDATA:
                ovpg = struct.unpack_from(
                    "<Q", self._data, node + 8 + ksize
                )[0]
                value = self._overflow_data(ovpg, dsize)
            else:
                dstart = node + 8 + ksize
                value = self._data[dstart:dstart + dsize]
            yield key, value

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._meta["root"] == _INVALID:
            return
        yield from self._iter_page(self._meta["root"])

    def __len__(self) -> int:
        return int(self._meta["entries"])


class _NumpyReader(MsgpackReader):
    """msgpack in the msgpack package's raw mode (strings come back as
    bytes), with msgpack-numpy's arrays: maps {b'nd': True, b'type',
    b'shape', b'data'} become arrays, {b'nd': False, ...} numpy scalars."""

    def text(self, n: int) -> bytes:
        return self.take(n)

    def finish_map(self, obj: dict) -> Any:
        if obj.get(b"nd") is True:
            return np.frombuffer(obj[b"data"], dtype=np.dtype(obj[b"type"])).reshape(obj[b"shape"]).copy()
        if obj.get(b"nd") is False:
            return np.frombuffer(obj[b"data"], dtype=np.dtype(obj[b"type"]))[0]
        return obj

    def ext(self, n: int) -> Any:
        raise ValueError("msgpack-numpy: unexpected extension type")


def decode_msgpack_numpy(blob: bytes) -> Any:
    """msgpack decode with msgpack-numpy conventions (tensorpack ``loads``),
    as ``msgpack.unpackb(blob, raw=True, strict_map_key=False)`` with
    msgpack-numpy's object hook decodes it."""
    return _NumpyReader(blob).read_all()


def _denumpy(obj: Any) -> Any:
    """Recursively turn msgpack byte keys into str and leave arrays alone."""
    if isinstance(obj, dict):
        return {
            (k.decode() if isinstance(k, bytes) else k): _denumpy(v)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [_denumpy(v) for v in obj]
    return obj


def iter_reference_lmdb(path: str) -> Iterator[Tuple[str, Any]]:
    """(key, sample) pairs of a tensorpack-LMDBSerializer dataset, sorted by
    key, skipping the ``__keys__`` index entry; sample dict keys decoded to
    str (msgpack raw mode keeps them as bytes)."""
    entries = [
        (k, v) for k, v in LMDBFile(path).items() if k != b"__keys__"
    ]
    entries.sort(key=lambda kv: kv[0])
    for k, v in entries:
        yield k.decode(), _denumpy(decode_msgpack_numpy(v))


def load_keys(path: str) -> List[str]:
    """The dataset's key list (from __keys__ when present)."""
    for k, v in LMDBFile(path).items():
        if k == b"__keys__":
            keys = decode_msgpack_numpy(v)
            return [x.decode() if isinstance(x, bytes) else x for x in keys]
    return [k for k, _ in iter_reference_lmdb(path)]
