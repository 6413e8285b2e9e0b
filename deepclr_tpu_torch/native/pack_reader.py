"""ctypes binding of the native mmap ``.pack`` reader (csrc/host/pack_reader.cpp).

An alternative to ``data.pack.PackReader`` for the host data path: a
record's bytes come out of the mmap without a copy; decoding stays in
``data.pack.decode_obj``.
"""
from __future__ import annotations

import ctypes
from typing import Any, List

from ..data.pack import decode_obj
from . import load_library

__all__ = ["NativePackReader"]


class NativePackReader:
    """The reading API of ``data.pack.PackReader``, backed by C++."""

    def __init__(self, path: str):
        self._handle = None
        lib = load_library("pack_reader")
        lib.pack_open.restype = ctypes.c_void_p
        lib.pack_open.argtypes = [ctypes.c_char_p]
        lib.pack_count.restype = ctypes.c_long
        lib.pack_count.argtypes = [ctypes.c_void_p]
        lib.pack_key.restype = ctypes.c_long
        lib.pack_key.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        lib.pack_get.restype = ctypes.c_long
        lib.pack_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
        lib.pack_close.argtypes = [ctypes.c_void_p]
        self._lib = lib

        self._handle = lib.pack_open(path.encode())
        if not self._handle:
            raise ValueError(f"Not a pack file: {path}")
        buf = ctypes.create_string_buffer(512)
        self._keys: List[str] = []
        for i in range(lib.pack_count(self._handle)):
            lib.pack_key(self._handle, i, buf, len(buf))
            self._keys.append(buf.value.decode())
        self._key_set = set(self._keys)

    @property
    def keys(self) -> List[str]:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._key_set

    def __getitem__(self, key: str) -> Any:
        ptr = ctypes.POINTER(ctypes.c_ubyte)()
        length = self._lib.pack_get(self._handle, key.encode(), ctypes.byref(ptr))
        if length < 0:
            raise KeyError(key)
        obj, _ = decode_obj(bytes(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_ubyte * length)).contents))
        return obj

    def items(self):
        for k in self._keys:
            yield k, self[k]

    def close(self) -> None:
        if self._handle:
            self._lib.pack_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativePackReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
