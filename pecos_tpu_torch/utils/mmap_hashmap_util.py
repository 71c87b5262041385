"""Memory-mapped hashmaps: int2int, str2int and fixed-length str2int.

The port of ``pecos_tpu/utils/mmap_hashmap_util.py`` over the port's host core
(``pecos_tpu_torch/core``, ``csrc/mmap_store.cpp``).  The file format is the
JAX package's, so a map written by either package opens in the other, eagerly
(``"r"``) or lazily (``"r_lazy"``: pages are read on first touch).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from pecos_tpu_torch.core import load_library

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


class _Map:
    """One native map, reached through the C functions ``mhm_<kind>_*``."""

    kind = ""

    def __init__(self, lib, ptr, writable: bool = True):
        self._lib, self._ptr, self.writable, self.path = lib, ptr, writable, None

    def _c(self, name):
        return getattr(self._lib, f"mhm_{self.kind}_{name}")

    def _writing(self, what: str) -> None:
        if not self.writable:
            raise RuntimeError(f"map opened read-only; {what} requires mode='w'")

    def __getitem__(self, key) -> int:
        return self.get(key)

    def size(self) -> int:
        return self._c("size")(self._ptr)

    def save(self, path: str):
        self._writing("save")
        if self._c("save")(self._ptr, path.encode()) != 0:
            raise IOError(f"cannot save map to {path}")

    def free(self):
        self._c("free")(self._ptr)
        self._ptr = None

    def _batch(self, n: int, *keys, default: int, threads: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        self._c("batch_get")(self._ptr, n, *keys, default, out.ctypes.data_as(_i64p), threads)
        return out


class _I2I(_Map):
    kind = "i2i"

    def insert(self, key: int, val: int):
        self._writing("insert")
        self._c("insert")(self._ptr, key, val)

    def get(self, key: int, default: int = -1) -> int:
        return self._c("get")(self._ptr, key, default)

    def batch_get(self, keys: np.ndarray, default: int = -1, threads: int = -1) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        return self._batch(len(keys), keys.ctypes.data_as(_u64p), default=default, threads=threads)


class _S2I(_Map):
    kind = "s2i"

    def insert(self, key, val: int):
        self._writing("insert")
        key = _key(key)
        self._c("insert")(self._ptr, key, len(key), val)

    def get(self, key, default: int = -1) -> int:
        key = _key(key)
        return self._c("get")(self._ptr, key, len(key), default)

    def batch_get(self, keys: Sequence, default: int = -1, threads: int = -1) -> np.ndarray:
        bkeys = [_key(k) for k in keys]
        lens = np.array([len(k) for k in bkeys], np.uint64)
        ptrs = (ctypes.c_char_p * len(bkeys))(*bkeys)
        return self._batch(len(bkeys), ptrs, lens.ctypes.data_as(_u64p), default=default, threads=threads)


class _FS2I(_Map):
    """Fixed-length keys: every key has exactly ``key_len`` bytes, stored
    inline with the buckets, and a batch get takes one packed buffer."""

    kind = "fs2i"

    def __init__(self, lib, ptr, writable: bool = True):
        super().__init__(lib, ptr, writable)
        self.key_len = int(lib.mhm_fs2i_key_len(ptr))

    def _check(self, key) -> bytes:
        key = _key(key)
        if len(key) != self.key_len:
            raise ValueError(f"fstr2int key must be exactly {self.key_len} bytes, got {len(key)}")
        return key

    def insert(self, key, val: int):
        self._writing("insert")
        self._c("insert")(self._ptr, self._check(key), val)

    def get(self, key, default: int = -1) -> int:
        return self._c("get")(self._ptr, self._check(key), default)

    def batch_get(self, keys, default: int = -1, threads: int = -1) -> np.ndarray:
        """keys: a sequence of key_len-byte keys, or one packed bytes buffer."""
        packed = bytes(keys) if isinstance(keys, (bytes, bytearray)) else b"".join(self._check(k) for k in keys)
        if len(packed) % self.key_len:
            raise ValueError("packed buffer length is not a multiple of key_len")
        return self._batch(len(packed) // self.key_len, packed, default=default, threads=threads)


_MAPS = {"int2int": _I2I, "str2int": _S2I, "fstr2int": _FS2I}


class MmapHashmap(object):
    """str2int / fstr2int / int2int hashmap with w / r / r_lazy open modes."""

    def __init__(self, map_type: str, key_len: Optional[int] = None):
        if map_type not in _MAPS:
            raise ValueError(f"unknown map_type {map_type!r}")
        self.map_type = map_type
        self.key_len = key_len
        self.map: Optional[_Map] = None
        self.mode: Optional[str] = None
        self._lib = load_library()

    def open(self, mode: str, map_dir_or_path: str):
        cls = _MAPS[self.map_type]
        if mode == "w":
            if cls is _FS2I and not self.key_len:
                raise ValueError("fstr2int mode='w' requires key_len")
            new = getattr(self._lib, f"mhm_{cls.kind}_new")
            self.map = cls(self._lib, new(16, self.key_len) if cls is _FS2I else new(16))
            self.map.path = map_dir_or_path
        elif mode in ("r", "r_lazy"):
            ptr = getattr(self._lib, f"mhm_{cls.kind}_load")(map_dir_or_path.encode(), int(mode == "r_lazy"))
            if not ptr:
                raise IOError(f"cannot load {self.map_type} map from {map_dir_or_path}")
            self.map = cls(self._lib, ptr, writable=False)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if cls is _FS2I:
            self.key_len = self.map.key_len
        self.mode = mode
        return self

    def close(self):
        if self.map is not None:
            if self.mode == "w":
                self.map.save(self.map.path)
            self.map.free()
            self.map = None
