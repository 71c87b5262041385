"""Memory-mapped value stores: a 2-D float32 table and variable-length byte strings.

The port of ``pecos_tpu/utils/mmap_valstore_util.py`` over the port's host
core (``pecos_tpu_torch/core``, ``csrc/mmap_store.cpp``).  The file format is
the JAX package's, so a store written by either package opens in the other,
eagerly or with ``lazy=True`` (pages are read on first touch).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from pecos_tpu_torch.core import load_library

_u64p = ctypes.POINTER(ctypes.c_uint64)
_fp = ctypes.POINTER(ctypes.c_float)


class _Store(object):
    """One native store, reached through the C functions ``mvs_<kind>_*``
    and freed with this object."""

    kind = ""

    def __init__(self, ptr):
        self._lib = load_library()
        self._ptr = ptr

    def _c(self, name):
        return getattr(self._lib, f"mvs_{self.kind}_{name}")

    def save(self, path: str):
        if self._c("save")(self._ptr, path.encode()) != 0:
            raise IOError(f"cannot save {type(self).__name__} to {path}")

    @classmethod
    def load(cls, path: str, lazy: bool = False):
        ptr = getattr(load_library(), f"mvs_{cls.kind}_load")(path.encode(), int(lazy))
        if not ptr:
            raise IOError(f"cannot load {cls.__name__} from {path}")
        return cls(ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._c("free")(self._ptr)


class Float32Store(_Store):
    """2-D float32 store with threaded batch gathers."""

    kind = "f32"

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Float32Store":
        arr = np.ascontiguousarray(arr, np.float32)
        return cls(load_library().mvs_f32_new(arr.shape[0], arr.shape[1], arr.ctypes.data_as(_fp)))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._c("rows")(self._ptr), self._c("cols")(self._ptr))

    def batch_get(self, rows: np.ndarray, cols: np.ndarray, threads: int = -1) -> np.ndarray:
        """The values at (rows[i], cols[i])."""
        rows = np.ascontiguousarray(rows, np.uint64)
        cols = np.ascontiguousarray(cols, np.uint64)
        out = np.empty(len(rows), np.float32)
        self._c("batch_get")(self._ptr, len(rows), rows.ctypes.data_as(_u64p), cols.ctypes.data_as(_u64p), out.ctypes.data_as(_fp), threads)
        return out

    def get_rows(self, rows: np.ndarray, threads: int = -1) -> np.ndarray:
        rows = np.ascontiguousarray(rows, np.uint64)
        out = np.empty((len(rows), self.shape[1]), np.float32)
        self._c("get_rows")(self._ptr, len(rows), rows.ctypes.data_as(_u64p), out.ctypes.data_as(_fp), threads)
        return out


class BytesStore(_Store):
    """Variable-length byte-string store with truncating batch reads."""

    kind = "bytes"

    @classmethod
    def from_list(cls, strs: Sequence) -> "BytesStore":
        bstrs = [s.encode() if isinstance(s, str) else s for s in strs]
        lens = np.array([len(s) for s in bstrs], np.uint64)
        ptrs = (ctypes.c_char_p * len(bstrs))(*bstrs)
        return cls(load_library().mvs_bytes_new(len(bstrs), ptrs, lens.ctypes.data_as(_u64p)))

    @property
    def nr_rows(self) -> int:
        return self._c("rows")(self._ptr)

    def batch_get(self, rows: np.ndarray, trunc_len: int = 256, threads: int = -1):
        """The strings of ``rows``, each cut to at most ``trunc_len`` bytes."""
        rows = np.ascontiguousarray(rows, np.uint64)
        buf = ctypes.create_string_buffer(len(rows) * trunc_len)
        lens = np.empty(len(rows), np.uint64)
        self._c("batch_get")(self._ptr, len(rows), rows.ctypes.data_as(_u64p), buf, trunc_len, lens.ctypes.data_as(_u64p), threads)
        raw = buf.raw
        return [raw[i * trunc_len : i * trunc_len + int(n)] for i, n in enumerate(lens)]
