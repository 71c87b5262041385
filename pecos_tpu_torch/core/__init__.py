"""The native host core: the TF-IDF tokenizer, the mmap stores and the PIFA
SpGEMM, in C++.

``csrc/tokenizer.cpp``, ``csrc/mmap_store.cpp`` and ``csrc/spgemm.cpp`` are the
port's own copies of the JAX package's host sources; they fix the token rule,
the FNV-1a hashes, the store byte layout and the order of the sparse
product's float32 sums, so vocabularies and stores written by either package
open in the other and both give PIFA bit for bit.  ``g++`` builds them at
first use into one shared library under ``pecos_tpu_torch/_build/``, rebuilt
when they or the compiler change
(``utils.build_util``, as for the CUDA kernels).  A failed build raises with
the compiler's output; no caller falls back to a Python path.

:func:`load_library` declares every C signature once, so the modules above it
(``utils/mmap_hashmap_util.py``, ``utils/mmap_valstore_util.py``,
``utils/spgemm_util.py`` and the tokenizer bridge in
``utils/featurization/text/vectorizers.py``) only pass buffers.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
from typing import Optional

from pecos_tpu_torch.utils.build_util import build_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "core", "csrc")
LIB_PATH = os.path.join(_PKG_DIR, "_build", "libpecos_tpu_torch_core.so")
# std::thread, not OpenMP: a g++ without libgomp cannot link -fopenmp (csrc/parallel.h)
CXX_FLAGS = ["-shared", "-fPIC", "-O3", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None


def _sources(pattern: str = "*.cpp"):
    return sorted(glob.glob(os.path.join(_CSRC_DIR, pattern)))


def _find_cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH (or $CXX); the host core of pecos_tpu_torch "
            "(tokenizer, mmap stores and SpGEMM) is built from source at first use"
        )
    return cxx


def build(force: bool = False) -> float:
    """Compile the host core if the library is missing or its sources changed.
    Returns the seconds spent compiling (0.0 when the library was current)."""
    return build_library(_find_cxx, CXX_FLAGS, _sources(), LIB_PATH, force, headers=_sources("*.h"))


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every function of the C API."""
    vp, cp, ci = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    u64, i64 = ctypes.c_uint64, ctypes.c_int64
    u64p, i64p = ctypes.POINTER(u64), ctypes.POINTER(i64)
    i32p, fp = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    sigs = {
        # tokenizer.cpp
        "tok_count": (vp, [cp, i64p, i64, ci, ci, ci, i64, ci]),
        "tok_nnz": (i64, [vp]),
        "tok_n_unique": (i64, [vp]),
        "tok_str_blob_size": (i64, [vp]),
        "tok_fill": (None, [vp, i64p, u64p, i32p]),
        "tok_fill_strings": (None, [vp, cp, i64p, u64p, i64p]),
        "tok_free": (None, [vp]),
        "tok_hash_strings": (None, [cp, i64p, i64, u64p]),
        "tok_sort_order": (None, [cp, i64p, i64p, i64, i64p]),
        "tok_lookup_build": (vp, [u64p, i64]),
        "tok_lookup": (None, [vp, u64p, i64, i64p]),
        "tok_lookup_free": (None, [vp]),
        # mmap_store.cpp: hashmaps
        "mhm_i2i_new": (vp, [u64]),
        "mhm_i2i_free": (None, [vp]),
        "mhm_i2i_insert": (None, [vp, u64, i64]),
        "mhm_i2i_get": (i64, [vp, u64, i64]),
        "mhm_i2i_size": (u64, [vp]),
        "mhm_i2i_batch_get": (None, [vp, u64, u64p, i64, i64p, ci]),
        "mhm_i2i_save": (ci, [vp, cp]),
        "mhm_i2i_load": (vp, [cp, ci]),
        "mhm_s2i_new": (vp, [u64]),
        "mhm_s2i_free": (None, [vp]),
        "mhm_s2i_insert": (None, [vp, cp, u64, i64]),
        "mhm_s2i_get": (i64, [vp, cp, u64, i64]),
        "mhm_s2i_size": (u64, [vp]),
        "mhm_s2i_batch_get": (None, [vp, u64, ctypes.POINTER(cp), u64p, i64, i64p, ci]),
        "mhm_s2i_save": (ci, [vp, cp]),
        "mhm_s2i_load": (vp, [cp, ci]),
        "mhm_fs2i_new": (vp, [u64, u64]),
        "mhm_fs2i_free": (None, [vp]),
        "mhm_fs2i_insert": (None, [vp, cp, i64]),
        "mhm_fs2i_get": (i64, [vp, cp, i64]),
        "mhm_fs2i_size": (u64, [vp]),
        "mhm_fs2i_key_len": (u64, [vp]),
        "mhm_fs2i_batch_get": (None, [vp, u64, cp, i64, i64p, ci]),
        "mhm_fs2i_save": (ci, [vp, cp]),
        "mhm_fs2i_load": (vp, [cp, ci]),
        # mmap_store.cpp: value stores
        "mvs_f32_new": (vp, [u64, u64, fp]),
        "mvs_f32_free": (None, [vp]),
        "mvs_f32_rows": (u64, [vp]),
        "mvs_f32_cols": (u64, [vp]),
        "mvs_f32_batch_get": (None, [vp, u64, u64p, u64p, fp, ci]),
        "mvs_f32_get_rows": (None, [vp, u64, u64p, fp, ci]),
        "mvs_f32_save": (ci, [vp, cp]),
        "mvs_f32_load": (vp, [cp, ci]),
        "mvs_bytes_new": (vp, [u64, ctypes.POINTER(cp), u64p]),
        "mvs_bytes_free": (None, [vp]),
        "mvs_bytes_rows": (u64, [vp]),
        "mvs_bytes_batch_get": (None, [vp, u64, u64p, cp, u64, u64p, ci]),
        "mvs_bytes_save": (ci, [vp, cp]),
        "mvs_bytes_load": (vp, [cp, ci]),
        # spgemm.cpp
        "spgemm_atb": (vp, [i64, i64, i64, i64p, i32p, fp, i64p, i32p, fp, ci]),
        "spgemm_nnz": (i64, [vp]),
        "spgemm_fill": (None, [vp, i64p, i32p, fp]),
        "spgemm_free": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load_library() -> ctypes.CDLL:
    """The host core's shared library, built if needed, with every C signature declared."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        _declare(lib)
        _lib = lib
    return _lib
