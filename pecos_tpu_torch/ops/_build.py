"""Build the CUDA kernels in ``csrc/*.cu`` at first use and load them with ctypes.

``nvcc`` compiles every source into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``pecos_tpu_torch/_build/``.  A content hash of the sources is stored beside
the library and a changed hash triggers a rebuild (git checkouts do not keep
mtimes).  A missing ``nvcc`` or a failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpecos_tpu_torch_ops.so")
_HASH_PATH = LIB_PATH + ".srchash"
LOG_PATH = LIB_PATH + ".log"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, kept in LOG_PATH
]

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return h.hexdigest()


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default /usr/local/cuda); "
        "the CUDA kernels of pecos_tpu_torch are built from source at first use"
    )


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or its sources changed.
    Returns the seconds spent compiling (0.0 when the library was current)."""
    want = _source_hash()
    have = None
    if os.path.exists(_HASH_PATH):
        with open(_HASH_PATH) as f:
            have = f.read().strip()
    if not force and have == want and os.path.exists(LIB_PATH):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    with open(LOG_PATH, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees the old or the new file
    with open(_HASH_PATH, "w") as f:
        f.write(want)
    return seconds


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with every C signature declared."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # qids, qvals, table, R, rows (None: the block form), out; K, P, Qn,
        # chunk, log2_slots, lanes, per_block, blocks_per_row, grid,
        # shared_bytes, has_bias, bias_id; bias_val; stream
        lib.pecos_intersect_scores.argtypes = [
            vp, vp, vp, ctypes.c_int64, vp, vp, *([ci] * 12), ctypes.c_float, vp
        ]
        lib.pecos_intersect_scores.restype = ci
        lib.pecos_cuda_error_string.argtypes = [ci]
        lib.pecos_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
