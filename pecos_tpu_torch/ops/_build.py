"""Build the CUDA kernels in ``csrc/*.cu`` at first use and load them with ctypes.

``nvcc`` compiles every source into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``pecos_tpu_torch/_build/``, rebuilt when the sources or the compiler change
(``utils.build_util``).  A missing ``nvcc`` or a failed build raises with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
from typing import Optional

from pecos_tpu_torch.utils.build_util import build_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpecos_tpu_torch_ops.so")
LOG_PATH = LIB_PATH + ".log"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, kept in LOG_PATH
]

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))


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
    return build_library(_find_nvcc, NVCC_FLAGS, _sources(), LIB_PATH, force)


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
