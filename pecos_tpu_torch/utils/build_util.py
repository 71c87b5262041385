"""Build a shared library from sources at first use, again when they change.

The compiler (its resolved path and its ``--version`` output), the flags and
the sources' names and bytes are hashed into ``<library>.srchash`` beside the
library (git checkouts do not keep mtimes); a changed hash triggers a
rebuild, so a library copied from a machine with another compiler is built
again.  The compiler's output is kept in ``<library>.log``.  A failed build
raises with that output; no caller falls back to another path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from typing import Callable, Sequence


def build_library(
    find_compiler: Callable[[], str],
    flags: Sequence[str],
    sources: Sequence[str],
    lib_path: str,
    force: bool = False,
    headers: Sequence[str] = (),
) -> float:
    """Compile ``sources`` with ``flags`` into ``lib_path`` if the library is
    missing or its hash (of the compiler, the flags, sources and ``headers``)
    changed; ``find_compiler`` returns the compiler's path or raises.
    Returns the seconds spent compiling (0.0 when the library was current)."""
    compiler = find_compiler()
    version = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    h = hashlib.sha256(f"{os.path.realpath(compiler)}\n{version.stdout}\n".encode())
    h.update(" ".join(flags).encode())
    for src in (*sources, *headers):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    want = h.hexdigest()
    hash_path = lib_path + ".srchash"
    if not force and os.path.exists(lib_path) and os.path.exists(hash_path):
        with open(hash_path) as f:
            if f.read().strip() == want:
                return 0.0
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, *sources, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    with open(lib_path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees the old or the new file
    with open(hash_path, "w") as f:
        f.write(want)
    return seconds
