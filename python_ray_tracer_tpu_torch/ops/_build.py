"""Build and load the CUDA kernel library from the package's own sources.

``nvcc`` compiles ``csrc/*.cu`` into a shared library with a plain C
interface, loaded with ``ctypes``.  The library's file name carries a hash
of the sources and flags, so an edit rebuilds it; it lands in the
package's ``_build/`` directory at first use.  A missing ``nvcc`` or a
failed build raises: there is no fallback.

``--fmad=false`` is load-bearing: contracting ``a*b + c`` into an FMA
destroys the Dekker/Knuth error terms of the exact intersection tier that
the r = 99999 ground sphere depends on.  Fast math is never used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bounce_sub.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda); cannot build the kernels")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libprt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str, float]:
    """Compile the library unless it is already there.

    Returns ``(path, compiler log, build seconds)``; the log holds ptxas's
    per-kernel register and shared-memory report.  An existing library
    returns an empty log and 0 seconds.
    """
    out = library_path()
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, proc.stdout + proc.stderr, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.prt_error_string.argtypes = [ctypes.c_int]
    lib.prt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    """``cudaGetErrorString`` of a code an entry returned."""
    return load_library().prt_error_string(err).decode()
