"""Build and load the CUDA kernel libraries from the package's own sources.

``nvcc`` compiles each ``csrc/*.cu`` source into its own shared library
with a plain C interface, loaded with ``ctypes``; :func:`build_all` starts
one ``nvcc`` per source, all at once.  A library's file name carries a hash
of its source, the ``csrc/*.cuh`` headers and the flags, so an edit
rebuilds it; it lands in the
package's ``_build/`` directory at first use.  A missing ``nvcc`` or a
failed build raises: there is no fallback.

The sources include one generated header, ``texture_coeffs.cuh`` (the
polynomial UV's coefficients, :func:`.texture.cuda_header`), written into
``_build/include/`` before ``nvcc`` runs, so the coefficients have one
source in the repository.

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

import torch

from . import texture

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENERATED = BUILD_DIR / "include"
SOURCES = (
    "bounce_sub.cu", "bounce_smooth_sub.cu", "culled.cu", "culled_smooth.cu", "intersect_fused.cu", "bounce_lane.cu",
)
# Shared memory one block may use on Hopper (227 KB; above 48 KB only as
# dynamic shared memory, which the kernels opt in to).
MAX_SHARED_BYTES = 232_448
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


def library_path(source: str) -> Path:
    """Where the library of ``source`` lives for its current text, the text
    of every header under ``csrc/`` (a source may include any of them) and
    the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(texture.cuda_header().encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libprt_{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def write_generated_header() -> Path:
    """Write ``texture_coeffs.cuh`` into :data:`GENERATED` (atomically: several
    builds may run at once); returns the directory to pass as ``-I``."""
    GENERATED.mkdir(parents=True, exist_ok=True)
    target = GENERATED / "texture_coeffs.cuh"
    text = texture.cuda_header()
    if not target.exists() or target.read_text() != text:
        tmp = target.with_name(f"texture_coeffs.{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, target)
    return GENERATED


def build_all(sources: tuple[str, ...] = SOURCES) -> dict[str, tuple[Path, str, float]]:
    """Compile every library that is not there yet, one ``nvcc`` per source,
    all running at once.

    Returns ``{source: (path, compiler log, build seconds)}``; the log holds
    ptxas's per-kernel register, shared-memory and spill report.  An
    existing library returns an empty log and 0 seconds.
    """
    results: dict[str, tuple[Path, str, float]] = {}
    running = []
    include = write_generated_header()
    for source in sources:
        out = library_path(source)
        if out.exists():
            results[source] = (out, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(include), "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc, time.perf_counter()))
    failures = []
    for source, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {source} failed with code {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        results[source] = (out, log, seconds)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build ``source`` if needed, then load its library once per process."""
    path, _, _ = build_all((source,))[source]
    lib = ctypes.CDLL(str(path))
    lib.prt_error_string.argtypes = [ctypes.c_int]
    lib.prt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _entry(source: str, name: str, dtype: torch.dtype, signature: str):
    """The C entry ``prt_<name>_<f32|f64>`` of ``source`` with its argtypes:
    one code per argument before the trailing stream, p = pointer, i = int,
    r = the dtype's real."""
    lib = load_library(source)
    real = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    codes = {"p": ctypes.c_void_p, "i": ctypes.c_int, "r": real}
    fn = getattr(lib, f"prt_{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [codes[c] for c in signature] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(source: str, name: str, signature: str, dtype: torch.dtype, *args) -> None:
    """Launch entry ``name`` of ``source`` on the current stream (tensors go
    as their data pointers); raise on the CUDA error the entry returns."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = _entry(source, name, dtype, signature)(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        message = load_library(source).prt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {message} ({err})")
