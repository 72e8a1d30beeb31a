"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with plain ``nvcc`` into one shared
library with a C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build runs at first use into
``build/kernels/`` at the repository root, keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
library already built.

Pointers and the stream cross the boundary as ``ctypes.c_void_p``; every C
entry point returns ``cudaGetLastError()`` after its launch and the Python
wrapper raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# what the last build in this process took and what ptxas reported
# (registers, shared memory, spills per kernel); None when loaded from
# an earlier build
BUILD_SECONDS: float | None = None
BUILD_LOG: str | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid, Bq, nblk, T,
    # with_counts, allub, cnt, stream
    "wand_scan_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libseekstorm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library (no-op when it exists)."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = res.stderr
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
