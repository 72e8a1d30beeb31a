"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled with plain ``nvcc`` into a shared
library of its own with a C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The sources build side by side,
one ``nvcc`` each, all started together, at first use into ``build/kernels/``
at the repository root.  Each library is keyed by a hash of its source and
the flags (and of the shared headers ``csrc/*.cuh``), so an edited source
rebuilds and an unchanged one loads the library already built.

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
_LIBS: dict[str, ctypes.CDLL] = {}
# what the last build in this process took and what ptxas reported
# (registers, shared memory, spills per kernel); None when every library
# was loaded from an earlier build
BUILD_SECONDS: float | None = None
BUILD_LOG: str | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# per source under csrc/: its C entry points and their argument types
_SIGNATURES = {
    "wand_scan": {
        # ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid, Bq, nblk,
        # T, with_counts, allub, ub4, ub16, g1, cnt, mwords, stream
        "wand_scan_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "dense_scan": {
        # docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off, s_len,
        # s_bm, s_w, s_flag, P, T, out, cnt, mwords, stream
        "dense_scan_launch": [_P] * 13 + [_I, _I, _P, _P, _P, _P],
        # the same inputs, P, T, kk, split, vals, docs, cnt, mwords, stream
        "dense_topk_launch": [_P] * 13 + [_I] * 4 + [_P] * 5,
    },
    "facet_hist": {
        # mwords, p_blk, p_row, codes, nblk, P, NF, fcm, R, out, stream
        "facet_hist_launch": [_P] * 4 + [_I] * 5 + [_P, _P],
    },
    "vector_scan": {
        # data, scale, zp, qsum, norm2, docid, fieldid, deleted, n_deleted,
        # field_ok, n_field, tile_ids, NT, q_data, q_scale, q_zp, q_qsum,
        # q_norm2, score_min, B, d, k, quantized, euclidean, use_ff,
        # with_counts, gathered, G, list_v, list_p, gthr, P, merge_scratch,
        # out_vals, out_rows, counts, stream
        "vector_scan_launch": [_P] * 8 + [_I, _P, _I, _P, _I] + [_P] * 6
        + [_I] * 9 + [_P] * 3 + [_I] + [_P] * 5,
    },
    "wand_rescore": {
        # ppool, rpool, ipool, n_imp, sp_prow, sp_ioff, delw, sid, filtw,
        # slotmap, tslot, treq, tneg, wshard, ids, vals, nblk, Bq, T, K,
        # bucket_off, psc, plane, n_ge, found, stream
        "rescore_page_launch": [_P] * 3 + [_I] + [_P] * 12 + [_I] * 5
        + [_P] * 5,
        # the same pools and tables up to wshard, nblk, Bq, T, nsplit,
        # c_psc, c_plane, part_sc, part_lane, part_found, psc, plane, found,
        # stream
        "exact_fold_launch": [_P] * 3 + [_I] + [_P] * 10 + [_I] * 4
        + [_P] * 9,
    },
    "wand_rungs": {
        # allub, g1, ub4, ub16, L1, Bq, out_vals, out_ids, stream
        "wand_rungs_launch": [_P] * 4 + [_I, _I] + [_P] * 3,
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source that has no library yet, one nvcc each, all
    started together.  Returns {name: library path}."""
    global BUILD_SECONDS, BUILD_LOG
    outs = {name: library_path(name) for name in _SIGNATURES}
    todo = [name for name, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = {name: p.communicate()[1] for name, (_, p) in procs.items()}
    for name, (tmp, p) in procs.items():
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc {name}.cu failed ({p.returncode}):\n{logs[name]}")
        os.replace(tmp, outs[name])
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "".join(logs.values())
    return outs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``; the first call builds every
    library not built yet."""
    with _LOCK:
        if not _LIBS:
            for src, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in _SIGNATURES[src].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIBS[src] = lib
        return _LIBS[name]
