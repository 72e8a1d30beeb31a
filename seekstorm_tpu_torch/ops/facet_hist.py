"""Facet histogram: kernel K3 (csrc/facet_hist.cu) and its plain PyTorch
version.

Replaces the facet counting of the reference's two lexical scans: the
histogram step of ``seekstorm_tpu/ops/wand.py::_scan_local`` (247-273) and
``seekstorm_tpu/ops/lexical.py::_facet_update`` (297-324), a bf16 one-hot
matmul over the unpacked match bits there (a scatter-add above 512 codes).

Here the match bits stay packed.  For P (row, block) pairs with matched
words ``mwords[p]`` (bit j of word i: doc i*32 + j of the pair's block
matched), and the facet codes in the global-block layout,

    out[f, p_row[p], clip(codes[f, p_blk[p]*BLOCK_SIZE + d], 0, fcm-1)] += 1

for every matched doc d and facet f: exact integer counts, with codes
clipped before counting as both reference forms clip them.  The WAND route
hands it K1's matched words viewed as ``[Bq*NBLK, NW]`` (``wand_pairs``),
the dense route K2's and the tf scan (``ops/lexical.tf_scan``) its own, both
with the pair list's blocks and rows.  The pairs may come in any order.
"""

from __future__ import annotations

import threading

import torch

from ..metrics import METRICS
from ..schema import BLOCK_SIZE
from .dense_scan import unpack_words
from .wand_scan import NW, _check

# pairs unpacked at a time by the plain version (64K bools a pair)
REF_CHUNK = 256

# launches of K3 since the last reset (the count a run reads to show that
# its faceted batches went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K3 launch: in LAUNCHES and in METRICS' k3_launches_total
    (a server's /metrics shows which kernels its requests ran)."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k3_launches_total")


def wand_pairs(n_rows: int, nblk: int, device):
    """(p_blk, p_row) i32[n_rows*nblk] of phase 1's matched words
    [n_rows, nblk*NW] viewed as [n_rows*nblk, NW]: pair p is block
    p % nblk of row p // nblk."""
    p = torch.arange(n_rows * nblk, dtype=torch.int32, device=device)
    return p % nblk, p // nblk


def facet_hist_ref(mwords, p_blk, p_row, codes, fcm: int, n_rows: int):
    """Plain PyTorch facet histogram.

    mwords i32[P, NW] matched words; p_blk / p_row i32[P] global block and
    output row of each pair; codes i32[NF, NBLK*BLOCK_SIZE].  Returns counts
    i32[NF, n_rows, fcm]."""
    NF = codes.shape[0]
    dev = mwords.device
    out = torch.zeros((NF, n_rows * fcm), dtype=torch.int64, device=dev)
    for a in range(0, mwords.shape[0], REF_CHUNK):
        pi, di = torch.nonzero(unpack_words(mwords[a:a + REF_CHUNK]),
                               as_tuple=True)
        if not len(pi):
            continue
        at = p_blk[a + pi].long() * BLOCK_SIZE + di
        base = p_row[a + pi].long() * fcm
        ones = torch.ones(len(pi), dtype=torch.int64, device=dev)
        for f in range(NF):
            out[f].index_add_(0, base + codes[f, at].clamp(0, fcm - 1).long(),
                              ones)
    return out.view(NF, n_rows, fcm).to(torch.int32)


def facet_hist_cuda(mwords, p_blk, p_row, codes, fcm: int, n_rows: int):
    """K3 on CUDA tensors: same contract as facet_hist_ref."""
    from .. import _build

    dev = mwords.device
    if mwords.dim() != 2 or codes.dim() != 2:
        raise ValueError("mwords and codes must be 2-d")
    P = mwords.shape[0]
    NF, ncode = codes.shape
    if fcm < 1 or n_rows < 1 or NF < 1:
        raise ValueError(f"K3 takes fcm, n_rows, NF >= 1, got {fcm}, "
                         f"{n_rows}, {NF}")
    if ncode == 0 or ncode % BLOCK_SIZE:
        raise ValueError(f"codes: expected a multiple of {BLOCK_SIZE} codes "
                         f"a facet, got {ncode}")
    _check("mwords", mwords, torch.int32, (P, NW), dev)
    _check("p_blk", p_blk, torch.int32, (P,), dev)
    _check("p_row", p_row, torch.int32, (P,), dev)
    _check("codes", codes, torch.int32, (NF, ncode), dev)
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {dev}")
    if mwords.data_ptr() % 16:      # K3 reads the words 16 bytes at a time
        raise ValueError("mwords must be 16-byte aligned")
    out = torch.zeros((NF, n_rows, fcm), dtype=torch.int32, device=dev)
    lib = _build.load("facet_hist")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    with torch.cuda.device(dev):
        err = lib.facet_hist_launch(
            mwords.data_ptr(), p_blk.data_ptr(), p_row.data_ptr(),
            codes.data_ptr(), ncode // BLOCK_SIZE, P, NF, fcm, n_rows,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"facet_hist_cuda launch failed (error {err})")
    return out


def facet_hist(mwords, p_blk, p_row, codes, fcm: int, n_rows: int):
    """The plain version for tensors on the CPU, K3 for CUDA tensors (a CUDA
    failure raises; there is no fallback)."""
    if mwords.device.type == "cpu":
        return facet_hist_ref(mwords, p_blk, p_row, codes, fcm, n_rows)
    if mwords.device.type == "cuda":
        return facet_hist_cuda(mwords, p_blk, p_row, codes, fcm, n_rows)
    raise ValueError(f"no facet histogram for device {mwords.device}")
