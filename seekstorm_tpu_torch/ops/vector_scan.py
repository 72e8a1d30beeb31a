"""The committed vector scan on CUDA: kernel K4 (csrc/vector_scan.cu), the
scan and the merge of its lists in one call.

Replaces ``seekstorm_tpu/ops/vector.py::vector_scan_topk`` (74-157), whose
plain PyTorch form is ``ops/vector.vector_scan_ref``.  The [B, NT*256]
score matrix never reaches device memory.  For pages up to 32 (kk <= 32)
a persistent grid of G CTAs a block of 64 queries each walks a contiguous
slot range on the s8 tensor cores and keeps each query's top 32 of it by
(score desc, position asc), skipping rows that a threshold the CTAs share
proves out of the top k (a probe pass over each range's first slot sets
it); deeper pages take the per-tile scan (each tile's top min(k, 256)).
A last launch merges each query's sorted lists into its top k, which is
``lax.top_k``'s order: ties keep the lower position
(``ops/vector.vector_scan_split_ref`` is the plain form of that split).
One call is one K4 launch in ``LAUNCHES``, whatever it enqueues.
"""

from __future__ import annotations

import threading

import torch

from ..metrics import METRICS
from ..utils import ceil_pow2
from .vector import gathered_order
from .wand_scan import _check

TILE = 256
RUN_KK = 32             # deepest page of the running scan
RUN_QUERIES = 64        # queries a CTA of the running scan
MERGE_SMEM_P = 4096     # largest running top-P the merge keeps on chip

# launches of K4 (scan and merge together) since the last reset (the count
# a run reads to show that its vector batches went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K4 launch: in LAUNCHES and in METRICS' k4_launches_total
    (a server's /metrics shows which kernels its requests ran)."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k4_launches_total")


def n_ranges(NT: int, B: int, k: int, n_sm: int) -> int:
    """G, the running scan's slot ranges a block of 64 queries: about one
    CTA an SM over the batch's query blocks, at most one range a slot and
    256 in all (the ranges' best keys a query fit one warp's sort); 0 (the
    per-tile scan) for pages deeper than 32."""
    if k > RUN_KK:
        return 0
    blocks = -(-B // RUN_QUERIES)
    return min(NT, 256, max(1, n_sm // blocks))


def vector_scan_cuda(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                     row_field, deleted, tile_ids, field_ok, q_data, q_scale,
                     q_zp, q_qsum, q_norm2, score_min, *, k: int,
                     quantized: bool, euclidean: bool, with_counts: bool,
                     exhaustive: bool, use_field_filter: bool,
                     pool_tiles: int = 0):
    """K4 on CUDA tensors: same contract as vector_scan_ref."""
    from .. import _build

    dev = data.device
    if data.dim() != 3 or data.shape[1] != TILE or data.shape[2] % 128:
        raise ValueError(f"data: expected [n_tiles, {TILE}, d] with d a "
                         f"multiple of 128, got {list(data.shape)}")
    n_tiles, _, d = data.shape
    B = q_data.shape[0]
    if B < 1 or k < 1:
        raise ValueError(f"K4 takes B >= 1 and k >= 1, got B={B}, k={k}")
    dtype = torch.int8 if quantized else torch.float32
    _check("data", data, dtype, (n_tiles, TILE, d), dev)
    for name, x in (("r_scale", r_scale), ("r_zp", r_zp),
                    ("r_qsum", r_qsum), ("r_norm2", r_norm2)):
        _check(name, x, torch.float32, (n_tiles, TILE), dev)
    _check("row_docid", row_docid, torch.int32, (n_tiles, TILE), dev)
    _check("row_field", row_field, torch.int32, (n_tiles, TILE), dev)
    _check("deleted", deleted, torch.bool, (deleted.shape[0],), dev)
    _check("field_ok", field_ok, torch.bool, (field_ok.shape[0],), dev)
    _check("q_data", q_data, dtype, (B, d), dev)
    for name, x in (("q_scale", q_scale), ("q_zp", q_zp),
                    ("q_qsum", q_qsum), ("q_norm2", q_norm2),
                    ("score_min", score_min)):
        _check(name, x, torch.float32, (B,), dev)
    if deleted.shape[0] < 1 or field_ok.shape[0] < 1:
        raise ValueError("deleted and field_ok must not be empty")
    if exhaustive:
        NT, tid_ptr = n_tiles, None
    else:
        NT = tile_ids.shape[0]
        _check("tile_ids", tile_ids, torch.int32, (NT,), dev)
        if NT < 1:
            raise ValueError("tile_ids must not be empty")
        tid_ptr = tile_ids.data_ptr()
    if dev.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got {dev}")
    # the running scan stages rows and stats by 16-byte copies
    for name, x in (("data", data), ("r_scale", r_scale), ("r_zp", r_zp),
                    ("r_qsum", r_qsum), ("r_norm2", r_norm2),
                    ("row_docid", row_docid), ("row_field", row_field),
                    ("q_data", q_data)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    kk = min(k, NT * TILE)
    G = n_ranges(NT, B, k,
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    L, LK = (G, RUN_KK) if G else (NT, min(k, TILE))
    # the running scan's scratch: each query's shared threshold key, each
    # range's best key a query from the probe pass, 32 buckets a query
    gthr = (torch.empty(B * (G + 33), dtype=torch.int64, device=dev)
            if G else None)
    list_v = torch.empty((B, L, LK), dtype=torch.float32, device=dev)
    list_p = torch.empty((B, L, LK), dtype=torch.int32, device=dev)
    P = max(32, ceil_pow2(kk))
    scratch = (torch.empty(B * 16 * P, dtype=torch.uint8, device=dev)
               if P > MERGE_SMEM_P else None)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    rows = torch.empty((B, k), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    lib = _build.load("vector_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    with torch.cuda.device(dev):
        err = lib.vector_scan_launch(
            data.data_ptr(), r_scale.data_ptr(), r_zp.data_ptr(),
            r_qsum.data_ptr(), r_norm2.data_ptr(), row_docid.data_ptr(),
            row_field.data_ptr(), deleted.data_ptr(), deleted.shape[0],
            field_ok.data_ptr(), field_ok.shape[0], tid_ptr, NT,
            q_data.data_ptr(), q_scale.data_ptr(), q_zp.data_ptr(),
            q_qsum.data_ptr(), q_norm2.data_ptr(), score_min.data_ptr(), B,
            d, k, int(quantized), int(euclidean), int(use_field_filter),
            int(with_counts), int(gathered_order(exhaustive, NT, pool_tiles or n_tiles)), G,
            list_v.data_ptr(), list_p.data_ptr(),
            None if gthr is None else gthr.data_ptr(), P,
            None if scratch is None else scratch.data_ptr(),
            vals.data_ptr(), rows.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vector_scan_cuda launch failed (error {err})")
    return vals, rows, counts
