"""The committed vector scan on CUDA: kernel K4 (csrc/vector_scan.cu) and
the merge of its per-tile lists.

Replaces ``seekstorm_tpu/ops/vector.py::vector_scan_topk`` (74-157), whose
plain PyTorch form is ``ops/vector.vector_scan_ref``.  K4 scores each
selected 256-row tile against the batch and keeps the tile's top-kk per
query (kk = min(k, 256)) by (score desc, row asc), with the masks and the
counts; the [B, NT*256] score matrix never reaches device memory.  One
stable sort of the [B, NT*kk] lists, laid out in tile order, gives the
reference's ``lax.top_k`` order: ties keep the lower position.
"""

from __future__ import annotations

import torch

from .vector import merge_candidates
from .wand_scan import _check

TILE = 256

# launches of K4 since the last reset (the count a run reads to show that
# its vector batches went through the kernel)
LAUNCHES = 0


def vector_scan_cuda(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                     row_field, deleted, tile_ids, field_ok, q_data, q_scale,
                     q_zp, q_qsum, q_norm2, score_min, *, k: int,
                     quantized: bool, euclidean: bool, with_counts: bool,
                     exhaustive: bool, use_field_filter: bool):
    """K4 on CUDA tensors: same contract as vector_scan_ref."""
    global LAUNCHES
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
    kt = min(k, TILE)
    vals = torch.empty((B, NT, kt), dtype=torch.float32, device=dev)
    rows = torch.empty((B, NT, kt), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    lib = _build.load("vector_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.vector_scan_launch(
        data.data_ptr(), r_scale.data_ptr(), r_zp.data_ptr(),
        r_qsum.data_ptr(), r_norm2.data_ptr(), row_docid.data_ptr(),
        row_field.data_ptr(), deleted.data_ptr(), deleted.shape[0],
        field_ok.data_ptr(), field_ok.shape[0], tid_ptr, NT,
        q_data.data_ptr(), q_scale.data_ptr(), q_zp.data_ptr(),
        q_qsum.data_ptr(), q_norm2.data_ptr(), score_min.data_ptr(), B, d,
        kt, int(quantized), int(euclidean), int(use_field_filter),
        int(with_counts), vals.data_ptr(), rows.data_ptr(),
        counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vector_scan_cuda launch failed (error {err})")
    ts, out_rows = merge_candidates(vals.view(B, NT * kt),
                                    rows.view(B, NT * kt), k)
    return ts, out_rows, counts
