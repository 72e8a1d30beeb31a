"""Dense impact-path scan over a (block, query) pair list, score mode.

Port of ``seekstorm_tpu/ops/lexical.py``: ``lexical_scan_imp`` (486-565),
``_topk_block`` (327-360) and ``lexical_scan_qt`` (592-667).  The reference
steps over blocks (or block x query tiles) and keeps a running top-k per
query.  Here kernel K2 (``ops/dense_scan.py``) scores the pairs and reduces
each to its exact top-k, and the pairs of a (shard, query) merge in
ascending block order, which is what the reference's running ``lax.top_k``
merge yields: (score desc, doc asc) inside a block, earlier blocks first on
ties.

Every top-k here is a stable sort: ``torch.topk`` does not keep the lower
index on ties.  The reference's bf16 ``fast_mode`` is not ported (the port
is exact f32); facets and sort keys stay with the reference (ROADMAP A.6).
"""

from __future__ import annotations

import torch

from ..schema import BLOCK_SIZE
from .dense_scan import KMAX, _sort_desc, dense_scan, dense_topk, topk_tiles


def scan_pairs(arrays, pairs, k: int, n_queries: int):
    """Score every pair and reduce it to its top-kk, kk = min(k,
    BLOCK_SIZE): for kk <= KMAX in K2's fused mode, one launch for all
    pairs; above it K2's unfused mode a tile of pairs at a time, each
    tile's masked scores reduced by its top-k (``topk_tiles``).  On the
    CPU, the plain versions of the same.

    arrays: (docid, imp, bitmaps, sat1, delw) device tensors; pairs:
    (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag) device tensors.
    Returns (vals f32[P, kk], docs i64[P, kk], cnt i32[n_queries])."""
    kk = min(k, BLOCK_SIZE)
    if kk <= KMAX:
        return dense_topk(*arrays, *pairs, n_queries, kk)
    return topk_tiles(dense_scan, *arrays, *pairs, n_queries, kk)


def merge_rows(vals, gids, row, col, n_rows: int, n_cols: int, k: int):
    """Merge per-pair lists into per-row top-k.

    vals f32[P, kk] / gids i64[P, kk] each sorted; row i64[P] the output
    row of each pair and col i64[P] its place among the row's pairs
    (ascending block order).  The lists are laid side by side in that
    order and one stable sort keeps, on ties, the earlier block's entry,
    the reference's running-merge order.  Returns (f32[n_rows, k],
    i64[n_rows, k]), -inf padded."""
    dev = vals.device
    kk = vals.shape[1]
    width = max(n_cols * kk, k)
    m_val = torch.full((n_rows, width), float("-inf"), device=dev)
    m_gid = torch.zeros((n_rows, width), dtype=torch.int64, device=dev)
    at = col[:, None] * kk + torch.arange(kk, device=dev)
    m_val[row[:, None], at] = vals
    m_gid[row[:, None], at] = gids
    out, sel = _sort_desc(m_val)
    return out[:, :k], torch.gather(m_gid, 1, sel[:, :k])


def merge_shard_results(ts_all, gid_all, k: int):
    """[S, B, k] per-shard pages -> [B, k]: the reference's top-k over the
    shard-major [B, S*k] concatenation (parallel/mesh.py:400-410)."""
    S, B, _ = ts_all.shape
    ts_t = ts_all.permute(1, 0, 2).reshape(B, S * k)
    gid_t = gid_all.permute(1, 0, 2).reshape(B, S * k)
    mts, sel = _sort_desc(ts_t)
    return mts[:, :k], torch.gather(gid_t, 1, sel[:, :k])
