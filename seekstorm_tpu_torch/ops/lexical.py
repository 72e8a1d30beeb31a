"""Dense impact-path scan over a (block, query) pair list.

Port of ``seekstorm_tpu/ops/lexical.py``: ``lexical_scan_imp`` (486-565),
``_topk_block`` (327-360) and ``lexical_scan_qt`` (592-667).  The reference
steps over blocks (or block x query tiles) and keeps a running top-k per
query.  Here kernel K2 (``ops/dense_scan.py``) scores the pairs and reduces
each to its exact top-k, and the pairs of a (shard, query) merge in
ascending block order, which is what the reference's running ``lax.top_k``
merge yields: (score desc, doc asc) inside a block, earlier blocks first on
ties.

Facets (``_facet_update``, 297-324, called at 532-534): K2 also returns each
pair's packed matched words and kernel K3 (``ops/facet_hist.py``) counts the
facet codes of the matched docs from them, one launch a batch.  Sorted
results (the sort-key rank, 535-543): K2's unfused mode gives the masked
scores and a matched doc ranks by its sort key; K2's fused mode orders
positive scores only, so a sorted batch does not take it.  A facet filter
needs nothing here: its disallowed docs are ORed into the delete words the
caller hands in.

Every top-k here is a stable sort: ``torch.topk`` does not keep the lower
index on ties.  The reference's bf16 ``fast_mode`` is not ported (the port
is exact f32).
"""

from __future__ import annotations

import torch

from ..schema import BLOCK_SIZE
from .dense_scan import KMAX, _sort_desc, dense_scan, dense_topk, topk_tiles
from .facet_hist import facet_hist


def scan_pairs(arrays, pairs, k: int, n_queries: int, fcod=None,
               fcm: int = 1, rank=None):
    """Score every pair and reduce it to its top-kk, kk = min(k,
    BLOCK_SIZE): for kk <= KMAX in K2's fused mode, one launch for all
    pairs; above it, and for sorted results, K2's unfused mode a tile of
    pairs at a time, each tile's masked scores (or sort keys) reduced by
    its top-k (``topk_tiles``).  On the CPU, the plain versions of the same.

    arrays: (docid, imp, bitmaps, sat1, delw) device tensors; pairs:
    (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag) device tensors;
    fcod i32[NF, NBLK*BLOCK_SIZE] facet codes and fcm their code space
    (facet counts); rank f32[NBLK*BLOCK_SIZE] the per-doc rank of sorted
    results, larger first (an ascending order hands in the negated key).
    Returns (vals f32[P, kk], docs i64[P, kk], cnt i32[n_queries], fc
    i32[NF, n_queries, fcm] or None)."""
    kk = min(k, BLOCK_SIZE)
    want = {"with_matched": True} if fcod is not None else {}
    if kk <= KMAX and rank is None:
        out = dense_topk(*arrays, *pairs, n_queries, kk, **want)
    else:
        if rank is not None:
            want["rank"] = rank
        out = topk_tiles(dense_scan, *arrays, *pairs, n_queries, kk, **want)
    if fcod is None:
        return (*out, None)
    vals, docs, cnt, mwords = out
    fc = facet_hist(mwords, pairs[0], pairs[1], fcod, fcm, n_queries)
    return vals, docs, cnt, fc


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
