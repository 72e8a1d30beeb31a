"""Dense impact-path scan over a (block, query) pair list, score mode.

Port of ``seekstorm_tpu/ops/lexical.py``: ``lexical_scan_imp`` (486-565),
``_topk_block`` (327-360) and ``lexical_scan_qt`` (592-667).  The reference
steps over blocks (or block x query tiles) and keeps a running top-k per
query.  Here kernel K2 (``ops/dense_scan.py``) scores the pairs in tiles,
each tile is reduced to an exact per-pair top-k, and the pairs of a
(shard, query) merge in ascending block order, which is what the
reference's running ``lax.top_k`` merge yields: (score desc, doc asc)
inside a block, earlier blocks first on ties.

Every top-k is a stable sort: ``torch.topk`` does not keep the lower index
on ties.  The reference's bf16 ``fast_mode`` is not ported (the port is
exact f32); facets and sort keys stay with the reference (ROADMAP A.6).
"""

from __future__ import annotations

import torch

from ..schema import BLOCK_SIZE
from .dense_scan import dense_scan

CHUNK = 128                    # docs per bucket of the two-stage top-k
TOPK_BUCKETS = BLOCK_SIZE // CHUNK
# pairs per K2 tile: 256 MB of masked scores (256 KB a pair) at a time
TILE_PAIRS = 1024


def _sort_desc(x):
    return torch.sort(x, dim=1, descending=True, stable=True)


def topk_block(rank: torch.Tensor, k: int):
    """Exact top-k of each row of rank f32[P, BLOCK_SIZE] by (score desc,
    doc asc): (values f32[P, k], docs i64[P, k]), k <= BLOCK_SIZE.

    For k <= 128, the reference's two stages: the top-k 128-doc buckets by
    (bucket max desc, bucket asc), then the top-k of their docs in
    ascending doc order.  It is exact because a doc outside those buckets
    is beaten or tied-and-preceded by each selected bucket's best doc."""
    P = rank.shape[0]
    if k > CHUNK:
        vals, docs = _sort_desc(rank)
        return vals[:, :k], docs[:, :k]
    xb = rank.view(P, TOPK_BUCKETS, CHUNK)
    bti = _sort_desc(xb.amax(dim=2))[1][:, :k]
    bti = bti.sort(dim=1)[0]                          # doc-ordered buckets
    cand = torch.gather(xb, 1, bti[:, :, None].expand(P, k, CHUNK))
    vals, ci = _sort_desc(cand.reshape(P, k * CHUNK))
    vals, ci = vals[:, :k], ci[:, :k]
    docs = torch.gather(bti, 1, ci // CHUNK) * CHUNK + ci % CHUNK
    return vals, docs


def scan_pairs(arrays, pairs, k: int, n_queries: int):
    """Score every pair with K2 (or its plain version on the CPU), tile by
    tile, and reduce each to its top-min(k, BLOCK_SIZE).

    arrays: (docid, imp, bitmaps, sat1, delw) device tensors; pairs:
    (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag) device tensors.
    Returns (vals f32[P, kk], docs i64[P, kk], cnt i32[n_queries])."""
    p_blk = pairs[0]
    dev = p_blk.device
    P = p_blk.shape[0]
    kk = min(k, BLOCK_SIZE)
    vals = torch.empty((P, kk), dtype=torch.float32, device=dev)
    docs = torch.empty((P, kk), dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    for a in range(0, P, TILE_PAIRS):
        b = a + TILE_PAIRS
        scores, c = dense_scan(*arrays, *[x[a:b] for x in pairs], n_queries)
        cnt += c
        vals[a:b], docs[a:b] = topk_block(scores, kk)
        del scores
    return vals, docs, cnt


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
