"""Dense-path scans over a (block, query) pair list: the impact scan and
the tf scan.

Port of ``seekstorm_tpu/ops/lexical.py``: ``lexical_scan_imp`` (486-565),
``_topk_block`` (327-360) and ``lexical_scan_qt`` (592-667), and, for
batches with a boost profile of their own (``field_filter``),
``lexical_scan`` (184-267) with ``_block_step`` (76-174) as ``tf_scan`` /
``tf_scan_pairs``: torch ops that recombine the per-field term frequencies
at query time and then take the same tail as the impact scan.  The reference
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

from functools import partial

from ..plan import FLAG_NEG, FLAG_REQ
from ..schema import BLOCK_SIZE, BM25_K
from .dense_scan import (KMAX, _sort_desc, dense_scan, dense_topk, fma32,
                         pack_words, segment_positions, topk_tiles,
                         unpack_words)
from .facet_hist import facet_hist

# pairs whose dense-term rows are scored at a time by tf_scan: the rows are
# [pairs, BLOCK_SIZE, F] and their fma runs in f64, 64 MB a temporary here
DENSE_PAIRS = 128


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


def _impact(tf, comp, boosts):
    """BM25F impact of postings from their per-field term frequencies
    (lexical.py:129-130, 160-162): tf f32[..., F], comp f32[..., F] the
    doc-length components, boosts f32[F].  sat = tf*(k+1)/(tf+comp) is 0
    where tf is 0 (comp is positive, 1.0 where a doc has no length), so a
    field whose boost is 0 and a field without the term add exactly 0.  The
    sum over the fields is an fma chain in ascending field order, as XLA
    contracts the reference's ``jnp.sum(bst * sat, axis=1)`` on the CPU."""
    sat = tf * (BM25_K + 1.0) / (tf + comp)
    acc = boosts[0] * sat[..., 0]
    for f in range(1, tf.shape[-1]):
        acc = fma32(boosts[f].expand_as(acc), sat[..., f], acc)
    return acc


def tf_scan(pl_docid, pl_tf, dense_tf, comp, delw, p_blk, p_q, p_nreq,
            s_off, s_len, s_dense, s_w, s_flag, n_queries: int,
            with_matched: bool = False, *, boosts):
    """The tf scan over P (block, query) pairs: the torch form of
    ``_block_step`` (lexical.py:76-174) with the counts of ``lexical_scan``
    (230-231), for batches whose boost profile differs from the commit-time
    one (``field_filter``).  Torch ops on either device; no kernel.

    pl_docid i16[Pp] (u16 bits) / pl_tf i16[Pp, F] (u16 bits) the full
    postings; dense_tf i16[ND, BLOCK_SIZE, F] (u16 bits) the dense-term
    rows; comp f32[NBLK*BLOCK_SIZE, F]; delw i32[NBLK, NWORDS] deleted-doc
    words (a facet filter's disallowed docs ORed in); p_blk / p_q / p_nreq
    i32[P] global block, batch row and required-slot count of each pair;
    per (pair, slot), the query's slots in ascending slot id: s_off i64 /
    s_len i32 [P, T] the slot's posting range in the block (length 0 if
    none or dense), s_dense i32 its dense row (-1 if none), s_w f32 its
    idf, s_flag i32 FLAG_REQ | FLAG_NEG; boosts f32[F] the batch's field
    boosts.

    For each pair and doc: a slot's impact is the boost-weighted sum of its
    per-field saturations (``_impact``); S = the fma chain of w_t * impact_t
    over the posting-range slots in ascending slot id, plus the same chain
    over the dense-row slots (the reference's ``W @ D + Wd @ dimp``, whose
    matmuls are fma chains on the CPU); a slot is present where its impact
    is positive (so a term found only in fields of boost 0 is absent);
    matched = S > 0 & required slots present >= nreq & no negated slot
    present & ~deleted.  A doc is in a slot's range at most once, so the
    indexed updates below never collide and are deterministic on CUDA.

    Returns what ``dense_scan`` returns: (scores f32[P, BLOCK_SIZE] with
    -inf where unmatched, cnt i32[n_queries]), and with_matched the matched
    words i32[P, NWORDS] as a third.  Temporaries: the three [P, BLOCK_SIZE]
    accumulators (f32, i16, bool; a fourth f32 with dense rows), 11 bytes a
    doc and pair, 740 MB at the TILE_PAIRS = 1,024 pairs ``topk_tiles``
    hands it; dense rows are scored DENSE_PAIRS pairs at a time."""
    dev = comp.device
    P, T = s_len.shape
    F = comp.shape[1]
    score = torch.zeros((P, BLOCK_SIZE), dtype=torch.float32, device=dev)
    dscore = None             # the dense rows' chain, allocated on first use
    req = torch.zeros((P, BLOCK_SIZE), dtype=torch.int16, device=dev)
    neg = torch.zeros((P, BLOCK_SIZE), dtype=torch.bool, device=dev)
    blk = p_blk.long()
    compb = comp.view(-1, BLOCK_SIZE, F)
    for t in range(T):
        w = s_w[:, t]
        is_req = (s_flag[:, t] & FLAG_REQ) != 0
        is_neg = (s_flag[:, t] & FLAG_NEG) != 0
        seg = segment_positions(s_off[:, t], s_len[:, t])
        if seg is not None:
            pid, pos = seg
            doc = pl_docid[pos].long() & 0xFFFF
            tf = (pl_tf[pos].to(torch.int32) & 0xFFFF).float()
            imp = _impact(tf, comp[blk[pid] * BLOCK_SIZE + doc], boosts)
            score[pid, doc] = fma32(w[pid], imp, score[pid, doc])
            hit = imp > 0
            req[pid, doc] += (is_req[pid] & hit).to(torch.int16)
            neg[pid, doc] |= is_neg[pid] & hit
        rd = torch.nonzero(s_dense[:, t] >= 0).flatten()
        if len(rd) and dscore is None:
            dscore = torch.zeros((P, BLOCK_SIZE), dtype=torch.float32,
                                 device=dev)
        for a in range(0, len(rd), DENSE_PAIRS):
            r = rd[a:a + DENSE_PAIRS]
            dtf = (dense_tf[s_dense[r, t].long()].to(torch.int32)
                   & 0xFFFF).float()                       # [Pd, BLOCK, F]
            dimp = _impact(dtf, compb[blk[r]], boosts)
            dscore[r] = fma32(w[r, None].expand_as(dimp), dimp, dscore[r])
            hit = dimp > 0
            req[r] += (hit & is_req[r, None]).to(torch.int16)
            neg[r] |= hit & is_neg[r, None]
    if dscore is not None:
        score = score + dscore
    deleted = unpack_words(delw[blk])
    matched = (score > 0) & (req >= p_nreq[:, None]) & ~neg & ~deleted
    out = torch.where(matched, score,
                      torch.full((), float("-inf"), device=dev))
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    cnt.index_add_(0, p_q.long(), matched.sum(dim=1, dtype=torch.int32))
    if with_matched:
        return out, cnt, pack_words(matched)
    return out, cnt


def tf_scan_pairs(arrays, pairs, boosts, k: int, n_queries: int, fcod=None,
                  fcm: int = 1, rank=None):
    """Score every pair by its per-field term frequencies under `boosts`
    and reduce it to its top-kk, kk = min(k, BLOCK_SIZE): ``scan_pairs`` for
    a tf plan.  ``tf_scan`` gives a tile's masked scores, ``topk_tiles``
    ranks them (by `rank` for sorted results) and takes each pair's top-kk,
    and K3 counts the facet codes from the matched words.

    arrays: (pl_docid, pl_tf, dense_tf, comp, delw); pairs: (p_blk, p_q,
    p_nreq, s_off, s_len, s_dense, s_w, s_flag); boosts f32[F], all on one
    device.  Returns what ``scan_pairs`` returns."""
    kk = min(k, BLOCK_SIZE)
    out = topk_tiles(partial(tf_scan, boosts=boosts), *arrays, *pairs,
                     n_queries, kk, rank=rank,
                     with_matched=fcod is not None)
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
