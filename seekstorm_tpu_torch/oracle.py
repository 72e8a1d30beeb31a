"""Numpy oracle: exact reference scoring on the host.

This is the semantic ground truth for the device kernels (every Pallas/XLA
path is tested against it) and doubles as the realtime search path over the
mutable level-0 tail, mirroring the reference's uncommitted-search mirror
(reference seekstorm/src/realtime_search.rs:921 — the committed and
uncommitted paths share scoring semantics).

Scoring follows the reference BM25F (reference add_result.rs:20-22,868-1484):
    idf      = ln(1 + (N - df + 0.5) / (df + 0.5))            (search.rs:3225)
    comp_f   = K * (1 - B + B * len_norm_f / avg_len)          (commit.rs:321)
    score    = sum_f boost_f * idf * tf_f*(K+1) / (tf_f + comp_f)
with K=1.2, B=0.75, doc lengths compressed through Lucene SmallFloat.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .schema import BM25_B, BM25_K, BM25_SIGMA
from .utils import DOCUMENT_LENGTH_COMPRESSION


def idf(doc_count: int, df: int) -> float:
    if df <= 0:
        return 0.0
    return math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))


def bm25_components(doclen_bytes: np.ndarray, avg_len: float) -> np.ndarray:
    """Per-(doc, field) BM25 length component from compressed length bytes.

    doclen_bytes: u8[n, F]; returns f32[n, F].
    """
    if avg_len <= 0.0:
        avg_len = 1.0
    lens = DOCUMENT_LENGTH_COMPRESSION[doclen_bytes].astype(np.float32)
    return (BM25_K * (1.0 - BM25_B + BM25_B * lens / np.float32(avg_len))).astype(
        np.float32
    )


def term_impacts(tf: np.ndarray, comps: np.ndarray, boosts: np.ndarray) -> np.ndarray:
    """Field-combined impact per posting (idf excluded; multiplied at query time).

    tf:     u16/u32[P, F] per-field term frequency
    comps:  f32[P, F] per-posting BM25 length components (already gathered per doc)
    boosts: f32[F] per-field boost
    returns f32[P]
    """
    tff = tf.astype(np.float32)
    sat = tff * (BM25_K + 1.0) / (tff + comps)
    if BM25_SIGMA:
        sat = np.where(tff > 0, sat + BM25_SIGMA, sat)
    return (sat * boosts[None, :]).sum(axis=1).astype(np.float32)


@dataclass
class OracleTermPostings:
    """One term's postings for oracle evaluation."""

    docids: np.ndarray      # i64[P] shard-local doc ids
    impacts: np.ndarray     # f32[P]
    positions: list | None  # optional: per posting, per field position arrays


def score_query(
    doc_count: int,
    n_docs_scored: int,
    term_postings: list[OracleTermPostings | None],
    dfs: list[int],
    required: list[bool],
    negated: list[bool],
    deleted: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense oracle scoring over `n_docs_scored` shard-local docs.

    Returns (scores f32[n], matched bool[n]).  Matching semantics:
      - a doc matches iff every required term is present, no negated term is
        present, and at least one non-negated term is present;
      - score = sum over present non-negated terms of idf * impact.
    """
    n = n_docs_scored
    scores = np.zeros(n, dtype=np.float32)
    req_count = np.zeros(n, dtype=np.int32)
    neg_hit = np.zeros(n, dtype=bool)
    any_hit = np.zeros(n, dtype=bool)
    n_required = 0

    for tp, df, req, neg in zip(term_postings, dfs, required, negated):
        if neg:
            if tp is not None and len(tp.docids):
                ids = tp.docids[tp.docids < n]
                neg_hit[ids] = True
            continue
        if req:
            n_required += 1
        if tp is None or not len(tp.docids):
            continue
        mask = tp.docids < n
        ids = tp.docids[mask]
        w = np.float32(idf(doc_count, df))
        scores[ids] += w * tp.impacts[mask]
        any_hit[ids] = True
        if req:
            req_count[ids] += 1

    matched = any_hit & (~neg_hit) & (req_count >= n_required)
    if deleted is not None:
        matched &= ~deleted[:n]
    scores = np.where(matched, scores, np.float32(-np.inf))
    return scores, matched


def verify_phrase(
    positions_by_term: list[list[np.ndarray]],
    offsets: list[int] | None = None,
) -> bool:
    """Check whether terms occur at the expected relative positions in some
    field.  offsets[t] is term t's token offset within the phrase (defaults
    to 0,1,2,... for plain adjacency); n-gram segments carry multi-token
    offsets."""
    if offsets is None:
        offsets = list(range(len(positions_by_term)))
    n_fields = len(positions_by_term[0])
    for f in range(n_fields):
        base = positions_by_term[0][f]
        if base is None or len(base) == 0:
            continue
        cand = set(int(p) - offsets[0] for p in base)
        ok = True
        for t in range(1, len(positions_by_term)):
            pos = positions_by_term[t][f]
            if pos is None or len(pos) == 0:
                ok = False
                break
            nxt = set(int(p) - offsets[t] for p in pos)
            cand &= nxt
            if not cand:
                ok = False
                break
        if ok and cand:
            return True
    return False


def topk_from_scores(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (score desc, docid asc tiebreak) over a dense score vector."""
    n = len(scores)
    k = min(k, n)
    if k <= 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int64)
    order = np.lexsort((np.arange(n), -scores))[:k]
    s = scores[order]
    keep = s > -np.inf
    return s[keep], order[keep]
