"""The realtime tail of a shard in posting space, read once a batch.

A realtime batch reads each shard's uncommitted level-0 tail through one
``TailView``: the level-0 doc ids ``[start, end)`` it covers, taken once,
and the tail postings of each distinct term hash of the batch's slots (slot
hash, n-gram ``tf_hash`` constituent, ``idf_hash``), read from the level-0
accumulator once.  The idf's tail df (``search._shard_idf``, on every route
of the batch) and the tail merge (``search._merge_tail``) both read the
view, so under a concurrent ingest a batch weighs and scores the same docs.
``BatchTails`` holds a batch's views; nothing of them outlives the batch.

``score_pairs`` and ``select`` are the merge's arithmetic over the batch's
(query, posting) pairs, the same as ``oracle.score_query`` followed by
``oracle.topk_from_scores`` once a query over the dense tail: a doc's score
is the f32 sum of ``w * impact`` in its query's slot order, and each query
keeps its first ``k`` matched docs by (score desc, doc asc).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .metrics import METRICS
from .oracle import bm25_components, idf, term_impacts
from .utils import term_hash


def _doc_hash(sl) -> int:
    """The hash whose postings give a slot's docs: an n-gram's own for
    slots scored with a constituent's tfs (virtual slots carry a hash of
    their own), else the slot's."""
    return term_hash(sl.term) if sl.tf_hash is not None else sl.hash


def _idf_hash(sl) -> int:
    return sl.idf_hash if sl.idf_hash is not None else sl.hash


class TailView:
    """One shard's uncommitted tail as one batch reads it."""

    def __init__(self, shard, slots):
        l0 = shard.level0
        self.shard = shard
        self.start = shard.partial_on_disk
        self.n_tail = max(l0.doc_count - self.start, 0)
        self.end = self.start + self.n_tail
        self.base = shard.tail_start      # shard-local id of tail doc 0
        # hash -> (level-0 doc ids [n], tfs u16[n, F]) of the docs in
        # [start, end), or None where level 0 lacks the term
        self._hits: dict[int, tuple | None] = {}
        if self.n_tail:
            for sl in slots:
                for h in (_doc_hash(sl), _idf_hash(sl), sl.tf_hash):
                    if h is not None and h not in self._hits:
                        self._read(h)

    def _get(self, h: int):
        return self._hits[h] if h in self._hits else self._read(h)

    def _read(self, h: int):
        l0 = self.shard.level0
        acc = getattr(l0, "acc", None)
        if acc is not None:
            hit = acc.term_postings(h)
        else:
            tp = l0.terms.get(h)
            hit = None if tp is None else (
                np.asarray(tp.docids, dtype=np.int64), tp.tfs)
        if hit is not None:
            ids, tf = hit
            lo, hi = 0, len(ids)
            # level-0 doc ids ascend; a concurrent ingest adds postings
            # past `end` whose doc lengths may not be there yet
            if self.start or (hi and ids[-1] >= self.end):
                lo, hi = np.searchsorted(
                    ids, np.array((self.start, self.end), np.int64))
            if acc is None:
                F = l0.n_fields
                tf = np.asarray(tf[lo * F:hi * F],
                                dtype=np.uint16).reshape(-1, F)
                hit = ids[lo:hi], tf
            elif hi - lo < len(ids):
                hit = ids[lo:hi], tf[lo:hi]
        self._hits[h] = hit
        return hit

    def idf_df(self, slots) -> np.ndarray:
        """i64[V] each slot's tail df for its idf: the docs in [start, end)
        holding its idf term (an n-gram's constituent)."""
        if not self.n_tail:     # a committed shard: no lookups at all
            return np.zeros(len(slots), np.int64)
        return np.array([len(hit[0]) if (hit := self._get(_idf_hash(sl)))
                         is not None else 0 for sl in slots], np.int64)

    def postings(self, slots, boosts: np.ndarray, avg_len: float):
        """The slots' tail postings as CSR in slot order, (indptr i64[V+1],
        tail-local doc ids i64[P], f32 impacts [P]), and each slot's tail df
        for the merge's idf, i64[V]: its constituent's where it scores with
        one that level 0 holds, else its own."""
        l0 = self.shard.level0
        F = l0.n_fields
        docs, tfs, df = [], [], []
        none = (np.zeros(0, np.int64), np.zeros((0, F), np.uint16))
        for sl in slots:
            hit = self._get(_doc_hash(sl))
            d, tf = hit or none
            c = (self._get(sl.tf_hash)
                 if hit is not None and sl.tf_hash is not None else None)
            df.append(len(d if c is None else c[0]))
            if c is not None and len(c[0]) and len(d):
                cd, ctf = c
                pos = np.minimum(np.searchsorted(cd, d), len(cd) - 1)
                found = cd[pos] == d
                tf = np.where(found[:, None], ctf[pos], tf)
            docs.append(d)
            tfs.append(tf)
        indptr = np.zeros(len(slots) + 1, np.int64)
        np.cumsum([len(d) for d in docs], out=indptr[1:])
        doc = (np.concatenate(docs).astype(np.int64) if docs else none[0]) \
            - self.start
        dl = np.frombuffer(b"".join(l0.doclen[self.start:self.end]),
                           dtype=np.uint8).reshape(self.n_tail, F)
        comps = bm25_components(dl, avg_len)
        imp = term_impacts(np.concatenate(tfs) if tfs else none[1],
                           comps[doc], boosts)
        return indptr, doc, imp, np.array(df, np.int64)


class BatchTails:
    """A realtime batch's tail views, one a shard, each built at its first
    use (the idf of the batch's first route, else the merge) under the
    ``tail_merge`` and ``tail_gather`` timers."""

    def __init__(self, slots, realtime: bool):
        self.slots = slots
        self.realtime = realtime
        self._views: dict[int, TailView] = {}

    def get(self, shard) -> TailView | None:
        if not self.realtime:
            return None
        v = self._views.get(shard.shard_id)
        if v is None:
            with METRICS.timer("tail_merge"), METRICS.timer("tail_gather"):
                v = self._views[shard.shard_id] = TailView(shard, self.slots)
        return v


def slot_weights(lex, slots, n_docs: int, tail_df: np.ndarray) -> np.ndarray:
    """f32[V] each slot's idf over committed plus tail docs, as the merge
    weighs its postings: ``oracle.idf`` of the committed df of its idf term
    plus its tail df."""
    d = lex.directory
    hs = np.array([_idf_hash(sl) for sl in slots], np.uint64)
    df = np.zeros(len(slots), np.int64)
    if d is not None and len(d.hash):
        ti = np.minimum(np.searchsorted(d.hash, hs), len(d.hash) - 1)
        df = np.where(d.hash[ti] == hs, d.df[ti], 0)
    return np.array([idf(n_docs, a + b) for a, b in
                     zip(df.tolist(), tail_df.tolist())], np.float32)


@dataclass
class Scored:
    """The (query, tail doc) keys that some posting of the query reaches,
    ascending by query then doc, with their f32 scores and match flags."""

    q: np.ndarray          # i64[U] query (index into the batch's specs)
    doc: np.ndarray        # i64[U] tail-local doc id
    score: np.ndarray      # f32[U]
    matched: np.ndarray    # bool[U]
    n_pairs: int           # (query, posting) pairs expanded


def score_pairs(specs, indptr, pdoc, pimp, w, n_tail: int,
                deleted: np.ndarray) -> Scored:
    """Score every (query, posting) pair of the batch: the slots of each
    spec in its order, each slot's tail postings weighted by its idf.  A
    doc matches iff every required slot holds it, no negated slot does, at
    least one positive slot does, and `deleted` (deletes and the facet
    filter over the tail) leaves it."""
    pq, ps, pneg, preq = [], [], [], []
    for qi, spec in enumerate(specs):
        for s in spec.slots:
            neg = bool(spec.negated.get(s))
            pq.append(qi)
            ps.append(s)
            pneg.append(neg)
            preq.append(bool(spec.required.get(s)) and not neg)
    pq = np.array(pq, np.int64)
    ps = np.array(ps, np.int64)
    pneg = np.array(pneg, bool)
    preq = np.array(preq, bool)
    lens = indptr[ps + 1] - indptr[ps]
    n = int(lens.sum())
    # posting index of each pair's postings, pair after pair
    off = np.repeat(indptr[ps] - (np.cumsum(lens) - lens), lens) \
        + np.arange(n, dtype=np.int64)
    tdoc = pdoc[off]
    tneg = np.repeat(pneg, lens)
    key = np.repeat(pq, lens) * n_tail + tdoc
    uk, inv = np.unique(key, return_inverse=True)
    U = len(uk)
    pos = ~tneg
    tval = np.repeat(w[ps], lens)[pos] * pimp[off[pos]]
    score = np.zeros(U, np.float32)
    # unbuffered and in pair order: each key sums its slots' terms in the
    # query's slot order, as the dense scorer adds them
    np.add.at(score, inv[pos], tval)
    any_hit = np.bincount(inv[pos], minlength=U) > 0
    neg_hit = np.bincount(inv[tneg], minlength=U) > 0
    req_hit = np.bincount(inv[np.repeat(preq, lens)], minlength=U)
    n_req = np.bincount(pq[preq], minlength=len(specs))
    uq = uk // n_tail
    ud = uk - uq * n_tail
    matched = (any_hit & ~neg_hit & (req_hit >= n_req[uq])
               & ~deleted[ud])
    return Scored(uq, ud, score, matched, n)


def select(q, doc, rank, n_queries: int, k: int):
    """Each query's first `k` of the given keys by (rank desc, doc asc),
    with ranks of -inf or NaN left out, as ``oracle.topk_from_scores``
    keeps them from a dense rank with -inf where a doc did not match.  The
    keys come ascending by (query, doc).  Returns (bounds i64[n_queries+1],
    doc, rank): query i's entries are [bounds[i], bounds[i+1])."""
    keep = rank > -np.inf
    q, doc, rank = q[keep], doc[keep], rank[keep]
    # one stable sort of (query, -rank) as an integer key, ties left in doc
    # order: -rank's f32 bits made to sort as unsigned ints, -0.0 as +0.0
    u = (-rank + np.float32(0.0)).view(np.uint32)
    u = np.where(u >> 31, ~u, u | np.uint32(0x80000000))
    order = np.argsort((q.astype(np.uint64) << np.uint64(32))
                       | u.astype(np.uint64), kind="stable")
    q, doc, rank = q[order], doc[order], rank[order]
    first = np.searchsorted(q, np.arange(n_queries))
    cut = (np.arange(len(q)) - first[q]) < k
    q, doc, rank = q[cut], doc[cut], rank[cut]
    return np.searchsorted(q, np.arange(n_queries + 1)), doc, rank
