"""Plain BM25F over the generated words: the exact top-k page and match count
of a Union or Intersection query over the committed documents plus the
uncommitted tail.  NumPy only; it reads the generator's word ids and works
out the terms, document frequencies and field lengths itself.

Scoring (SeekStorm's BM25F, the configuration's ``scoring``):
    idf    = ln(1 + (N - df + 0.5) / (df + 0.5)), N and df over committed
             plus tail documents
    comp_f = K * (1 - B + B * len_f / avg_len), len_f a field's word count
             through Lucene's SmallFloat byte, avg_len the committed
             documents' mean of the summed decoded field lengths
    score  = sum over the query's distinct terms of
             idf * sum_f boost_f * tf_f * (K + 1) / (tf_f + comp_f)
in float32, pages by (score desc, doc asc).  ``precision="bf16"`` rounds
every product and sum to bfloat16: the control of the check.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

K, B = 1.2, 0.75
_FREE = 24


def _byte4_to_int(b: int) -> int:
    if b < _FREE:
        return b
    i = b - _FREE
    bits, shift = i & 0x07, i >> 3
    if shift == 0:
        return _FREE + bits
    return _FREE + ((bits | 0x08) << (shift - 1))


# Lucene SmallFloat.byte4ToInt for every byte: the decoded field lengths
DECODED = np.array([_byte4_to_int(b) for b in range(256)], np.int64)


def length_codes(lengths: np.ndarray) -> np.ndarray:
    """SmallFloat.intToByte4: the largest byte whose decoded length is at
    most the length."""
    li = np.clip(np.asarray(lengths, np.int64), 0, int(DECODED[-1]))
    return (np.searchsorted(DECODED, li, side="right") - 1).astype(np.uint8)


def bf16(x) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@dataclass
class Postings:
    """Per term (sorted by term, then doc): doc ids and per-field counts,
    and each document's field length codes."""

    term_off: np.ndarray    # i64[vocab + 1]
    doc: np.ndarray         # i32[P]
    tf: np.ndarray          # u16[P, 2]  (title, body)
    codes: np.ndarray       # u8[n_docs, 2]

    @property
    def n_docs(self) -> int:
        return len(self.codes)

    def save(self, path) -> None:
        np.savez(path, term_off=self.term_off, doc=self.doc, tf=self.tf,
                 codes=self.codes)

    @classmethod
    def load(cls, path) -> "Postings":
        z = np.load(path)
        return cls(z["term_off"], z["doc"], z["tf"], z["codes"])


def postings(title_len, body_len, stream, vocab: int) -> Postings:
    """Postings of generated documents (corpus.corpus_tokens' arrays)."""
    n = len(title_len)
    doc_len = np.asarray(title_len, np.int64) + np.asarray(body_len, np.int64)
    starts = np.zeros(n, np.int64)
    np.cumsum(doc_len[:-1], out=starts[1:])
    doc = np.repeat(np.arange(n, dtype=np.int64), doc_len)
    body = (np.arange(len(stream), dtype=np.int64) - np.repeat(starts, doc_len)
            >= np.repeat(np.asarray(title_len, np.int64), doc_len))
    key = (np.asarray(stream, np.int64) * n + doc) * 2 + body
    del doc, body
    key, counts = np.unique(key, return_counts=True)
    td = key >> 1
    first = np.ones(len(td), bool)
    first[1:] = td[1:] != td[:-1]
    row = np.cumsum(first) - 1
    tf = np.zeros((int(first.sum()), 2), np.uint16)
    tf[row, (key & 1)] = np.minimum(counts, 65_535)
    td = td[first]
    term = td // n
    codes = np.stack([length_codes(title_len), length_codes(body_len)], 1)
    return Postings(
        term_off=np.searchsorted(term, np.arange(vocab + 1)).astype(np.int64),
        doc=(td % n).astype(np.int32), tf=tf, codes=codes)


class BM25F:
    """The reference over committed postings plus a tail's postings; tail
    documents are numbered after the committed ones."""

    def __init__(self, committed: Postings, tail: Postings, boosts,
                 precision: str = "f32"):
        self.c, self.t = committed, tail
        self.n_c = committed.n_docs
        self.n = committed.n_docs + tail.n_docs
        self.boosts = np.asarray(boosts, np.float32)
        self.r = bf16 if precision == "bf16" else (
            lambda x: np.asarray(x, np.float32))
        lens = DECODED[committed.codes]
        avg_len = float(lens.sum()) / max(committed.n_docs, 1)
        all_lens = np.concatenate([lens, DECODED[tail.codes]]).astype(
            np.float32)
        r = self.r
        self.comp = r(np.float32(K) * r(np.float32(1.0 - B) + r(
            np.float32(B) * r(all_lens / np.float32(avg_len)))))

    def _term(self, t: int):
        """(doc ids over committed + tail, per-field tf) of word id t."""
        parts = []
        for p, base in ((self.c, 0), (self.t, self.n_c)):
            if t + 1 < len(p.term_off):
                a, b = p.term_off[t], p.term_off[t + 1]
                parts.append((p.doc[a:b].astype(np.int64) + base, p.tf[a:b]))
        if not parts:
            return np.zeros(0, np.int64), np.zeros((0, 2), np.uint16)
        return (np.concatenate([d for d, _ in parts]),
                np.concatenate([f for _, f in parts]))

    def scores(self, query: str, qtype: str):
        """(scores f32[n] with -inf where a document does not match, the
        match count)."""
        r = self.r
        terms = list(dict.fromkeys(int(w[1:]) for w in query.split()))
        total = np.zeros(self.n, np.float32)
        hits = np.zeros(self.n, np.int32)
        for t in terms:
            ids, tf = self._term(t)
            df = len(ids)
            if df == 0:
                continue
            idf = r(np.float32(np.log1p((self.n - df + 0.5) / (df + 0.5))))
            tff = tf.astype(np.float32)
            comp = self.comp[ids]
            sat = r(r(tff * np.float32(K + 1.0)) / r(tff + comp))
            imp = r(r(sat[:, 0] * self.boosts[0]) + r(sat[:, 1]
                                                      * self.boosts[1]))
            total[ids] = r(total[ids] + r(idf * imp))
            hits[ids] += 1
        need = len(terms) if qtype == "Intersection" else 1
        match = hits >= max(need, 1)
        return np.where(match, total, np.float32(-np.inf)), int(match.sum())


def page(scores: np.ndarray, k: int):
    """(doc ids, scores) of the top k matches by (score desc, doc asc)."""
    ids = np.flatnonzero(np.isfinite(scores))
    order = np.lexsort((ids, -scores[ids]))[:k]
    return ids[order], scores[ids[order]]
