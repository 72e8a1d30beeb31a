"""Plain hybrid search over the generated corpus, for the check of a hybrid
cell: SeekStorm's ``SearchMode::Hybrid``, a BM25F list and a Model2Vec
vector list fused by reciprocal rank fusion.  NumPy and PyTorch only,
float32 and float64, TF32 off; nothing of the program.

- Lexical list: ``reference/bm25f.py``'s BM25F, the exact top-``need``
  page by (score desc, doc asc) (``lexical_page``).
- Chunks (``chunk``): the body is cut at sentence boundaries, a sentence
  ending at a run of the delimiters ``\\n . ? !`` (SeekStorm vector.rs:561-576
  as SURVEY.md and the program's inference module describe them, the
  ``chunk`` crate with the delimiters and ``chunk_size``): sentences are
  packed into a chunk while it stays within ``chunk_size`` bytes, a sentence
  longer than that is cut every ``chunk_size`` bytes, and each chunk is
  stripped of white space at its ends.  ``chunk_spans`` gives the same cuts
  from the generator's word counts, for text with no delimiter and words of
  a fixed width.
- Model2Vec (``tokens``, ``embed_spans``, ``embed_ids``): a text's words
  are its lower-cased runs of letters, digits and ``_``, looked up in the
  vocabulary (words outside it are skipped), and its vector is the mean of
  their rows of the embedding table, in float64.
- Vector list (``VectorLists``): the cosine between the query and every
  chunk row, each doc's best chunk, the top-``need`` docs by (best desc,
  doc asc), in float64 over the exact rows (the float64 mean,
  normalized).  ``"i8"``, the configuration's precision, passes the
  normalized committed rows and the query they meet, zero-padded to a
  multiple of 128 as the program stores them, through
  ``reference/vectors.py::dequantize`` at 255 levels and scores them by
  their dot product; uncommitted rows and the query they meet stay exact
  (float32 rows).  ``"4bit"``, the control of the check, does the same at
  15 levels.
- Fusion (``fuse``): each doc's score is the sum over the two lists of
  1 / (0.6 + rank), ranks counted from 0, the lexical term first, in
  float64; the page by (score desc, doc asc).

Departures from the published description: SeekStorm scores and fuses in
float32, and the reference in float64 (float32 BM25F); search.rs:1962-2035
is not in the repository: SURVEY.md gives its lines and k = 0.6, and the
program counts ranks from 0, as this file does; the published model is
potion-base-2M's trained table and tokenizer, here a table from a seed and
the generator's words as the vocabulary (the configuration's ``assumed``);
the quantized rows are padded to 128 as the program pads them, since the
padding's rounding enters the quantized dot product.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from reference import bm25f
from reference.vectors import dequantize

RRF_K = 0.6
DELIMITERS = "\n.?!"
_WORD = re.compile(r"\w+")


# -- chunks -----------------------------------------------------------------

def chunk(text: str, chunk_size: int) -> list[str]:
    """`text` cut into chunks of at most `chunk_size` bytes at sentence
    boundaries (module docstring)."""
    sentences, start = [], 0
    i, n = 0, len(text)
    while i < n:
        if text[i] in DELIMITERS:
            while i < n and text[i] in DELIMITERS:
                i += 1
            sentences.append(text[start:i])
            start = i
        else:
            i += 1
    if start < n:
        sentences.append(text[start:])
    out, cur = [], ""
    for s in sentences:
        if cur and len((cur + s).encode()) > chunk_size:
            out.append(cur.strip())
            cur = s
        else:
            cur += s
        while len(cur.encode()) > chunk_size:
            out.append(cur[:chunk_size].strip())
            cur = cur[chunk_size:]
    if cur.strip():
        out.append(cur.strip())
    return out


def chunk_spans(body_len: np.ndarray, chunk_size: int,
                word_bytes: int = 7):
    """``chunk``'s cuts of delimiter-free bodies of ``body_len`` words of
    ``word_bytes`` bytes each (the last word's separator not written), as
    (doc i64[R], first word i64[R], words i64[R]) by doc, then position;
    the first word is counted from the doc's first body word."""
    if chunk_size % word_bytes:
        raise ValueError(f"chunk_size {chunk_size} is not a multiple of "
                         f"the {word_bytes}-byte word")
    per = chunk_size // word_bytes
    body_len = np.asarray(body_len, np.int64)
    n_chunks = -(-body_len // per)
    doc = np.repeat(np.arange(len(body_len), dtype=np.int64), n_chunks)
    first_chunk = np.cumsum(n_chunks) - n_chunks
    c = np.arange(len(doc), dtype=np.int64) - np.repeat(first_chunk,
                                                         n_chunks)
    first = c * per
    return doc, first, np.minimum(per, body_len[doc] - first)


# -- Model2Vec --------------------------------------------------------------

def tokens(text: str, vocab: dict) -> list[int]:
    """A text's word ids: its lower-cased words found in `vocab`."""
    return [vocab[w] for w in _WORD.findall(text.lower()) if w in vocab]


def embed_ids(ids: list[list[int]], table: np.ndarray) -> np.ndarray:
    """f64 [n, d]: each word-id list's mean row of `table` (zeros where a
    list is empty)."""
    t = np.asarray(table, np.float64)
    out = np.zeros((len(ids), t.shape[1]))
    for i, w in enumerate(ids):
        if len(w):
            out[i] = t[np.asarray(w, np.int64)].mean(axis=0)
    return out


def embed_spans(stream: np.ndarray, start: np.ndarray, length: np.ndarray,
                table: np.ndarray, device="cpu",
                words: int = 1 << 22) -> np.ndarray:
    """f64 [R, d]: the mean row of `table` over stream[start:start+length]
    of each span, on `device` in blocks of about `words` words."""
    dev = torch.device(device)
    t = torch.from_numpy(np.asarray(table, np.float64)).to(dev)
    out = np.zeros((len(start), t.shape[1]))
    a = 0
    while a < len(start):
        b = a + max(1, int(np.searchsorted(
            np.cumsum(length[a:]), words, side="right")))
        n = length[a:b]
        pos = (np.repeat(start[a:b] - np.cumsum(n) + n, n)
               + np.arange(int(n.sum())))
        row = torch.from_numpy(np.repeat(np.arange(b - a), n)).to(dev)
        ids = torch.from_numpy(np.asarray(stream[pos], np.int64)).to(dev)
        s = torch.zeros((b - a, t.shape[1]), dtype=torch.float64, device=dev)
        s.index_add_(0, row, t[ids])
        out[a:b] = (s / torch.from_numpy(np.maximum(n, 1)).to(dev)[:, None]
                    ).cpu().numpy()
        a = b
    return out


def _pad(x: np.ndarray, width: int) -> np.ndarray:
    """x [n, d] with zero columns up to `width`."""
    out = np.zeros((len(x), width), x.dtype)
    out[:, :x.shape[1]] = x
    return out


def normalized(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-300)


# -- the lists --------------------------------------------------------------

def lexical_page(ref: bm25f.BM25F, query: str, qtype: str, need: int):
    """(doc ids, f32 scores) of the exact top-`need` lexical page, and the
    scores of every doc (-inf where it does not match)."""
    sc, _ = ref.scores(query, qtype)
    finite = np.flatnonzero(np.isfinite(sc))
    if len(finite) > need:
        # every doc at or above the need-th score, then the exact order
        cut = np.partition(sc[finite], len(finite) - need)[len(finite) - need]
        finite = finite[sc[finite] >= cut]
    order = np.lexsort((finite, -sc[finite]))[:need]
    return finite[order], sc[finite[order]], sc


class VectorLists:
    """Every chunk row of the committed docs and of the tail, with its doc,
    and the top distinct docs by each doc's best chunk."""

    def __init__(self, committed: np.ndarray, committed_doc: np.ndarray,
                 tail: np.ndarray, tail_doc: np.ndarray,
                 precision: str = "exact"):
        levels = {"exact": None, "i8": 255, "4bit": 15}[precision]
        self.levels = levels
        c, t = normalized(committed), normalized(tail)
        if levels is not None:
            self.width = -(-c.shape[1] // 128) * 128
            c = dequantize(_pad(c, self.width).astype(np.float32), levels)
            t = _pad(t, self.width).astype(np.float32)
        self.rows = np.concatenate([c, t]) if len(t) else c
        self.doc = np.concatenate([np.asarray(committed_doc, np.int64),
                                   np.asarray(tail_doc, np.int64)])
        self.n_committed = len(c)
        counts = np.bincount(self.doc) if len(self.doc) else np.zeros(1)
        self.max_rows_per_doc = int(counts.max())

    def queries(self, q: np.ndarray) -> np.ndarray:
        """The queries as the rows they are scored against: normalized,
        and through the committed rows' quantizer (the tail rows meet the
        exact query)."""
        qn = normalized(q)
        if self.levels is None:
            return qn, qn
        qp = _pad(qn, self.width)
        return dequantize(qp.astype(np.float32), self.levels).astype(
            np.float64), qp

    def doc_scores(self, q: np.ndarray, docs) -> dict:
        """{doc: (best, worst)}: the highest and the lowest score of the
        query `q` (one row) against each doc's chunk rows; a doc with no
        row is left out."""
        qc, qt = self.queries(np.asarray(q)[None])
        out = {}
        for d in docs:
            a, b = np.searchsorted(self.doc, [d, d + 1])
            if a == b:
                continue
            s = np.where(np.arange(a, b) < self.n_committed,
                         self.rows[a:b].astype(np.float64) @ qc[0],
                         self.rows[a:b].astype(np.float64) @ qt[0])
            out[int(d)] = (float(s.max()), float(s.min()))
        return out

    def top(self, q: np.ndarray, need: int, device="cpu",
            rows: int = 1 << 18, block: int = 512):
        """Per query (doc ids i64[<= need], scores f64): the top-`need`
        docs by their best chunk's score, (score desc, doc asc).  The
        rows are scanned in blocks keeping each query's best m rows,
        m = (need - 1) * max_rows_per_doc + 1: enough to hold the best
        chunk of `need` distinct docs."""
        dev = torch.device(device)
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            qc, qt = self.queries(q)
            m = min((need - 1) * self.max_rows_per_doc + 1, len(self.rows))
            out = []
            for a in range(0, len(qc), block):
                qa = torch.from_numpy(qc[a:a + block]).to(dev)
                qb = torch.from_numpy(qt[a:a + block]).to(dev)
                best_s = torch.full((len(qa), 0), float("-inf"),
                                    dtype=torch.float64, device=dev)
                best_r = torch.zeros((len(qa), 0), dtype=torch.int64,
                                     device=dev)
                for r0 in range(0, len(self.rows), rows):
                    x = torch.from_numpy(self.rows[r0:r0 + rows]).to(
                        dev, torch.float64)
                    tail = r0 >= self.n_committed
                    s = (qb if tail else qa) @ x.T
                    if not tail and r0 + len(x) > self.n_committed:
                        cut = self.n_committed - r0
                        s[:, cut:] = qb @ x[cut:].T
                    ids = torch.arange(r0, r0 + len(x), device=dev)
                    cs = torch.cat([best_s, s], 1)
                    cr = torch.cat([best_r, ids.expand(len(qa), -1)], 1)
                    k = min(m, cs.shape[1])
                    best_s, pick = cs.topk(k, dim=1)
                    best_r = cr.gather(1, pick)
                    del x, s, cs, cr
                bs, br = best_s.cpu().numpy(), best_r.cpu().numpy()
                for s, r in zip(bs, br):
                    d = self.doc[r]
                    order = np.lexsort((d, -s))
                    d, s = d[order], s[order]
                    _, first = np.unique(d, return_index=True)
                    first = np.sort(first)[:need]
                    out.append((d[first], s[first]))
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def fuse(lex_ids, vec_ids, length: int):
    """(doc ids, f64 scores) of the RRF page of two ranked lists."""
    fused: dict[int, float] = {}
    for ids in (lex_ids, vec_ids):
        for rank, d in enumerate(np.asarray(ids).tolist()):
            fused[d] = fused.get(d, 0.0) + 1.0 / (RRF_K + rank)
    ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:length]
    return ([d for d, _ in ranked], [s for _, s in ranked])
