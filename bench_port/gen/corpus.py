"""The corpus generator of the repository's root ``bench.py``, copied so
that the yardstick does not move when the program does (its query generator
is ``gen.traffic.text_queries``).

``make_corpus`` gives, for a generator in a given state, the documents that
``bench.make_corpus`` gives (the tests hold them equal at small sizes).
``make_corpus`` draws in the original's order and only builds the strings
faster: every word is ``w`` and five digits, so a field is a run of
fixed-width cells.  ``corpus_tokens`` returns the same draws as arrays, which
the plain reference reads instead of parsing the strings again.
"""

from __future__ import annotations

import numpy as np


def corpus_tokens(n_docs: int, vocab: int, rng):
    """(title_len i64[n], body_len i64[n], stream i32[total]): the word ids
    of ``bench.make_corpus``, title words first in each document.

    Zipf rank-frequency vocabulary, lognormal body lengths and bursty
    repeats (about 25% of positions copy an earlier word of the document)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    title_len = rng.integers(3, 9, size=n_docs)
    body_len = np.clip(
        np.exp(rng.normal(np.log(35.0), 0.6, size=n_docs)), 8, 300
    ).astype(np.int64)
    total = int(title_len.sum() + body_len.sum())
    stream = rng.choice(vocab, size=total, p=probs).astype(np.int32)
    doc_len = title_len + body_len
    starts = np.zeros(n_docs, np.int64)
    np.cumsum(doc_len[:-1], out=starts[1:])
    pos_in_doc = np.arange(total, dtype=np.int64) - np.repeat(starts, doc_len)
    burst = (rng.random(total) < 0.25) & (pos_in_doc > 0)
    src = (np.repeat(starts, doc_len)
           + (rng.random(total) * pos_in_doc).astype(np.int64))
    stream[burst] = stream[src[burst]]
    return title_len, body_len, stream


def _text_cells(stream: np.ndarray) -> bytes:
    """Each word id as the 7 bytes ``wNNNNN `` (vocabularies under 100,000)."""
    if len(stream) and int(stream.max()) >= 100_000:
        raise ValueError("word ids must have at most five digits")
    cells = np.empty((len(stream), 7), np.uint8)
    cells[:, 0] = ord("w")
    v = stream.astype(np.int64)
    for j, div in enumerate((10_000, 1_000, 100, 10, 1)):
        cells[:, 1 + j] = 48 + (v // div) % 10
    cells[:, 6] = ord(" ")
    return cells.tobytes()


def docs_from_tokens(title_len, body_len, stream) -> list[dict]:
    """The ``{"title", "body"}`` documents that the word ids spell."""
    buf = _text_cells(stream)
    docs = []
    pos = 0
    for tl, bl in zip(title_len.tolist(), body_len.tolist()):
        a, b, c = 7 * pos, 7 * (pos + tl), 7 * (pos + tl + bl)
        docs.append({"title": buf[a:b - 1].decode("ascii"),
                     "body": buf[b:c - 1].decode("ascii")})
        pos += tl + bl
    return docs


def make_corpus(n_docs: int, vocab: int, rng) -> list[dict]:
    """``bench.make_corpus``: the same documents for the same generator."""
    return docs_from_tokens(*corpus_tokens(n_docs, vocab, rng))
