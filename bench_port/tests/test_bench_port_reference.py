"""The plain references against brute force at a tiny size."""

import math

import numpy as np
import pytest

from gen import corpus, vectors
from reference import bm25f
from reference.vectors import VectorReference, dequantize


def _brute_bm25f(docs, query, qtype, boosts, n_committed):
    """Per-document BM25F straight from the texts, in float64."""
    toks = [[d["title"].split(), d["body"].split()] for d in docs]
    lens = [[bm25f.DECODED[bm25f.length_codes(len(f))] for f in t]
            for t in toks]
    avg = sum(sum(x) for x in lens[:n_committed]) / n_committed
    terms = list(dict.fromkeys(query.split()))
    n = len(docs)
    out = {}
    for i, t in enumerate(toks):
        hits = [w for w in terms if any(w in f for f in t)]
        if not hits or (qtype == "Intersection" and len(hits) < len(terms)):
            continue
        s = 0.0
        for w in hits:
            df = sum(any(w in f for f in tt) for tt in toks)
            idf = math.log1p((n - df + 0.5) / (df + 0.5))
            for f in range(2):
                tf = t[f].count(w)
                comp = 1.2 * (1 - 0.75 + 0.75 * lens[i][f] / avg)
                s += idf * boosts[f] * tf * 2.2 / (tf + comp)
        out[i] = s
    return out


def test_bm25f_equals_brute_force():
    rng = np.random.default_rng(4)
    c = corpus.corpus_tokens(400, 60, rng)
    t = corpus.corpus_tokens(30, 60, rng)
    docs = corpus.docs_from_tokens(*c) + corpus.docs_from_tokens(*t)
    ref = bm25f.BM25F(bm25f.postings(*c, 60), bm25f.postings(*t, 60),
                      [10.0, 1.0])
    for q, qt in [("w00003 w00017", "Union"), ("w00003 w00017",
                                               "Intersection"),
                  ("w00040", "Union"), ("w00005 w00005", "Intersection"),
                  ("w00059 w00001", "Union")]:
        want = _brute_bm25f(docs, q, qt, [10.0, 1.0], 400)
        sc, count = ref.scores(q, qt)
        assert count == len(want)
        got = {int(i): float(sc[i]) for i in np.flatnonzero(np.isfinite(sc))}
        assert got.keys() == want.keys()
        for i in want:
            assert got[i] == pytest.approx(want[i], rel=2e-6)
        ids, s = bm25f.page(sc, 10)
        order = sorted(want, key=lambda i: (-want[i], i))[:10]
        assert [want[i] for i in ids] == pytest.approx(
            [want[i] for i in order], rel=2e-6)


def test_bf16_rounds_to_eight_bits():
    x = np.array([1.0, 1 + 2**-7, 1 + 2**-8, 1 + 3 * 2**-8, 3.14159,
                  -2.5e-3], np.float32)
    y = bm25f.bf16(x)
    # 7 stored mantissa bits; halfway cases go to the even neighbour
    assert list(y[:4]) == [1.0, 1 + 2**-7, 1.0, 1 + 2**-6]
    assert np.all(np.abs(y - x) <= np.abs(x) * 2**-8)
    assert np.all((y.view(np.uint32) & 0xFFFF) == 0)


def test_length_codes_invert_decoding():
    lens = np.arange(0, 5000)
    codes = bm25f.length_codes(lens)
    assert np.all(bm25f.DECODED[codes] <= lens)
    assert np.all(bm25f.DECODED[np.minimum(codes.astype(int) + 1, 255)]
                  > np.minimum(lens, bm25f.DECODED[-1] - 1))


@pytest.fixture(scope="module")
def vec():
    centers = vectors.proxy_centers("sift", 11)
    base = vectors.rows_near("sift", centers, 3000, np.random.default_rng(1))
    tail = vectors.rows_near("sift", centers, 50, np.random.default_rng(2))
    q = vectors.rows_near("sift", centers, 8, np.random.default_rng(3))
    return base, tail, q


def test_truth_equals_brute_force(vec):
    base, tail, q = vec
    ref = VectorReference(base, tail)
    allx = np.concatenate([base, tail]).astype(np.float64)
    d2 = ((allx[None] - q[:, None].astype(np.float64)) ** 2).sum(-1)
    assert np.array_equal(ref.truth(q, 10, rows=700),
                          np.sort(d2, axis=1)[:, 9])


@pytest.mark.parametrize("levels", [255, 15])
def test_distances_and_exhaustive_pages(vec, levels):
    base, tail, q = vec
    ref = VectorReference(base, tail, levels)
    qh = dequantize(q, levels).astype(np.float64)
    xh = dequantize(base, levels).astype(np.float64)
    for j in range(len(q)):
        want = np.concatenate([
            np.sqrt(((xh - qh[j]) ** 2).sum(1)),
            np.sqrt(((tail.astype(np.float64) - q[j]) ** 2).sum(1))])
        ids = np.arange(len(want))
        assert np.allclose(ref.distances(q[j], ids), want, rtol=1e-12)
        i, d = ref.exhaustive_pages(q[j:j + 1], 10, rows=1000)
        order = np.lexsort((ids, want))[:10]
        assert np.allclose(d[0], want[order], rtol=1e-9)
        assert np.allclose(want[i[0]], want[order], rtol=1e-9)


def test_dequantize_is_the_affine_i8_scheme():
    x = np.array([[0.0, 10.0, 255.0, 37.0]], np.float32)
    xh = dequantize(x)
    assert xh[0, 0] == 0.0 and xh[0, 2] == 255.0
    assert np.max(np.abs(xh - x)) <= 0.5
    assert len(np.unique(dequantize(np.linspace(0, 1, 200, dtype=np.float32)
                                    [None], 15))) == 16
