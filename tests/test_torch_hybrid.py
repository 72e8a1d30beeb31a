"""Hybrid search of the torch port (``SearchMode.Hybrid``: BM25F and the
index's own Model2Vec chunk vectors fused by RRF) on the CPU against the
benchmark's plain reference, ``bench_port/reference/hybrid.py``, on a
seeded generated corpus and a seeded random embedding table.

  * ``ann_mode`` All: the fused pages equal the reference's (ids exact,
    scores within 1e-6) for Union, Intersection and one-term queries, with
    and without the realtime tail.
  * Two words a chunk: a doc has more rows than the scan's first k rows
    can hold distinct, and the vector list is still the exact top-20
    distinct docs by best chunk, on one device and on a mesh.
  * ``ann_mode`` Nprobe: the fused page's recall@10 stays within the
    hybrid cell's ``miss_share`` limit.
  * The hybrid timers and the vector counters advance; ``Model2Vec.encode``
    is bit for bit the per-text mean.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import seekstorm_tpu_torch as pt
from seekstorm_tpu_torch.inference import Model2Vec, chunk_text

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from gen import corpus, traffic  # noqa: E402
from reference import bm25f, hybrid  # noqa: E402

VOCAB, DIM, NEED = 400, 16, 20
MIX = dict(union2_below=0.55, intersection2_below=0.85, rank_lo=3,
           rank_hi=300)
CELL = json.loads((BENCH / "workloads" / "wikihybrid1m.rrf_b128.json")
                  .read_text())


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A Model2VecCustom directory: a seeded table and the generator's
    words."""
    p = tmp_path_factory.mktemp("m2v")
    table = np.random.default_rng(5).standard_normal(
        (VOCAB, DIM)).astype(np.float32)
    np.save(p / "embeddings.npy", table)
    (p / "vocab.json").write_text(json.dumps(
        {f"w{i:05d}": i for i in range(VOCAB)}))
    return p, table


class Built:
    """The port's index of generated docs (committed, then an uncommitted
    tail) and the plain reference over the same docs."""

    def __init__(self, path, model, chunk_size, clustering="Null",
                 n_docs=600, n_tail=60, shards=1, mesh=0, make=None):
        p, self.table = model
        if make is None:
            self.committed = corpus.corpus_tokens(n_docs, VOCAB,
                                                  np.random.default_rng(7))
            self.tail = corpus.corpus_tokens(n_tail, VOCAB,
                                             np.random.default_rng(8))
        else:
            self.committed, self.tail = make(n_docs, n_tail)
        self.chunk_size = chunk_size
        schema = [pt.SchemaField("title", pt.FieldType.Text, indexed=True,
                                 boost=10.0),
                  pt.SchemaField("body", pt.FieldType.Text, indexed=True,
                                 index_vector=True)]
        meta = pt.IndexMeta(vector=pt.VectorConfig(
            enabled=True, dim=DIM, similarity=pt.VectorSimilarity.Cosine,
            precision=pt.Precision.F32, quantization=pt.Quantization.Null,
            inference=pt.InferenceType.Model2VecCustom, model=str(p),
            chunk_size=chunk_size, clustering=pt.ClusteringConfig(
                mode=pt.ClusteringMode[clustering])))
        self.idx = pt.create_index(path, schema, meta=meta,
                                   shard_count=shards, device="cpu")
        self.idx.index_documents(corpus.docs_from_tokens(*self.committed))
        self.idx.commit()
        self.idx.index_documents(corpus.docs_from_tokens(*self.tail))
        if mesh:
            self.idx.attach_mesh(["cpu"] * mesh)

    def lexical(self, realtime: bool):
        empty = bm25f.Postings(
            term_off=np.zeros(VOCAB + 1, np.int64), doc=np.zeros(0, np.int32),
            tf=np.zeros((0, 2), np.uint16), codes=np.zeros((0, 2), np.uint8))
        return bm25f.BM25F(bm25f.postings(*self.committed, VOCAB),
                           bm25f.postings(*self.tail, VOCAB) if realtime
                           else empty, [10.0, 1.0])

    def vectors(self, realtime: bool):
        parts = []
        for arrays, first in ((self.committed, 0),
                              (self.tail, len(self.committed[0]))):
            title_len, body_len, stream = arrays
            body_at = np.cumsum(title_len + body_len) - body_len
            doc, start, n = hybrid.chunk_spans(body_len, self.chunk_size)
            parts.append((hybrid.embed_spans(stream, body_at[doc] + start, n,
                                             self.table), doc + first))
        (c, c_doc), (t, t_doc) = parts
        if not realtime:
            t, t_doc = t[:0], t_doc[:0]
        return hybrid.VectorLists(c, c_doc, t, t_doc)

    def query_vectors(self, queries):
        vocab = {f"w{i:05d}": i for i in range(VOCAB)}
        return hybrid.embed_ids([hybrid.tokens(q, vocab) for q in queries],
                                self.table)

    def expected(self, queries, realtime: bool, length: int = 10):
        """The reference's fused pages of (query, type) pairs."""
        lex = self.lexical(realtime)
        vec = self.vectors(realtime).top(
            self.query_vectors([q for q, _ in queries]), NEED)
        return [hybrid.fuse(hybrid.lexical_page(lex, q, t, NEED)[0],
                            v[:NEED], length)
                for (q, t), (v, _) in zip(queries, vec)]

    def search(self, queries, realtime: bool, mode, **kw):
        kw = {"length": 10, "ann_mode": "All", **kw}
        return pt.search_batch(self.idx, [pt.SearchRequest(
            query=q, query_type_default=t, search_mode=mode,
            realtime=realtime, **kw) for q, t in queries], device="cpu")


def _repetitive(n_docs, n_tail):
    """corpus_tokens-like arrays of committed and tail docs whose bodies
    repeat three words of their own, no two docs sharing one, 20-60 times:
    every chunk of a doc is near its others, and no two docs' chunks are
    equal."""
    rng = np.random.default_rng(9)
    n = n_docs + n_tail
    assert 3 * n <= VOCAB
    own = rng.permutation(VOCAB)[:3 * n].reshape(n, 3)
    title_len = np.full(n, 3, np.int64)
    body_len = rng.integers(20, 61, n)
    stream = np.concatenate([np.r_[w, rng.choice(w, b)]
                             for w, b in zip(own, body_len)]).astype(np.int32)
    cut = int((title_len + body_len)[:n_docs].sum())
    return ((title_len[:n_docs], body_len[:n_docs], stream[:cut]),
            (title_len[n_docs:], body_len[n_docs:], stream[cut:]))


def _queries(n, seed, kind=None):
    qs = traffic.text_queries(n, np.random.default_rng(seed), MIX)
    if kind == "one":
        return [(q, t) for q, t in qs if " " not in q]
    return [(q, t) for q, t in qs if " " in q and t == kind]


@pytest.fixture(scope="module")
def built(tmp_path_factory, model):
    return Built(tmp_path_factory.mktemp("hy") / "ix", model, 105)


@pytest.mark.parametrize("realtime", [True, False], ids=["tail", "committed"])
@pytest.mark.parametrize("kind", ["Union", "Intersection", "one"])
def test_fused_pages_equal_the_reference(built, kind, realtime):
    queries = _queries(120, 31, kind)[:16]
    assert len(queries) >= 8
    got = built.search(queries, realtime, mode=pt.SearchMode.Hybrid)
    for rs, (ids, scores) in zip(got, built.expected(queries, realtime)):
        assert [r.doc_id for r in rs.results] == ids
        np.testing.assert_allclose([r.score for r in rs.results], scores,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("shards,mesh", [(1, 0), (2, 2)],
                         ids=["one_device", "mesh"])
def test_two_word_chunks_keep_twenty_distinct_docs(tmp_path, model, shards,
                                                   mesh):
    """Bodies of 20-60 words, three of their own repeated, make 10-30 rows
    a doc, each near the doc's others: the scan's first 64 rows hold a few
    docs, and the list is widened until it holds 20."""
    b = Built(tmp_path / "ix", model, 14, n_docs=120, n_tail=12,
              shards=shards, mesh=mesh, make=_repetitive)
    queries = [(f"w{w:05d}", "Union") for w in b.committed[2][3:1500:125]]
    before = pt.METRICS.snapshot()
    got = b.search(queries, True, mode=pt.SearchMode.Vector, length=NEED)
    after = pt.METRICS.snapshot()
    want = b.vectors(True).top(b.query_vectors([q for q, _ in queries]),
                               NEED)
    for rs, (ids, _) in zip(got, want):
        assert [r.doc_id for r in rs.results] == ids.tolist()
    assert after.get("vector_widened_total", 0) > before.get(
        "vector_widened_total", 0)


def test_nprobe_recall_within_the_cell_limit(tmp_path, model):
    b = Built(tmp_path / "ix", model, 105, clustering="Auto", n_docs=1200)
    assert b.idx.vectors.device(b.idx.shards[0], "cpu")["n_clusters"] > 8
    queries = traffic.text_queries(64, np.random.default_rng(51), MIX)
    got = b.search(queries, True, mode=pt.SearchMode.Hybrid,
                   ann_mode="Nprobe", nprobe=4)
    want = b.expected(queries, True)
    found = sum(len({r.doc_id for r in rs.results} & set(ids))
                for rs, (ids, _) in zip(got, want))
    assert 1 - found / (10 * len(queries)) <= \
        CELL["check"]["limits"]["miss_share"]


def test_hybrid_timers_and_vector_counters_advance(built):
    queries = _queries(60, 61, "Union")[:8]
    before = pt.METRICS.snapshot()
    built.search(queries, True, mode=pt.SearchMode.Hybrid)
    after = pt.METRICS.snapshot()
    for name in ("vector_embed_seconds_total", "hybrid_fuse_seconds_total",
                 "vector_candidates_total", "vector_docs_total"):
        assert after[name] > before.get(name, 0), name
    assert (after["vector_candidates_total"]
            - before.get("vector_candidates_total", 0)) >= (
        after["vector_docs_total"] - before.get("vector_docs_total", 0))


def test_chunks_are_the_references(built):
    """The port's chunker, the reference's and its spans over the
    generator's word counts cut the generated bodies alike."""
    docs = corpus.docs_from_tokens(*built.committed)[:200]
    body_len = built.committed[1][:200]
    doc, _, n = hybrid.chunk_spans(body_len, 105)
    for i, d in enumerate(docs):
        port = chunk_text(d["body"], 105)
        assert port == hybrid.chunk(d["body"], 105)
        assert [len(c.split()) for c in port] == n[doc == i].tolist()


def test_encode_is_the_per_text_mean(model):
    p, table = model
    m = Model2Vec.load(p)
    rng = np.random.default_rng(3)
    texts = [" ".join(f"w{i:05d}" for i in rng.integers(0, VOCAB + 50, n))
             for n in rng.integers(0, 40, 300)] + ["", "unknown words"]
    got = m.encode(texts)
    for t, g in zip(texts, got):
        ids = m._token_ids(t)
        ids = ids[ids < len(table)]
        want = table[ids].mean(axis=0) if len(ids) else np.zeros(DIM)
        assert g.astype(np.float32).tobytes() == want.astype(
            np.float32).tobytes()
