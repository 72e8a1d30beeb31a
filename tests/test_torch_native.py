"""``tests/test_native.py::test_native_realtime_and_phrase`` on the draw
that fails it in the full run, through both packages.

That test takes its 150 documents from the session-scoped ``rng`` fixture,
so its data depends on the tests that drew before it on its worker.  With
``tests/test_facets.py`` run first (``pytest tests/test_facets.py
tests/test_native.py -p no:randomly``), the generator holds RNG_STATE when
it starts, and its Intersection check of 'w002 w003' fails: the page holds
doc 65, which its brute force does not put in the top 10.

The brute force of ``tests/test_lexical.py`` averages the document length
over every document, the uncommitted tail included, while the engine (and
SeekStorm, commit.rs:321) updates the average only at commit.  Held to a
brute force that uses the committed average, the engine's pages are exact:
ids equal, scores within 1e-6.  So the reference test's two tolerances
disagree (scores within 2% of the all-docs oracle, ids within 1e-3 of its
scores); the port's pages and counts equal the reference's bit for bit.
"""

import numpy as np
import pytest

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from test_lexical import BruteForce, make_docs, std_schema
from test_torch_search import _to_port

# the session rng (default_rng(42)) after tests/test_facets.py's draws
RNG_STATE = {
    "bit_generator": "PCG64",
    "state": {"state": 212002132190279345615833010798803380220,
              "inc": 332724090758049132448979897138935081983},
    "has_uint32": 0, "uinteger": 3251070550}
QUERIES = [("w001 w004", "Union"), ("w002 w003", "Intersection"),
           ("w001 w002", "Phrase")]


class _CommittedAvg(BruteForce):
    """The brute force with the engine's average document length: the
    committed documents' (the first n_committed of the one shard)."""

    def __init__(self, index, docs, n_committed):
        super().__init__(index, docs)
        self.n_committed = n_committed

    def _shard_stats(self, sdocs):
        norm_lens, _ = super()._shard_stats(sdocs)
        _, avg = super()._shard_stats(sdocs[: self.n_committed])
        return norm_lens, avg


def _top(expected, k=10):
    return sorted(expected.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    rng = np.random.default_rng()
    rng.bit_generator.state = RNG_STATE
    docs = make_docs(rng, 150)
    path = tmp_path_factory.mktemp("c1")
    ref = st.create_index(path / "ref", std_schema())
    port = pt.create_index(path / "port", [
        pt.SchemaField("title", pt.FieldType.Text, stored=True, indexed=True,
                       boost=10.0),
        pt.SchemaField("body", pt.FieldType.Text, stored=True,
                       indexed=True)], device="cpu")
    for idx in (ref, port):
        idx.index_documents(docs[:100])
        idx.commit()
        idx.index_documents(docs[100:])
    return ref, port, docs


@pytest.mark.parametrize("query,qtype", QUERIES)
def test_realtime_pages_exact_under_the_committed_average(pair, query,
                                                          qtype):
    ref, port, docs = pair
    req = st.SearchRequest(query=query, length=10,
                           query_type_default=st.QueryType(qtype),
                           result_type=st.ResultType.TopkCount)
    want = ref.search(req)
    got = pt.search(port, _to_port(req), device="cpu")
    assert got.result_count_total == want.result_count_total
    assert [(r.doc_id, r.score) for r in got.results] == \
        [(r.doc_id, r.score) for r in want.results]

    exact = _CommittedAvg(ref, docs, 100).score(query, qtype)
    assert got.result_count_total == len(exact)
    top = _top(exact)
    assert [r.doc_id for r in got.results] == [g for g, _ in top]
    np.testing.assert_allclose([r.score for r in got.results],
                               [s for _, s in top], rtol=1e-6)


def test_all_docs_average_moves_the_intersection_page(pair):
    """The draw's fault: under the all-docs average the brute force's top
    10 of 'w002 w003' (Intersection) differs from the engine's page, which
    holds doc 65."""
    ref, port, docs = pair
    req = pt.SearchRequest(query="w002 w003", length=10,
                           query_type_default=pt.QueryType.Intersection,
                           result_type=pt.ResultType.TopkCount)
    page = [r.doc_id for r in pt.search(port, req, device="cpu").results]
    loose = [g for g, _ in _top(BruteForce(ref, docs).score(
        "w002 w003", "Intersection"))]
    assert 65 in page and 65 not in loose
