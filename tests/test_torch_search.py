"""End-to-end lexical search of the torch port (seekstorm_tpu_torch) on the
CPU against the JAX package.

Two-block indexes (BLOCK_SIZE + 6000 docs) with one and two shards, deleted
docs and an uncommitted realtime tail, built twice from the same documents,
deletes and commits: a reference index (seekstorm_tpu) and a port index
(seekstorm_tpu_torch, on the CPU).  The port and the reference take the
same route, the WAND route (SEEKSTORM_TPU_WAND=1) or the dense route
(SEEKSTORM_TPU_NO_WAND=1; the default below 16 blocks), and their pages
must be equal under tests/test_wand.py's _Page (counts exact, scores within
rtol 3e-5, membership per score cluster).
"""

import dataclasses
import enum
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from test_wand import _Page, _queries

ROOT = Path(__file__).resolve().parent.parent
QUERIES = _queries() + ['"w001 w002" w003']
LONG = [" ".join(f"w{i:03d}" for i in range(3, 13)),
        "+w001 " + " ".join(f"w{i:03d}" for i in range(20, 29)) + " -w050",
        " ".join(f"w{i:03d}" for i in range(100, 111))]
# the switches of each route, set alike in both packages: the dense route
# pins the join off (the reference joins Topk batches on the CPU, and so
# does the port), and the join route is the dense route with the join on
ROUTE_ENV = {
    "wand": {"SEEKSTORM_TPU_WAND": "1"},
    "dense": {"SEEKSTORM_TPU_NO_WAND": "1", "SEEKSTORM_TPU_JOIN": "0"},
    "join": {"SEEKSTORM_TPU_NO_WAND": "1", "SEEKSTORM_TPU_JOIN": "1"},
}


def set_route(monkeypatch, route):
    for k, v in ROUTE_ENV[route].items():
        monkeypatch.setenv(k, v)


def unset_route(monkeypatch, route):
    for k in ROUTE_ENV[route]:
        monkeypatch.delenv(k)


def _docs(n, seed, vocab=250):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(vocab)])
    title = words[rng.integers(0, vocab, size=(n, 3))]
    body = words[rng.integers(0, vocab, size=(n, 18))]
    return [{"title": " ".join(a), "body": " ".join(b)}
            for a, b in zip(title, body)]


def _schema(pkg):
    return [
        pkg.SchemaField("title", pkg.FieldType.Text, indexed=True,
                        boost=10.0),
        pkg.SchemaField("body", pkg.FieldType.Text, indexed=True),
    ]


@dataclasses.dataclass
class _Pair:
    """One index per package from the same documents, deletes and commits:
    `ref` (seekstorm_tpu) and `port` (seekstorm_tpu_torch, on the CPU)."""

    ref: object
    port: object

    @property
    def shard_count(self):
        return self.ref.shard_count


def _create(pkg, path, schema, **kw):
    if pkg is pt:
        kw["device"] = "cpu"
    return pkg.create_index(path / pkg.__name__, schema, **kw)


def _build(path, shards, n=BLOCK_SIZE + 6_000, tail=700, deletes=True):
    out = []
    for pkg in (st, pt):
        idx = _create(pkg, path, _schema(pkg), shard_count=shards)
        idx.index_documents(_docs(n, 7))
        idx.commit()
        if deletes:
            idx.delete_documents(list(range(0, 50_000, 211))
                                 + [n + 3, n + 11])
        idx.index_documents(_docs(tail, 8))          # uncommitted tail
        out.append(idx)
    return _Pair(*out)


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def index(request, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("ts") / "ix", request.param)


def _requests(qtype, rtype, realtime=True, offset=0, length=10):
    return [st.SearchRequest(query=q, offset=offset, length=length,
                             result_type=rtype, realtime=realtime,
                             query_type_default=qtype) for q in QUERIES]


def _to_port(x):
    """A request (or one of its fields) as the port's own types: the same
    values, enums by value."""
    if isinstance(x, enum.Enum):
        return getattr(pt, type(x).__name__)(x.value)
    if isinstance(x, list):
        return [_to_port(y) for y in x]
    if dataclasses.is_dataclass(x):
        return getattr(pt, type(x).__name__)(**{
            f.name: _to_port(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def _pages(search, idx, reqs, monkeypatch, route=None, **env):
    """_Pages of `search` under the route's switch and extra env vars."""
    if route is not None:
        env = {**ROUTE_ENV[route], **env}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        return [_Page(rs) for rs in search(idx, reqs)]
    finally:
        for k in env:
            monkeypatch.delenv(k)


def _reference(idx, reqs, monkeypatch, route=None, **env):
    return _pages(st.search_batch, idx.ref, reqs, monkeypatch, route, **env)


def _port(idx, reqs, monkeypatch, route=None, **env):
    return _pages(lambda i, r: pt.search_batch(i, r, device="cpu"), idx.port,
                  _to_port(reqs), monkeypatch, route, **env)


class _Calls:
    """Counts the calls of a function it wraps (monkeypatched in)."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.fixture
def routes(monkeypatch):
    """Counters on the port's WAND batch and dense executor."""
    from seekstorm_tpu_torch.ops import wand as pw
    from seekstorm_tpu_torch.parallel import mesh

    wand = _Calls(pw.run_batch)
    dense = _Calls(mesh.StackedIndex.run)
    monkeypatch.setattr(pw, "run_batch", wand)
    monkeypatch.setattr(mesh.StackedIndex, "run",
                        lambda self, *a, **kw: dense(self, *a, **kw))
    return wand, dense


@pytest.mark.parametrize("route", ["wand", "dense"])
@pytest.mark.parametrize("rtype", [st.ResultType.Topk,
                                   st.ResultType.TopkCount])
@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_pages_match_reference(index, qtype, rtype, route, monkeypatch,
                               routes):
    reqs = _requests(qtype, rtype)
    mine = _port(index, reqs, monkeypatch, route)
    assert sum(p.count > 0 for p in mine) > len(QUERIES) // 2 or \
        rtype == st.ResultType.Topk
    assert mine == _reference(index, reqs, monkeypatch, route)
    wand, dense = routes
    assert wand.n == (route == "wand") and (dense.n > 0) == (route == "dense")


@pytest.mark.parametrize("realtime", [False, True])
def test_deep_pages_match_reference(index, realtime, monkeypatch):
    """need = offset + length > 16: the host rung ladder serves the page."""
    reqs = _requests(st.QueryType.Union, st.ResultType.TopkCount,
                     realtime=realtime, offset=20, length=30)
    assert _port(index, reqs, monkeypatch, "wand") == \
        _reference(index, reqs, monkeypatch, "wand")


@pytest.mark.parametrize("min_blocks", [16, 1])
def test_default_route_follows_index_size(index, min_blocks, monkeypatch,
                                          routes):
    """Below WAND_MIN_BLOCKS (16) blocks a batch rides the dense path, as
    in the reference; from it on, WAND."""
    from seekstorm_tpu_torch.ops import wand as pw

    monkeypatch.setattr(pw, "WAND_MIN_BLOCKS", min_blocks)
    reqs = _requests(st.QueryType.Union, st.ResultType.TopkCount)
    assert _port(index, reqs, monkeypatch) == \
        _reference(index, reqs, monkeypatch)
    wand, dense = routes
    assert (wand.n, dense.n > 0) == ((0, True) if min_blocks == 16
                                     else (1, False))


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def undeleted(request, tmp_path_factory):
    """9,000 docs without deletes (a shard with deletes never joins), each
    term in under BITMAP_MIN docs, and an uncommitted tail."""
    return _build(tmp_path_factory.mktemp("tj") / "ix", request.param,
                  n=9_000, deletes=False)


@pytest.mark.parametrize("rtype", [st.ResultType.Topk,
                                   st.ResultType.TopkCount])
@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_join_route_matches_reference(undeleted, qtype, rtype, monkeypatch,
                                      routes):
    """The join route (SEEKSTORM_TPU_NO_WAND=1, SEEKSTORM_TPU_JOIN=1 in
    both packages): Topk batches join (a phrase keeps a whole batch off
    the join, so none is sent), TopkCount batches take the dense path;
    pages equal the reference's."""
    from seekstorm_tpu_torch.parallel import mesh

    joins = _Calls(mesh.StackedIndex.run_join)
    monkeypatch.setattr(mesh.StackedIndex, "run_join",
                        lambda self, *a, **kw: joins(self, *a, **kw))
    reqs = [r for r in _requests(qtype, rtype) if '"' not in r.query]
    mine = _port(undeleted, reqs, monkeypatch, "join")
    assert mine == _reference(undeleted, reqs, monkeypatch, "join")
    assert routes[0].n == 0
    assert joins.n == (rtype == st.ResultType.Topk)
    assert (routes[1].n > 0) == (rtype == st.ResultType.TopkCount)
    assert sum(len(p.ids) > 0 for p in mine) > len(reqs) // 2


@pytest.mark.parametrize("route", ["wand", "dense"])
@pytest.mark.parametrize("rtype", [st.ResultType.Topk,
                                   st.ResultType.TopkCount])
def test_long_queries_match_reference(index, rtype, route, monkeypatch,
                                      routes):
    """Queries of more than 8 slots ride the dense path on either route."""
    reqs = [st.SearchRequest(query=q, length=10, result_type=rtype)
            for q in QUERIES[:6] + LONG]
    mine = _port(index, reqs, monkeypatch, route)
    assert mine == _reference(index, reqs, monkeypatch, route)
    assert all(len(p.ids) == 10 for p in mine[-len(LONG):])
    assert routes[1].n > 0


@pytest.mark.parametrize("rtype", [st.ResultType.Topk,
                                   st.ResultType.TopkCount])
def test_page_past_1024_matches_reference(index, rtype, monkeypatch):
    reqs = [st.SearchRequest(query=q, offset=1990, length=20,
                             result_type=rtype) for q in QUERIES + LONG]
    mine = _port(index, reqs, monkeypatch, "wand")
    assert mine == _reference(index, reqs, monkeypatch, "wand")
    assert sum(len(p.ids) == 20 for p in mine) > len(reqs) // 2


@pytest.mark.parametrize("route", ["wand", "dense"])
def test_count_matches_reference(index, route, monkeypatch):
    """ResultType.Count: WAND's phase-1 popcount on the WAND route, the
    dense path's counts on the dense route."""
    reqs = _requests(st.QueryType.Intersection, st.ResultType.Count)
    mine = _port(index, reqs, monkeypatch, route)
    assert mine == _reference(index, reqs, monkeypatch, route)
    full = _requests(st.QueryType.Intersection, st.ResultType.TopkCount)
    assert [p.count for p in mine] == \
        [p.count for p in _port(index, full, monkeypatch, route)]
    assert sum(p.count > 0 for p in mine) > len(reqs) // 2


@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_stragglers_defer_to_dense(index, qtype, monkeypatch, routes):
    """Under SEEKSTORM_TPU_WAND_DEFER_DENSE=1 (the default from batch 512)
    UB-saturated WAND queries finish on the dense path."""
    reqs = _requests(qtype, st.ResultType.TopkCount)
    env = dict(SEEKSTORM_TPU_WAND_DEFER_DENSE="1")
    before = pt.METRICS.snapshot().get("wand_fallbacks_total", 0.0)
    mine = _port(index, reqs, monkeypatch, "wand", **env)
    assert pt.METRICS.snapshot()["wand_fallbacks_total"] > before
    wand, dense = routes
    assert wand.n == 1 and dense.n == 1
    assert mine == _reference(index, reqs, monkeypatch, "wand", **env)


@pytest.mark.parametrize("mode", ["imp", "qt"])
def test_pruned_plan_escalates(index, mode, monkeypatch):
    """Plans pruned to one block per query (both packages' limits set to
    1; QT_MIN_BLOCKS 1 for the query-tiled mode): a Topk batch whose k-th
    score falls below an unscored block bound re-runs in full, and the
    pages equal the reference's pruned dense route."""
    from seekstorm_tpu_torch import plan as pp

    sm = importlib.import_module("seekstorm_tpu.search")
    for mod in (sm, pp):
        monkeypatch.setattr(mod, "FULL_PLAN_BLOCKS", 1)
        monkeypatch.setattr(mod, "PRUNE_BLOCKS", 1)
        monkeypatch.setattr(mod, "QT_MIN_BLOCKS", 1 if mode == "qt" else 99)
    # fresh adaptive-pruning samples in both packages
    monkeypatch.delitem(index.port.__dict__, "_torch_route_stats",
                        raising=False)
    monkeypatch.setattr(index.ref, "_prune_stats", [0, 0], raising=False)
    # a phrase needs full coverage: none here
    reqs = [r for r in _requests(st.QueryType.Union, st.ResultType.Topk)
            if '"' not in r.query]
    before = pt.METRICS.snapshot().get("plan_escalations_total", 0.0)
    mine = _port(index, reqs, monkeypatch, "dense")
    escalated = pt.METRICS.snapshot().get("plan_escalations_total", 0.0) \
        - before
    assert mine == _reference(index, reqs, monkeypatch, "dense",
                              SEEKSTORM_TPU_JOIN="0")
    # one shard of two blocks prunes; two shards of one block each cannot
    assert (escalated > 0) == (index.shard_count == 1)


def test_exact_pages_match_search(index):
    """exact_pages (the host exact evaluation that chip_smoke.py holds the
    device pages against) gives the WAND path's committed pages."""
    reqs = _to_port([r for r in _requests(st.QueryType.Union,
                                          st.ResultType.TopkCount,
                                          realtime=False)
                     if '"' not in r.query])
    mine = pt.search_batch(index.port, reqs, device="cpu")
    for rs, (count, gids, scores) in zip(
            mine, pt.exact_pages(index.port, reqs, device="cpu")):
        ref = pt.ResultSet(result_count_total=count, results=[
            pt.ResultObject(doc_id=g, score=s) for g, s in zip(gids, scores)])
        assert _Page(rs) == _Page(ref)
    assert sum(rs.result_count_total > 0 for rs in mine) > len(reqs) // 2


def test_single_search_and_empty_queries(index, monkeypatch):
    req = st.SearchRequest(query="w001 w002", length=5)
    assert _Page(pt.search(index.port, _to_port(req), device="cpu")) == \
        _reference(index, [req], monkeypatch, "wand")[0]
    reqs = [st.SearchRequest(query="", length=5),
            st.SearchRequest(query="zzzunknown", length=5),
            st.SearchRequest(query="-w001", length=5)]
    mine = [_Page(rs) for rs in pt.search_batch(index.port, _to_port(reqs),
                                                device="cpu")]
    assert mine == _reference(index, reqs, monkeypatch, "wand")


def test_port_follows_commits_and_deletes(tmp_path, monkeypatch):
    """The port keys its device state (WAND pools, dense arrays) on the
    committed state: a delete or a commit after a search is seen by the
    next one.  Both routes, each on an index pair of its own."""
    for route in ("wand", "dense"):
        idx = _build(tmp_path / route, 1, n=9_000, tail=0)
        req = [pt.SearchRequest(query="w001 w002", length=10,
                                result_type=pt.ResultType.TopkCount)]
        set_route(monkeypatch, route)
        before = pt.search_batch(idx.port, req, device="cpu")[0]
        victims = [r.doc_id for r in before.results[:3]]
        for i in (idx.ref, idx.port):
            i.delete_documents(victims)
        after = pt.search_batch(idx.port, req, device="cpu")[0]
        assert after.result_count_total == before.result_count_total - 3
        assert not set(victims) & {r.doc_id for r in after.results}
        for i in (idx.ref, idx.port):
            i.index_documents(_docs(3_000, 9))
            i.commit()
        ref = st.search_batch(idx.ref, [st.SearchRequest(
            query="w001 w002", length=10,
            result_type=st.ResultType.TopkCount)])[0]
        grown = pt.search_batch(idx.port, req, device="cpu")[0]
        assert _Page(grown) == _Page(ref), route
        assert grown.result_count_total > after.result_count_total
        unset_route(monkeypatch, route)


def test_device_state_follows_clear_and_reingest(tmp_path, monkeypatch):
    """Clear an index, ingest as many other docs, commit, and search with no
    search in between: doc, block and delete counts all equal the cleared
    state's, so only the committed level objects tell the two apart.  The
    port holds those objects in its cached entries and compares them by
    identity; a key made of their addresses could serve the old pools, the
    old dense arrays and the old facet columns, because a new object may
    get the address of one that is gone.  `id` is pinned below to model
    exactly that reuse.  Both routes, with facets."""
    from seekstorm_tpu_torch.ops import wand as pw

    monkeypatch.setattr(pw, "id", lambda obj: 0, raising=False)

    def docs(seed, n=3_000):
        rng = np.random.default_rng(seed)
        out = _docs(n, seed)
        for d, b, p in zip(out, rng.integers(0, 5, n),
                           rng.integers(1, 300, n)):
            d["brand"], d["price"] = f"b{b}", int(p)
        return out

    def request(pkg):
        return pkg.SearchRequest(
            query="w001 w002", length=10,
            result_type=pkg.ResultType.TopkCount,
            query_facets=[pkg.QueryFacet(field="brand")],
            facet_filter=[pkg.FacetFilter(field="price", range=(0, 200))])

    both = []
    for pkg in (st, pt):
        idx = _create(pkg, tmp_path, _schema(pkg) + [
            pkg.SchemaField("brand", pkg.FieldType.String16, facet=True),
            pkg.SchemaField("price", pkg.FieldType.U16, facet=True)])
        idx.index_documents(docs(7))
        idx.commit()
        both.append(idx)
    idx = _Pair(*both)
    first = {}
    for route in ("wand", "dense"):     # builds the port's device state
        set_route(monkeypatch, route)
        first[route] = pt.search_batch(idx.port, [request(pt)],
                                       device="cpu")[0]
        unset_route(monkeypatch, route)
    for i in (idx.ref, idx.port):
        i.clear()
        i.index_documents(docs(8))
        i.commit()
    for route in ("wand", "dense"):
        set_route(monkeypatch, route)
        ref = st.search_batch(idx.ref, [request(st)])[0]
        mine = pt.search_batch(idx.port, [request(pt)], device="cpu")[0]
        unset_route(monkeypatch, route)
        assert _Page(mine) == _Page(ref), route
        assert mine.facets == ref.facets, route
        assert [r.doc_id for r in mine.results] != \
            [r.doc_id for r in first[route].results], route


def test_version_matches_reference():
    assert pt.__version__ == st.__version__ == "0.1.0"


def test_precompile_compiles_nothing(index):
    """The reference's Index.precompile warms XLA's compile cache; the port
    has nothing to compile ahead and says so with 0."""
    assert index.port.precompile() == 0
    assert index.port.precompile(batch_sizes=(16,), ks=(16,)) == 0


def test_warm_cache_and_rewriting_match_reference(tmp_path, monkeypatch):
    """Host paths the port copies: the frequent-word warmup cache (filled
    by commit, through the port's search_batch on the port's side) and
    query rewriting (spelling/completion)."""
    words = [f"wordstem{i:03d}" for i in range(80)]
    docs = [{"t": " ".join(["the"] * (i % 3 + 1)
                           + [words[(i + j) % 80] for j in range(4)])}
            for i in range(600)]
    both = []
    for pkg in (st, pt):
        meta = pkg.IndexMeta(
            frequent_words=pkg.FrequentwordType.English,
            spelling_correction=pkg.SpellingCorrection(
                max_dictionary_edit_distance=2, count_threshold=1),
            query_completion=pkg.QueryCompletion(
                max_completion_entries=10_000))
        schema = [pkg.SchemaField("t", pkg.FieldType.Text, stored=True,
                                  indexed=True, dictionary_source=True,
                                  completion_source=True)]
        i = _create(pkg, tmp_path, schema, meta=meta)
        i.index_documents(docs)
        i.commit()
        both.append(i)
    idx = _Pair(*both)
    assert idx.port._warmup_cache
    assert idx.port._warmup_cache.keys() == idx.ref._warmup_cache.keys()
    for h, (sc, gid, total, facets) in idx.port._warmup_cache.items():
        rsc, rgid, rtotal, rfacets = idx.ref._warmup_cache[h]
        assert total == rtotal and facets == rfacets
        np.testing.assert_array_equal(gid, rgid)
        np.testing.assert_allclose(sc, rsc, rtol=3e-5)
    word = next(iter(idx.ref.spell.words))
    typo = word[:-1] + ("x" if word[-1] != "x" else "y")
    reqs = [st.SearchRequest(query="the", realtime=False),
            st.SearchRequest(query=typo, query_rewriting={
                "SearchRewrite": {"correct": 2, "distance": 2}}),
            st.SearchRequest(query=typo, query_rewriting={
                "SearchSuggest": {"correct": 2, "distance": 2}}),
            st.SearchRequest(query=typo, query_rewriting={
                "SuggestOnly": {"correct": 2, "complete": 2}})]
    for req in reqs:
        mine = pt.search(idx.port, _to_port(req), device="cpu")
        monkeypatch.setenv("SEEKSTORM_TPU_WAND", "1")
        ref = st.search(idx.ref, req)
        monkeypatch.delenv("SEEKSTORM_TPU_WAND")
        assert _Page(mine) == _Page(ref)
        assert mine.suggestions == ref.suggestions
    assert pt.search(idx.port, _to_port(reqs[1]),
                     device="cpu").result_count_total > 0


def test_reference_index_methods_untouched():
    """Each package binds Index.search/search_batch to its own functions,
    on its own Index class."""
    assert st.Index is not pt.Index
    assert st.Index.search.__code__.co_filename.endswith(
        os.path.join("seekstorm_tpu", "search.py"))
    assert pt.Index.search_batch.__code__.co_filename.endswith(
        os.path.join("seekstorm_tpu_torch", "search.py"))
    assert st.search_batch is not pt.search_batch


def test_cuda_without_card_raises(index, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.search_batch(index.port, [pt.SearchRequest(query="w001")])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.search(index.port, pt.SearchRequest(query="w001"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.create_index(tmp_path / "ix", _schema(pt))


@pytest.mark.parametrize("kw, served", [
    (dict(search_mode=st.SearchMode.Vector), "requires query_vector"),
    (dict(query_facets=[st.QueryFacet(field="title")]),
     "'title' is not a facet"),
    (dict(facet_filter=[st.FacetFilter(field="title", values=["x"])]),
     "'title' is not a facet"),
    (dict(result_sort=[st.ResultSort(field="title")]),
     "'title' is not a facet"),
    (dict(field_filter=["title"]), True),
    (dict(result_type=st.ResultType.Count), True),
    (dict(offset=1000, length=100), True),
    (dict(query=" ".join(f"w{i:03d}" for i in range(9))), True),
], ids=["vector", "facets", "filter", "sort", "field_filter", "count",
        "deep", "slots"])
def test_out_of_scope_raises(index, kw, served, monkeypatch):
    """Requests the port once refused with NotImplementedError: Count,
    pages past 1024 and more than 8 slots until the dense path came,
    facets, facet filters and sorting until their slice, field_filter until
    the tf path (tests/test_torch_tf.py), vector search until its slice
    (tests/test_torch_vector.py).  Now the port does what the reference
    does: it serves them, and raises the reference's ValueError for a field
    that is no facet field (this fixture has none;
    tests/test_torch_facets.py has) and for a vector request without a
    query vector on an index without a model (this one has no vectors)."""
    req = st.SearchRequest(**{"query": "w001 w002", **kw})
    if served is True:
        mine = _port(index, [req], monkeypatch)
        assert mine == _reference(index, [req], monkeypatch)
        assert mine[0].count > 0
        return
    for search, idx, r in (
            (st.search_batch, index.ref, req),
            (lambda i, rq: pt.search_batch(i, rq, device="cpu"),
             index.port, _to_port(req))):
        with pytest.raises(ValueError, match=served):
            search(idx, [r])


# refuses jax and the JAX package (seekstorm_tpu, not seekstorm_tpu_torch)
BLOCK_JAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name in ("jax", "seekstorm_tpu")
                or name.startswith(("jax.", "jaxlib", "seekstorm_tpu."))):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""

_NO_JAX = BLOCK_JAX + r"""
import seekstorm_tpu_torch as pt
idx = pt.create_index(sys.argv[1], [
    pt.SchemaField("title", pt.FieldType.Text, indexed=True, boost=10.0),
    pt.SchemaField("body", pt.FieldType.Text, indexed=True)], device="cpu")
idx.index_documents([{"title": f"t{i % 7} x", "body": f"b{i % 13} y"}
                     for i in range(2000)])
idx.commit()
idx.index_documents([{"title": "t1 tail", "body": "b2"}])
req = [pt.SearchRequest(query="t1 b2", length=5)]
rs = pt.search_batch(idx, req, device="cpu")[0]
assert rs.result_count_total > 0 and len(rs.results) == 5, rs
reopened = pt.open_index(sys.argv[1], device="cpu")
again = reopened.search_batch(req)[0]
assert again.result_count_total == rs.result_count_total - 1, again
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "seekstorm_tpu")]
print("ok", rs.result_count_total)
"""


def _run_blocked(script, *args):
    """Run `script` in a fresh interpreter at the repository root."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    return subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_runs_without_jax(tmp_path):
    """Index, commit, reopen and search with jax and seekstorm_tpu
    blocked; no module of either is loaded at the end."""
    out = _run_blocked(_NO_JAX, str(tmp_path / "ix"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
