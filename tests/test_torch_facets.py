"""Facet counts, facet filters and sorted results of the torch port
(seekstorm_tpu_torch) on the CPU against the JAX package.

Every behaviour of tests/test_facets.py as a parity test: the same
documents (made from a seed with numpy) and the same requests go through
``seekstorm_tpu.search_batch`` and ``seekstorm_tpu_torch.search_batch`` on
the CPU, on the WAND route (SEEKSTORM_TPU_WAND=1; sorted batches with
SEEKSTORM_TPU_WAND_SORT=1) and on the dense route (SEEKSTORM_TPU_NO_WAND=1),
set for both packages, with one and two shards.  Tolerances: facet lists,
counts, page ids and their order are exact; sort keys are exact (both
packages compute them on the host with the same numpy code); scores agree
within rtol 3e-5, the bound of the search parity tests (the reference's
XLA sums may contract a mul+add into an fma).

Then the kernel modules: the plain facet histogram (``facet_hist_ref``, the
version kernel K3 is held equal to on the card) against the reference's two
forms, ``lexical._facet_update`` and the histogram of ``wand._scan_local``,
in both of their code-space branches and with out-of-range codes; phase 1's
matched words against its counts and UBs; the rank-by-key rungs against the
reference's; the dense scan's matched words and sort-key top-k; and the K3
wrapper's checks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from seekstorm_tpu_torch.ops import dense_scan as ds
from seekstorm_tpu_torch.ops import facet_hist as fh
from seekstorm_tpu_torch.ops import lexical as lx
from seekstorm_tpu_torch.ops import wand as pw
from seekstorm_tpu_torch.ops import wand_scan as ws
from test_torch_lexical import _random_pairs
from test_torch_search import _Pair, _create, _to_port, set_route
from test_torch_wand_scan import _port_scan, _synth, _t

ref_lex = importlib.import_module("seekstorm_tpu.ops.lexical")
wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")

RTOL = 3e-5
BRANDS = ["acme", "globex", "initech", "umbrella"]
RANGES = [("cheap", 0), ("mid", 100), ("lux", 300)]


def _schema(pkg):
    return [
        pkg.SchemaField("text", pkg.FieldType.Text, stored=True, indexed=True),
        pkg.SchemaField("brand", pkg.FieldType.String16, stored=True,
                        facet=True),
        pkg.SchemaField("price", pkg.FieldType.U16, stored=True, facet=True),
        pkg.SchemaField("loc", pkg.FieldType.Point, stored=True, facet=True),
    ]


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    return [{"text": f"item common t{i % 5}",
             "brand": BRANDS[int(rng.integers(0, len(BRANDS)))],
             "price": int(rng.integers(1, 500)),
             "loc": [float(rng.uniform(40, 60)), float(rng.uniform(-10, 10))]}
            for i in range(n)]


def _build(path, shards, docs, tail=(), schema=_schema, **kw):
    """One index per package from `docs` (committed) and `tail` (not)."""
    out = []
    for pkg in (st, pt):
        idx = _create(pkg, path, schema(pkg), shard_count=shards, **kw)
        idx.index_documents(docs)
        idx.commit()
        if tail:
            idx.index_documents(list(tail))
        out.append(idx)
    return _Pair(*out)


@pytest.fixture(params=["wand", "dense"])
def route(request, monkeypatch):
    """Both packages on one route; a sorted batch rides WAND on request."""
    set_route(monkeypatch, request.param)
    if request.param == "wand":
        monkeypatch.setenv("SEEKSTORM_TPU_WAND_SORT", "1")
    return request.param


@pytest.fixture(params=[1, 2], ids=["s1", "s2"])
def shards(request):
    return request.param


def _both(idx, req):
    """(reference ResultSet, port ResultSet) of one request, held equal:
    counts, facet lists and page ids exactly; sort keys exactly, scores
    within RTOL."""
    ref = st.search_batch(idx.ref, [req])[0]
    mine = pt.search_batch(idx.port, [_to_port(req)], device="cpu")[0]
    assert mine.result_count_total == ref.result_count_total
    assert mine.facets == ref.facets
    assert [r.doc_id for r in mine.results] == [r.doc_id for r in ref.results]
    a = np.array([r.score for r in mine.results], np.float64)
    b = np.array([r.score for r in ref.results], np.float64)
    if req.result_sort:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL)
    return ref, mine


def _brand_counts(docs, keep=lambda d: True):
    out = {}
    for d in docs:
        if keep(d):
            out[d["brand"]] = out.get(d["brand"], 0) + 1
    return out


def test_string_facet_counts(tmp_path, route, shards):
    docs = _docs(1, 200)
    idx = _build(tmp_path, shards, docs)
    _, mine = _both(idx, st.SearchRequest(
        query="common", query_facets=[st.QueryFacet(field="brand")]))
    assert mine.result_count_total == len(docs)
    assert dict(mine.facets["brand"]) == _brand_counts(docs)


def test_facet_counts_with_tail(tmp_path, route, shards):
    docs, extra = _docs(2, 120), _docs(3, 30)
    idx = _build(tmp_path, shards, docs, extra)
    _, mine = _both(idx, st.SearchRequest(
        query="common", query_facets=[st.QueryFacet(field="brand")]))
    assert dict(mine.facets["brand"]) == _brand_counts(docs + extra)
    assert mine.result_count_total == 150


def test_range_facet_counts(tmp_path, route, shards):
    docs = _docs(4, 200)
    idx = _build(tmp_path, shards, docs)
    ranges = st.Ranges(field="price", ranges=RANGES)
    _, mine = _both(idx, st.SearchRequest(
        query="common", query_facets=[st.QueryFacet(field="price",
                                                    ranges=ranges)]))
    exp = {"cheap": 0, "mid": 0, "lux": 0}
    for d in docs:
        p = d["price"]
        exp["cheap" if p < 100 else "mid" if p < 300 else "lux"] += 1
    assert dict(mine.facets["price"]) == {k: v for k, v in exp.items() if v}


def test_facet_filter_values_and_range(tmp_path, route, shards):
    docs = _docs(5, 200)
    idx = _build(tmp_path, shards, docs)
    cases = [
        ([st.FacetFilter(field="brand", values=["acme"])],
         lambda d: d["brand"] == "acme"),
        ([st.FacetFilter(field="price", range=(100, 200))],
         lambda d: 100 <= d["price"] <= 200),
        ([st.FacetFilter(field="brand", values=["acme", "globex"]),
          st.FacetFilter(field="price", range=(0, 250))],
         lambda d: d["brand"] in ("acme", "globex") and d["price"] <= 250),
    ]
    for filt, keep in cases:
        # with the facet lists too: the filter applies to the counts
        _, mine = _both(idx, st.SearchRequest(
            query="common", facet_filter=filt,
            query_facets=[st.QueryFacet(field="brand")]))
        assert mine.result_count_total == sum(1 for d in docs if keep(d))
        assert dict(mine.facets["brand"]) == _brand_counts(docs, keep)
        assert all(keep(docs[r.doc_id]) for r in mine.results)


def test_facet_filter_with_tail(tmp_path, route, shards):
    docs, extra = _docs(6, 80), _docs(7, 20)
    idx = _build(tmp_path, shards, docs, extra)
    _, mine = _both(idx, st.SearchRequest(
        query="common",
        facet_filter=[st.FacetFilter(field="brand", values=["umbrella"])]))
    assert mine.result_count_total == sum(
        1 for d in docs + extra if d["brand"] == "umbrella")


def test_result_sort_numeric(tmp_path, route, shards):
    docs = _docs(8, 60)
    idx = _build(tmp_path, shards, docs)
    _, mine = _both(idx, st.SearchRequest(
        query="common", length=60,
        result_sort=[st.ResultSort(field="price", order="Descending")]))
    prices = [r.score for r in mine.results]
    assert prices == sorted(prices, reverse=True) and len(prices) == 60
    assert docs[mine.results[0].doc_id]["price"] == \
        max(d["price"] for d in docs)
    _, mine = _both(idx, st.SearchRequest(
        query="common", length=10,
        result_sort=[st.ResultSort(field="price", order="Ascending")]))
    prices = [r.score for r in mine.results]
    assert prices == sorted(prices)
    assert docs[mine.results[0].doc_id]["price"] == \
        min(d["price"] for d in docs)


def test_result_sort_with_tail(tmp_path, route, shards):
    extra = [{"text": "common", "brand": "acme", "price": 9999,
              "loc": [50, 0]}]
    idx = _build(tmp_path, shards, _docs(9, 40), extra)
    _, mine = _both(idx, st.SearchRequest(
        query="common", length=5,
        result_sort=[st.ResultSort(field="price", order="Descending")]))
    assert mine.results[0].doc_id == 40 and mine.results[0].score == 9999


def test_geo_sort(tmp_path, route, shards):
    docs = _docs(10, 50)
    idx = _build(tmp_path, shards, docs)
    base = [50.0, 0.0]
    _, mine = _both(idx, st.SearchRequest(
        query="common", length=50,
        result_sort=[st.ResultSort(field="loc", order="Ascending",
                                   base=base)]))
    dists = [r.score for r in mine.results]
    assert dists == sorted(dists) and len(dists) == 50
    from seekstorm_tpu_torch.geo import euclidian_distance

    bf = [euclidian_distance(d["loc"][0], d["loc"][1], *base) for d in docs]
    assert abs(dists[0] - min(bf)) < 0.1


def test_index_level_facets(tmp_path, shards):
    docs = _docs(11, 100)
    idx = _build(tmp_path, shards, docs, _docs(12, 10))
    from seekstorm_tpu import facets as ref_facets

    top = pt.index_string_facets(idx.port, "brand")
    assert top == ref_facets.index_string_facets(idx.ref, "brand")
    assert sum(c for _, c in top) == 110
    lo, hi = pt.index_facets_minmax(idx.port, "price")
    assert (lo, hi) == ref_facets.index_facets_minmax(idx.ref, "price")
    assert lo <= min(d["price"] for d in docs) <= \
        max(d["price"] for d in docs) <= hi
    with pytest.raises(ValueError, match="not a facet field"):
        pt.index_string_facets(idx.port, "text")


def test_facets_after_delete(tmp_path, route, shards):
    docs = _docs(13, 60)
    idx = _build(tmp_path, shards, docs)
    req = st.SearchRequest(query="common",
                           query_facets=[st.QueryFacet(field="brand")])
    _both(idx, req)                 # the device state before the delete
    for i in (idx.ref, idx.port):
        i.delete_document(0)
    _, mine = _both(idx, req)
    assert dict(mine.facets["brand"]) == _brand_counts(docs[1:])


def _tag_schema(pkg):
    return [
        pkg.SchemaField("text", pkg.FieldType.Text, stored=True, indexed=True),
        pkg.SchemaField("tags", pkg.FieldType.StringSet16, stored=True,
                        facet=True),
    ]


def test_stringset_facet(tmp_path, route, shards):
    docs = [
        {"text": "common a", "tags": ["red", "blue"]},
        {"text": "common b", "tags": ["red"]},
        {"text": "common c", "tags": ["green", "blue"]},
        {"text": "common d", "tags": ["green"]},
        {"text": "common e", "tags": ["red", "green", "blue"]},
    ]
    idx = _build(tmp_path, shards, docs, schema=_tag_schema)
    req = st.SearchRequest(query="common",
                           query_facets=[st.QueryFacet(field="tags")])
    _, mine = _both(idx, req)
    assert dict(mine.facets["tags"]) == {"red": 3, "blue": 3, "green": 3}
    _, mine = _both(idx, st.SearchRequest(
        query="common",
        facet_filter=[st.FacetFilter(field="tags", values=["blue"])]))
    assert mine.result_count_total == 3
    assert {r.doc_id for r in mine.results} == {0, 2, 4}
    # a tail doc whose set of tags is new counts too
    for i in (idx.ref, idx.port):
        i.index_documents([{"text": "common f", "tags": ["blue"]}])
    _, mine = _both(idx, req)
    assert dict(mine.facets["tags"])["blue"] == 4


def test_range_count_modes(tmp_path, route, shards):
    idx = _build(tmp_path, shards, _docs(14, 100))
    got = {}
    for mode in ("CountWithinRange", "CountAboveRange", "CountBelowRange"):
        ranges = st.Ranges(field="price", range_type=mode,
                           ranges=[("low", 0), ("mid", 100), ("high", 300)])
        _, mine = _both(idx, st.SearchRequest(
            query="common",
            query_facets=[st.QueryFacet(field="price", ranges=ranges)]))
        got[mode] = dict(mine.facets["price"])
    w, a, b = (got[m] for m in ("CountWithinRange", "CountAboveRange",
                                "CountBelowRange"))
    total = w.get("low", 0) + w.get("mid", 0) + w.get("high", 0)
    assert a["low"] == total == b["high"] == 100
    assert a["high"] == w.get("high", 0) and b["low"] == w.get("low", 0)


def test_geo_distance_ranges(tmp_path, route, shards):
    docs = _docs(15, 80)
    idx = _build(tmp_path, shards, docs)
    base = [50.0, 0.0]
    ranges = st.Ranges(field="loc", base=base,
                       ranges=[("near", 0), ("far", 300)])
    _, mine = _both(idx, st.SearchRequest(
        query="common",
        query_facets=[st.QueryFacet(field="loc", ranges=ranges)]))
    from seekstorm_tpu_torch.geo import euclidian_distance

    exp = {"near": 0, "far": 0}
    for d in docs:
        dist = euclidian_distance(d["loc"][0], d["loc"][1], *base)
        exp["near" if dist < 300 else "far"] += 1
    assert dict(mine.facets["loc"]) == {k: v for k, v in exp.items() if v}


def test_empty_query_browse_with_facets(tmp_path, shards):
    docs, extra = _docs(16, 60), _docs(17, 10)
    idx = _build(tmp_path, shards, docs, extra)
    _, mine = _both(idx, st.SearchRequest(
        query="", query_facets=[st.QueryFacet(field="brand")],
        result_sort=[st.ResultSort(field="price", order="Descending")],
        length=70))
    assert mine.result_count_total == 70
    prices = [r.score for r in mine.results[:60]]
    assert all(x >= y for x, y in zip(prices, prices[1:]))
    assert dict(mine.facets["brand"]) == _brand_counts(docs + extra)
    _, mine = _both(idx, st.SearchRequest(
        query="", length=100,
        facet_filter=[st.FacetFilter(field="price", range=(0, 250))],
        query_facets=[st.QueryFacet(
            field="price", ranges=st.Ranges(field="price", ranges=RANGES))]))
    assert mine.result_count_total == sum(
        1 for d in docs + extra if d["price"] <= 250)


def test_multikey_sort(tmp_path, route):
    docs = [
        {"text": "common", "brand": "b", "price": 100, "loc": [50, 0]},
        {"text": "common", "brand": "a", "price": 100, "loc": [50, 0]},
        {"text": "common", "brand": "c", "price": 200, "loc": [50, 0]},
        {"text": "common", "brand": "d", "price": 100, "loc": [50, 0]},
    ]
    idx = _build(tmp_path, 1, docs)
    _, mine = _both(idx, st.SearchRequest(
        query="common", length=4,
        result_sort=[st.ResultSort(field="price", order="Descending"),
                     st.ResultSort(field="brand", order="Descending")]))
    # price 200 first; the ties at 100 by brand ordinal (ingest order b, a,
    # d), descending
    assert [r.doc_id for r in mine.results] == [2, 3, 1, 0]


def test_warmup_caches_facets(tmp_path, route, shards):
    """Commit's warmup caches the string-facet histograms beside the page,
    as the reference's does; a faceted one-term frequent-word query is
    served from it with no device dispatch, and a range facet is not."""
    docs = _docs(18, 200)
    both = []
    for pkg in (st, pt):
        meta = pkg.IndexMeta(frequent_words=pkg.FrequentwordType.Custom,
                             custom_frequent_words=("common",))
        i = _create(pkg, tmp_path, _schema(pkg), meta=meta,
                    shard_count=shards)
        i.index_documents(docs)
        i.commit()
        both.append(i)
    idx = _Pair(*both)
    h = next(iter(idx.port._warmup_cache))
    assert idx.port._warmup_cache.keys() == idx.ref._warmup_cache.keys()
    assert len(idx.port._warmup_cache[h]) == 4
    assert idx.port._warmup_cache[h][3] == idx.ref._warmup_cache[h][3]
    assert "brand" in idx.port._warmup_cache[h][3]

    req = st.SearchRequest(query="common", length=10, realtime=False,
                           query_facets=[st.QueryFacet(field="brand",
                                                       length=10)])
    before = pt.METRICS.snapshot().get("device_dispatch_total", 0.0)
    _, mine = _both(idx, req)
    assert pt.METRICS.snapshot().get("device_dispatch_total", 0.0) == before
    assert dict(mine.facets["brand"]) == _brand_counts(docs)
    assert mine.result_count_total == len(docs)

    ranged = st.QueryFacet(field="price", length=10, ranges=st.Ranges(
        field="price", ranges=[("lo", 0), ("hi", 250)]))
    _, mine = _both(idx, st.SearchRequest(query="common", length=10,
                                          realtime=False,
                                          query_facets=[ranged]))
    assert pt.METRICS.snapshot().get("device_dispatch_total", 0.0) > before
    assert sum(c for _, c in mine.facets["price"]) == len(docs)


# ---------------------------------------------------------------------------
# the kernel modules


def _codes(rng, nf, nblk, fcm):
    """Facet codes with some out of range on both sides."""
    codes = rng.integers(0, fcm, size=(nf, nblk * BLOCK_SIZE)).astype(np.int32)
    wild = rng.random(codes.shape) < 0.02
    codes[wild] = rng.choice([-3, fcm, fcm + 7], size=int(wild.sum()))
    return codes


@pytest.mark.parametrize("fcm", [16, 1024])
def test_facet_hist_matches_facet_update(fcm):
    """facet_hist_ref against the dense scan's lexical._facet_update, one
    block at a time: its one-hot matmul branch (fcm <= 512) and its
    scatter branch, codes clipped into [0, fcm-1] by both."""
    rng = np.random.default_rng(fcm)
    B, NF, NBLK = 6, 2, 3
    codes = _codes(rng, NF, NBLK, fcm)
    matched = rng.random((NBLK, B, BLOCK_SIZE)) < 0.01
    matched[:, 2] = False                       # a query with no match
    want = jnp.zeros((NF, B, fcm), jnp.float32)
    for b in range(NBLK):
        want = ref_lex._facet_update(want, jnp.asarray(matched[b]),
                                     jnp.asarray(codes), b, NF, fcm)
    mwords = ds.pack_words(torch.from_numpy(matched.reshape(NBLK * B, -1)))
    p = np.arange(NBLK * B)
    got = fh.facet_hist(mwords, _t((p // B).astype(np.int32)),
                        _t((p % B).astype(np.int32)), _t(codes), fcm, B)
    assert got.dtype == torch.int32 and got.shape == (NF, B, fcm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == NF * int(matched.sum()) > 0
    assert int(got[:, :, 0].sum()) > 0 and int(got[:, :, fcm - 1].sum()) > 0


@pytest.mark.parametrize("order", ["shuffled", "one_row_runs"])
def test_facet_hist_takes_any_pair_order(order):
    """The histogram depends on the set of pairs, not on their order: the
    block-major list of test_facet_hist_matches_facet_update shuffled, and
    the same pairs sorted into runs that share one output row (the WAND
    view's order, where a kernel keeps its histogram across a run), against
    lexical._facet_update, and every matched doc counted once a facet."""
    fcm = 16
    rng = np.random.default_rng(5)
    B, NF, NBLK = 6, 2, 3
    codes = _codes(rng, NF, NBLK, fcm)
    matched = rng.random((NBLK, B, BLOCK_SIZE)) < 0.01
    matched[1, 4] = False                       # a pair with no match
    want = jnp.zeros((NF, B, fcm), jnp.float32)
    for b in range(NBLK):
        want = ref_lex._facet_update(want, jnp.asarray(matched[b]),
                                     jnp.asarray(codes), b, NF, fcm)
    p = np.arange(NBLK * B)
    perm = rng.permutation(len(p)) if order == "shuffled" else \
        np.argsort(p % B, kind="stable")
    mwords = ds.pack_words(torch.from_numpy(
        matched.reshape(NBLK * B, -1)[perm]))
    p_row = (p % B)[perm].astype(np.int32)
    if order == "one_row_runs":
        assert (np.diff(p_row) >= 0).all() and len(set(p_row)) == B
    got = fh.facet_hist(mwords, _t((p // B)[perm].astype(np.int32)),
                        _t(p_row), _t(codes), fcm, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == NF * int(matched.sum()) > 0


def _ref_wand_scan(d, T, *, fcod=None, fcm=1, skeyb=None):
    """The reference's wand_scan (its XLA step, one block a scan step) on
    _synth inputs: (out, fc)."""
    V, NBLK = d["sp_prow"].shape
    Bq = d["tslot"].shape[0]
    S = d["wsh"].shape[0]
    qargs = jnp.asarray(wand_mod._pack_qargs(
        d["slotmap"], d["tslot"], d["treq"], d["tneg"], d["wsh"]))
    with_filter = d["filtw"] is not None
    return wand_mod.wand_scan(
        jnp.asarray(d["ppool"][None]), jnp.asarray(d["vpool"][None]),
        jnp.zeros((1, 1, ws.NW), jnp.uint16), jnp.zeros((1, 64), jnp.float32),
        jnp.asarray(d["sp_prow"]),
        jnp.asarray(np.full_like(d["sp_prow"], -1)),
        jnp.asarray(d["delw"]), jnp.asarray(d["sid"]), qargs,
        jnp.zeros((1, 1), jnp.int32) if fcod is None else jnp.asarray(fcod),
        jnp.asarray(d["filtw"]) if with_filter
        else jnp.zeros((1, 1), jnp.uint32),
        jnp.zeros((1, 1), jnp.float32) if skeyb is None
        else jnp.asarray(skeyb),
        V=V, Bq=Bq, T=T, S=S, with_counts=True, with_three=True, BS=1,
        PALLAS=0, NF=0 if fcod is None else fcod.shape[0], FCM=fcm,
        with_filter=with_filter, rank_by_key=skeyb is not None)


def _port_wand_scan(d, **kw):
    """The port's wand_scan on the same inputs, without the rescore."""
    pools = [_t(d["ppool"]), _t(d["vpool"]),
             torch.zeros((1, ws.NW), dtype=torch.int32), torch.zeros(64),
             _t(d["sp_prow"]), _t(np.full_like(d["sp_prow"], -1)),
             _t(d["delw"]), _t(d["sid"])]
    tq = [_t(d[k]) for k in ("slotmap", "tslot", "treq", "tneg", "wsh")]
    return pw.wand_scan(*pools, *tq, with_counts=True, with_rescore=False,
                        filtw=None if d["filtw"] is None else _t(d["filtw"]),
                        **{k: v if isinstance(v, int) else _t(v)
                           for k, v in kw.items()})


@pytest.mark.parametrize("fcm", [16, 1024])
@pytest.mark.parametrize("with_filter", [False, True], ids=["all", "filter"])
def test_wand_histogram_matches_scan_local(fcm, with_filter):
    """The WAND route's facet counts (phase 1's matched words through
    facet_hist) against the histogram wand._scan_local carries through its
    scan, with and without a facet filter; the counts stay phase 1's."""
    T = 2
    d = _synth(np.random.default_rng(40 + fcm), T=T, with_filter=with_filter)
    NBLK = d["sp_prow"].shape[1]
    codes = _codes(np.random.default_rng(fcm + 1), 2, NBLK, fcm)
    _, fc_ref = _ref_wand_scan(d, T, fcod=codes, fcm=fcm)
    (cnt, _), fc = _port_wand_scan(d, fcod=codes, fcm=fcm)
    assert fc.shape == (2, d["tslot"].shape[0], fcm)
    np.testing.assert_array_equal(fc.numpy(), np.asarray(fc_ref))
    # every facet's histogram of a query sums to the query's match count
    np.testing.assert_array_equal(fc.sum(dim=2).numpy(),
                                  np.stack([cnt.numpy()] * 2))
    assert int(cnt.sum()) > 0


@pytest.mark.parametrize("T,with_filter", [(2, False), (4, True), (8, False)])
def test_scan_matched_words(T, with_filter):
    """Phase 1's sixth output: its popcount is cnt, a bucket with a finite
    UB has a matched doc (and the other way round while every column is
    one of the first three, whose presence classes bound the bucket), and
    the other five outputs do not change with it."""
    d = _synth(np.random.default_rng(60 + T), T=T, with_filter=with_filter)
    five = _port_scan(d)
    prow = d["sp_prow"].T.copy()
    six = ws.scan_blocks(
        _t(d["ppool"]), _t(d["vpool"]), _t(prow), _t(d["delw"]),
        None if d["filtw"] is None else _t(d["filtw"]), _t(d["tslot"]),
        _t(d["treq"]), _t(d["tneg"]), _t(d["wsh"]), _t(d["sid"]),
        with_counts=True, with_matched=True)
    assert len(five) == 5 and len(six) == 6
    for a, b in zip(five, six):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    allub, cnt, mwords = six[0], six[1], six[5]
    assert mwords.dtype == torch.int32 and mwords.shape == allub.shape
    assert torch.equal(ws.popcount32(mwords).sum(dim=1, dtype=torch.int32),
                       cnt)
    finite = allub > float("-inf")
    assert bool(((mwords != 0) | ~finite).all())
    if T <= 3:
        assert torch.equal(mwords != 0, finite)
    assert int(cnt.sum()) > 0 and bool(finite.any())


def test_rank_by_key_rungs_match_reference():
    """Rank-by-key: a bucket's bound is its best sort key where a doc
    matched; the three rungs' values equal the reference's bit for bit."""
    T = 2
    d = _synth(np.random.default_rng(77), T=T)
    NBLK = d["sp_prow"].shape[1]
    skeyb = np.random.default_rng(78).normal(size=(NBLK, ws.NW)).astype(
        np.float32)                      # negative keys too (ascending)
    out, _ = _ref_wand_scan(d, T, skeyb=skeyb)
    out = np.asarray(out)
    (cnt, rungs), fc = _port_wand_scan(d, skeyb=skeyb)
    assert fc is None
    KP = pw.K_SEL + 1
    for f, (vals, _) in enumerate(rungs):
        ub_x = out[:, 2 * KP * f: 2 * KP * f + KP]
        np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                      ub_x.view(np.int32))
    assert np.isfinite(rungs[0][0].numpy()).any()
    assert (rungs[0][0].numpy() < 0).any()


def test_dense_scan_matched_words_and_rank():
    """The dense scan's matched words are its finite scores, packed, in
    both modes; with a rank key a pair's top-k is its matched docs by (key
    desc, doc asc), negative and tied keys included, as the reference's
    _topk_block orders them; scan_pairs counts facets from the words."""
    arrays, pairs, B = _random_pairs(5, True)
    P = pairs[0].shape[0]
    scores, cnt = ds.dense_scan_ref(*arrays, *pairs, B)
    matched = scores > float("-inf")
    _, _, mw = ds.dense_scan(*arrays, *pairs, B, with_matched=True)
    assert torch.equal(mw, ds.pack_words(matched))
    assert torch.equal(ds.unpack_words(mw), matched)
    assert torch.equal(ds.dense_topk(*arrays, *pairs, B, 16,
                                     with_matched=True)[3], mw)

    rng = np.random.default_rng(9)
    nblk = arrays[4].shape[0]
    rank = torch.from_numpy(
        rng.integers(-9, 0, size=nblk * BLOCK_SIZE).astype(np.float32))
    kk = 16
    codes = _t(_codes(rng, 2, nblk, 16))
    vals, docs, cnt2, fc = lx.scan_pairs(arrays, pairs, kk, B, fcod=codes,
                                         fcm=16, rank=rank)
    assert torch.equal(cnt2, cnt)
    keyed = torch.where(matched,
                        rank.view(nblk, BLOCK_SIZE)[pairs[0].long()],
                        torch.tensor(float("-inf")))
    ts, ti = ref_lex._topk_block(jnp.asarray(keyed.numpy()), kk)
    fin = np.isfinite(np.asarray(ts))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ts))
    np.testing.assert_array_equal(docs.numpy()[fin], np.asarray(ti)[fin])
    assert (docs.numpy()[~fin] == -1).all()
    assert (vals.numpy()[fin] < 0).all() and fin.any()
    want = fh.facet_hist_ref(mw, pairs[0], pairs[1], codes, 16, B)
    assert torch.equal(fc, want)
    assert torch.equal(fc.sum(dim=2), torch.stack([cnt, cnt]))
    # facets alone keep the fused mode's entries
    v0, d0, c0, _ = lx.scan_pairs(arrays, pairs, kk, B)
    v1, d1, c1, fc1 = lx.scan_pairs(arrays, pairs, kk, B, fcod=codes, fcm=16)
    assert torch.equal(v0.view(torch.int32), v1.view(torch.int32))
    assert torch.equal(d0, d1) and torch.equal(c0, c1)
    assert torch.equal(fc1, want)
    assert P > 0 and int(cnt.sum()) > 0


def test_facet_hist_refuses_other_devices():
    meta = torch.zeros((2, ws.NW), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no facet histogram"):
        fh.facet_hist(meta, None, None, None, 16, 1)


def test_k3_wrapper_checks_inputs_before_launch():
    """facet_hist_cuda refuses a wrong dtype, shape or device, sizes below
    1 and tensors on the CPU before it builds or launches anything."""
    i32 = dict(dtype=torch.int32)
    P = 3
    good = dict(mwords=torch.zeros((P, ws.NW), **i32),
                p_blk=torch.zeros(P, **i32), p_row=torch.zeros(P, **i32),
                codes=torch.zeros((2, BLOCK_SIZE), **i32))
    bad = [("mwords", good["mwords"].to(torch.int64)),
           ("mwords", torch.zeros((P, ws.NW // 2), **i32)),
           ("mwords", good["mwords"].T.contiguous().T),      # not contiguous
           ("p_blk", torch.zeros(P + 1, **i32)),
           ("p_row", good["p_row"].to(torch.int64)),
           ("p_row", torch.zeros(P, device="meta", **i32)),
           ("codes", good["codes"].float()),
           ("codes", torch.zeros((2, BLOCK_SIZE - 1), **i32))]
    for name, x in bad:
        with pytest.raises(ValueError, match=name):
            fh.facet_hist_cuda(**{**good, name: x}, fcm=16, n_rows=2)
    for kw in (dict(fcm=0, n_rows=2), dict(fcm=16, n_rows=0)):
        with pytest.raises(ValueError, match=">= 1"):
            fh.facet_hist_cuda(**good, **kw)
    with pytest.raises(ValueError, match="CUDA"):          # all on the CPU
        fh.facet_hist_cuda(**good, fcm=16, n_rows=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.search_batch(None, [pt.SearchRequest(
                query="x", query_facets=[pt.QueryFacet(field="brand")])])
