"""Reference behaviour that no other port test holds, through both
packages on the same documents (ROADMAP A.12): the JAX package's
tests/test_misc.py (a heterogeneous batch, delete by query, iterator
edges, the Mmap access type, the reference's busy seconds),
tests/test_lexcache.py (the commit-time lexical cache: roundtrip,
invalidation, corruption, new commits) and tests/test_advice_fixes.py (a deferred reload, concurrent
id allocation, a truncated terms blob), each run on a reference index
and a port index (device="cpu") and held equal: pages by
tests/test_wand.py's _Page (ids and counts exact, scores within its
rtol), documents, iterators and cache arrays exactly, and each
reference assertion on both.
"""

import json
import threading
import time

import numpy as np
import pytest

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu import lexindex as ref_lexindex
from seekstorm_tpu.metrics import Metrics as RefMetrics
from seekstorm_tpu_torch import lexindex as port_lexindex
from test_torch_search import _create, _to_port
from test_wand import _Page

PKGS = (st, pt)


def _make_docs(rng, n, vocab_size=60):
    """tests/test_lexical.make_docs: zipf titles and bodies."""
    vocab = [f"w{i:03d}" for i in range(vocab_size)]
    probs = np.array([1.0 / (i + 1) for i in range(vocab_size)])
    probs /= probs.sum()
    docs = []
    for _ in range(n):
        tn = int(rng.integers(3, 12))
        bn = int(rng.integers(5, 40))
        docs.append({"title": " ".join(rng.choice(vocab, size=tn, p=probs)),
                     "body": " ".join(rng.choice(vocab, size=bn, p=probs))})
    return docs


def _std_schema(pkg):
    return [pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                            indexed=True, boost=10.0),
            pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                            indexed=True)]


def _search(pkg, idx, req):
    if pkg is pt:
        return pt.search(idx, _to_port(req), device="cpu")
    return idx.search(req)


def _batch(pkg, idx, reqs):
    if pkg is pt:
        return pt.search_batch(idx, [_to_port(r) for r in reqs],
                               device="cpu")
    return idx.search_batch(reqs)


def _open(pkg, path):
    return pkg.open_index(path, device="cpu") if pkg is pt else \
        pkg.open_index(path)


def _both(tmp_path, build):
    """build(pkg, path) for each package in a directory of its own."""
    return [build(pkg, tmp_path / pkg.__name__) for pkg in PKGS]


# -- tests/test_misc.py ------------------------------------------------------


def test_mixed_batch_grouping(tmp_path):
    """A heterogeneous search_batch groups by settings and answers in
    request order; each single search agrees with the batch."""
    def build(pkg, path):
        idx = pkg.create_index(path, [pkg.SchemaField(
            "body", pkg.FieldType.Text, stored=True, indexed=True)],
            shard_count=1, **({"device": "cpu"} if pkg is pt else {}))
        idx.index_documents(
            [{"body": f"alpha beta doc{i} " + ("gamma" if i % 2 else "")}
             for i in range(40)])
        idx.commit()
        return idx

    reqs = [
        st.SearchRequest(query="alpha", result_type=st.ResultType.TopkCount),
        st.SearchRequest(query="alpha gamma",
                         query_type_default=st.QueryType.Intersection,
                         result_type=st.ResultType.TopkCount),
        st.SearchRequest(query="beta", result_type=st.ResultType.Topk,
                         length=5),
        st.SearchRequest(query="alpha", offset=10, length=7,
                         result_type=st.ResultType.TopkCount),
        st.SearchRequest(query="gamma", fields=["body"]),
    ]
    outs = []
    for pkg, idx in zip(PKGS, _both(tmp_path, build)):
        out = _batch(pkg, idx, reqs)
        assert out[0].result_count_total == 40
        assert out[1].result_count_total == 20
        assert len(out[2].results) == 5
        assert len(out[3].results) == 7 and out[3].results[0].doc_id not in [
            r.doc_id for r in out[0].results]
        assert out[4].results[0].doc is not None
        for i, r in enumerate(reqs):
            single = _search(pkg, idx, r)
            assert [x.doc_id for x in single.results] == [
                x.doc_id for x in out[i].results], (pkg.__name__, i)
        outs.append(out)
    ref, port = outs
    assert [_Page(r) for r in port] == [_Page(r) for r in ref]
    assert [x.doc for x in port[4].results] == [x.doc for x in ref[4].results]


def test_delete_by_query_semantics(tmp_path):
    """Deleting every doc a query finds empties that query and leaves the
    deleted docs out of every other."""
    docs = _make_docs(np.random.default_rng(42), 60)
    got = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _std_schema(pkg))
        idx.index_documents(docs)
        idx.commit()
        rs = _search(pkg, idx, st.SearchRequest(query="w001", length=1000))
        victims = [r.doc_id for r in rs.results]
        idx.delete_documents(victims)
        rs2 = _search(pkg, idx, st.SearchRequest(query="w001"))
        assert rs2.result_count_total == 0
        rs3 = _search(pkg, idx, st.SearchRequest(query="w002", length=1000))
        assert all(r.doc_id not in set(victims) for r in rs3.results)
        got.append((victims, _Page(rs2), _Page(rs3)))
    assert got[0] == got[1] and got[0][0]


def test_iterator_edges(tmp_path):
    """get_iterator over three shards with a delete: paging, skips,
    deleted docs on request, negative takes, a start id, documents, an id
    past the end."""
    docs = _make_docs(np.random.default_rng(43), 20)
    calls = [dict(take=5), dict(take=5, skip=4),
             dict(take=5, include_deleted=True, skip=4), dict(take=-3),
             dict(document_id=10, take=3), dict(take=2,
                                                include_document=True),
             dict(document_id=1000, take=3)]
    got = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _std_schema(pkg), shard_count=3)
        idx.index_documents(docs)
        idx.commit()
        idx.delete_document(5)
        out = [idx.get_iterator(**kw) for kw in calls]
        assert out[0] == [0, 1, 2, 3, 4]
        assert out[1] == [4, 6, 7, 8, 9]
        assert out[2] == [4, 5, 6, 7, 8]
        assert out[3] == [19, 18, 17]
        assert out[4] == [10, 11, 12]
        assert out[5][0][0] == 0 and out[5][0][1]["title"] == docs[0]["title"]
        assert out[6] == []
        got.append(out)
    assert got[0] == got[1]


def test_mmap_access_type(tmp_path):
    """An index written with AccessType.Mmap reopens with it and serves
    the same pages and documents."""
    docs = _make_docs(np.random.default_rng(44), 80)
    got = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _std_schema(pkg),
                      meta=pkg.IndexMeta(access_type=pkg.AccessType.Mmap))
        idx.index_documents(docs)
        idx.commit()
        idx2 = _open(pkg, idx.path)
        assert idx2.meta.access_type == pkg.AccessType.Mmap
        req = st.SearchRequest(query="w001 w003", length=10,
                               query_type_default=st.QueryType.Union)
        rs = _search(pkg, idx2, req)
        assert rs.result_count_total > 0
        assert idx2.get_document(5)["title"] == docs[5]["title"]
        got.append((_Page(rs), idx2.get_document(5)))
    assert got[0] == got[1]


@pytest.mark.parametrize("metrics", [RefMetrics], ids=["ref"])
def test_metrics_busy_seconds(metrics):
    """Timer sums count each of four overlapping opens; the busy counter
    (the union of open intervals) counts their overlap once, in the
    reference's Metrics (the port's has no busy counter:
    tests/test_torch_tracing.py)."""
    m = metrics()

    def worker():
        with m.timer("dev"):
            time.sleep(0.1)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    s = m.snapshot()
    assert s["dev_seconds_total"] >= 0.35
    assert s["dev_busy_seconds_total"] <= 0.2
    assert "seekstorm_dev_busy_seconds" in m.render_prometheus()


# -- tests/test_lexcache.py --------------------------------------------------


def _lex_build(pkg, path):
    rng = np.random.default_rng(21)
    vocab = [f"w{i:02d}" for i in range(40)]
    idx = pkg.create_index(path, [pkg.SchemaField(
        "body", pkg.FieldType.Text, stored=True, indexed=True)],
        shard_count=1, **({"device": "cpu"} if pkg is pt else {}))
    idx.index_documents([{"body": " ".join(rng.choice(vocab, 10))}
                         for _ in range(400)])
    idx.commit()
    return idx


def _res(pkg, idx, q="w01 w02"):
    return _Page(_search(pkg, idx, st.SearchRequest(query=q, length=10,
                                                    realtime=False)))


LEX_ARRAYS = ("dev_docid", "dev_imp", "bitmaps")


def test_cache_roundtrip(tmp_path):
    """Commit writes lexcache.npz; a reopened index loads it, equal to a
    fresh rebuild and to the other package's."""
    loaded = []
    for pkg, lexmod, idx in zip(PKGS, (ref_lexindex, port_lexindex),
                                _both(tmp_path, _lex_build)):
        want = _res(pkg, idx)
        path = idx.path
        assert (idx.shards[0].path / "lexcache.npz").exists()
        del idx
        idx2 = _open(pkg, path)
        idx2.ensure_loaded()
        lex = idx2.shards[0].lexical
        fresh = lexmod.build_shard_lexical(lex.levels,
                                           idx2.boosts_or_default())
        for name in LEX_ARRAYS:
            np.testing.assert_array_equal(getattr(lex, name),
                                          getattr(fresh, name))
        np.testing.assert_array_equal(lex.directory.hash,
                                      fresh.directory.hash)
        np.testing.assert_array_equal(lex.directory.seg_dev_len,
                                      fresh.directory.seg_dev_len)
        assert _res(pkg, idx2) == want
        loaded.append((lex, want))
    (ref, ref_page), (port, port_page) = loaded
    for name in LEX_ARRAYS:
        np.testing.assert_array_equal(getattr(ref, name), getattr(port, name))
    assert ref_page == port_page


def test_cache_invalidation(tmp_path, monkeypatch):
    """A stale fingerprint (a layout constant changed) rebuilds with the
    same pages and rewrites the cache under the new fingerprint."""
    pages = []
    for pkg, lexmod, idx in zip(PKGS, (ref_lexindex, port_lexindex),
                                _both(tmp_path, _lex_build)):
        want = _res(pkg, idx)
        sp, path = idx.shards[0].path, idx.path
        del idx
        monkeypatch.setattr(lexmod, "BITMAP_MIN", 8)
        assert json.loads((sp / "lexcache.json").read_text()
                          )["bitmap_min"] != 8
        idx2 = _open(pkg, path)
        idx2.ensure_loaded()
        assert _res(pkg, idx2) == want
        assert json.loads((sp / "lexcache.json").read_text()
                          )["bitmap_min"] == 8
        pages.append(want)
    assert pages[0] == pages[1]


def test_cache_corruption_falls_back(tmp_path):
    """A corrupt lexcache.npz is rebuilt from the levels."""
    pages = []
    for pkg, idx in zip(PKGS, _both(tmp_path, _lex_build)):
        want = _res(pkg, idx)
        sp, path = idx.shards[0].path, idx.path
        del idx
        (sp / "lexcache.npz").write_bytes(b"garbage")
        idx2 = _open(pkg, path)
        idx2.ensure_loaded()
        assert _res(pkg, idx2) == want
        pages.append(want)
    assert pages[0] == pages[1]


def test_cache_tracks_new_commits(tmp_path):
    """A commit after the first refreshes the cache: the new doc is found
    after a reopen."""
    pages = []
    for pkg, idx in zip(PKGS, _both(tmp_path, _lex_build)):
        idx.index_documents([{"body": "w01 fresh unique"}])
        idx.commit()
        want = _res(pkg, idx, "unique")
        assert want.ids
        path = idx.path
        del idx
        assert _res(pkg, _open(pkg, path), "unique") == want
        pages.append(want)
    assert pages[0] == pages[1]


# -- tests/test_advice_fixes.py ----------------------------------------------


def _two_field_schema(pkg):
    return [pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                            indexed=True, boost=10.0),
            pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                            indexed=True)]


def test_get_document_after_deferred_reload(tmp_path):
    """A bulk ingest past a 64K level boundary defers the shard reload;
    documents and the iterator still serve from the packed level."""
    docs = [{"title": f"t{i}", "body": f"word{i % 37} filler"}
            for i in range(65_536 + 10)]
    got = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _two_field_schema(pkg), shard_count=1)
        ids = idx.index_documents(docs)
        d0 = idx.get_document(ids[0])
        assert d0 is not None and d0["title"] == "t0"
        dl = idx.get_document(ids[-1])
        assert dl is not None and dl["title"] == f"t{len(docs) - 1}"
        it = idx.get_iterator(take=3, include_document=True)
        assert len(it) == 3 and it[0][1] is not None
        got.append((list(ids), d0, dl, it))
    assert got[0] == got[1]


def test_concurrent_index_document_id_mapping(tmp_path):
    """Concurrent index_document calls keep local == global // shards:
    every global id is unique and serves the doc it was given, in both
    packages (which ids a thread gets follows thread timing)."""
    n_threads, per_thread = 8, 50
    titles = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _two_field_schema(pkg), shard_count=2)
        results = [[] for _ in range(n_threads)]

        def worker(t):
            for i in range(per_thread):
                title = f"doc-{t}-{i}"
                results[t].append((idx.index_document(
                    {"title": title, "body": "x"}), title))

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        pairs = [p for r in results for p in r]
        gids = [g for g, _ in pairs]
        assert len(set(gids)) == len(gids)
        assert sorted(gids) == list(range(n_threads * per_thread))
        for g, title in pairs:
            doc = idx.get_document(g)
            assert doc is not None and doc["title"] == title
        titles.append(sorted(t for _, t in pairs))
    assert titles[0] == titles[1]


def test_truncated_terms_blob_is_bounded(tmp_path):
    """A terms.txt with fewer newlines than terms does not crash the
    native partial-level reload; the reopened index serves the same
    page in both packages."""
    pages = []
    for pkg in PKGS:
        idx = _create(pkg, tmp_path, _two_field_schema(pkg), shard_count=1)
        for i in range(20):
            idx.index_document({"title": f"alpha{i}", "body": "beta gamma"})
        idx.commit()
        tpath = idx.path / "shard_0" / "level_0" / "terms.txt"
        assert tpath.exists()
        blob = tpath.read_bytes()
        tpath.write_bytes(blob.replace(b"\n", b" ",
                                       max(blob.count(b"\n") - 1, 0)))
        rs = _search(pkg, _open(pkg, idx.path),
                     st.SearchRequest(query="beta"))
        assert rs.results
        pages.append(_Page(rs))
    assert pages[0] == pages[1]
