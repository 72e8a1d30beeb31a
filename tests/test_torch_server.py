"""The port's server (``python -m seekstorm_tpu_torch.server``) on the CPU.

  * The 12 behaviours of ``tests/test_server.py``, under the same names,
    against the port's server booted as a subprocess with ``device=cpu``
    and driven by the port's ``RestClient``.
  * Parity: the same documents and REST requests go to the JAX package's
    server and to the port's (lexical, facets with ranges and a range
    filter, the v2 binary vector query, a JSON vector query, hybrid, delete
    by query), and the JSON bodies are equal but for the time field.
  * Several threads querying one port index (lexical on both routes,
    facets, sorts, field filters, vector and hybrid, with a realtime tail)
    get the answers of the same requests run one by one.
  * A server process that has served lexical and vector requests has loaded
    neither jax nor seekstorm_tpu.
  * ``device=cuda`` without a card exits with an error; it does not serve
    from the CPU.  ``load_apikeys`` raises on a device failure and skips,
    naming it on stderr, an index that fails to open for another reason.
"""

import concurrent.futures as cf
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import seekstorm_tpu_torch as pt
from seekstorm_tpu_torch.client import RestClient, RestError
from test_torch_search import BLOCK_JAX, ROOT, set_route


def _boot(package, root, *args):
    """(process, port, master key) of `package`'s server on the CPU."""
    env = dict(os.environ)
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    env["MASTER_KEY_SECRET"] = "test_master_secret"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.server", f"index_path={root}",
         "local_ip=127.0.0.1", "local_port=0", "--no-console", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=ROOT)
    port = master = None
    deadline = time.time() + 60
    while time.time() < deadline and not (port and master):
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            time.sleep(0.1)
            continue
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
        if m:
            port = int(m.group(1))
        m = re.search(r"master apikey: (\S+)", line)
        if m:
            master = m.group(1)
    if not (port and master):
        proc.kill()
        raise AssertionError(f"{package} server did not start")
    return proc, port, master


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=10)


def _client(port, master, quota=None):
    c = RestClient(f"http://127.0.0.1:{port}")
    for _ in range(100):
        try:
            assert c.live()["status"] == "ok"
            break
        except Exception:
            time.sleep(0.2)
    c.apikey = c.create_apikey(quota or {"indices_max": 16},
                               master_key=master)
    return c


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    proc, port, master = _boot("seekstorm_tpu_torch",
                               tmp_path_factory.mktemp("port_server"),
                               "device=cpu")
    yield {"port": port, "master": master, "proc": proc}
    _stop(proc)


@pytest.fixture(scope="module")
def client(server):
    return _client(server["port"], server["master"])


# -- the 12 behaviours of tests/test_server.py --------------------------------

def test_live_and_auth(client, server):
    assert client.live() == {"status": "ok"}
    bad = RestClient(client.base, "aW52YWxpZA==")
    with pytest.raises(RestError) as e:
        bad.get_index_info(0)
    assert e.value.status == 401


def test_lexical_roundtrip(client):
    iid = client.create_index({
        "index_name": "demo",
        "schema": [
            {"field": "title", "field_type": "Text", "store": True,
             "index_lexical": True, "boost": 10.0},
            {"field": "body", "field_type": "Text", "store": True,
             "index_lexical": True},
            {"field": "year", "field_type": "U16", "store": True,
             "facet": True},
        ],
    })
    ids = client.index_documents(iid, [
        {"title": "quick brown fox", "body": "jumps over the dog", "year": 2001},
        {"title": "lazy dog", "body": "sleeps all day", "year": 2002},
        {"title": "brown bear", "body": "quick and strong", "year": 2001},
    ])
    assert ids == [0, 1, 2]
    client.commit_index(iid)

    info = client.get_index_info(iid)
    assert info["indexed_doc_count"] == 3

    r = client.query(iid, {"query": "quick brown",
                           "query_type_default": "Union",
                           "fields": ["title"]})
    assert r["count_total"] == 2
    assert {x["_id"] for x in r["results"]} == {0, 2}
    assert "title" in r["results"][0]

    # API default query type is Intersection (reference query_type_api)
    r = client.query(iid, {"query": "quick dog"})
    assert r["count_total"] == 1 and r["results"][0]["_id"] == 0

    r = client.query_get(iid, "dog")
    assert r["count_total"] == 2

    r = client.query(iid, {"query": "quick brown",
                           "query_type_default": "Union",
                           "query_facets": [{"field": "year"}]})
    assert dict((int(a), b) for a, b in r["facets"]["year"]) == {2001: 2}

    d = client.get_document(iid, 1)
    assert d["title"] == "lazy dog"

    new_id = client.update_document(iid, 1, {"title": "energetic dog",
                                             "body": "runs", "year": 2003})
    assert new_id == 3
    client.delete_document(iid, 0)
    client.commit_index(iid)
    r = client.query(iid, {"query": "dog", "query_type_default": "Union",
                           "realtime": True})
    assert {x["_id"] for x in r["results"]} == {3}

    it = client.get_iterator(iid, take=10, include_deleted=False)
    assert it == [2, 3]

    client.set_synonyms(iid, [{"terms": ["dog", "hound"], "multiway": True}])
    assert client.get_synonyms(iid) == [{"terms": ["dog", "hound"],
                                         "multiway": True}]


def test_vector_v2_binary(client):
    iid = client.create_index({
        "index_name": "vec",
        "schema": [{"field": "vector", "field_type": "Json",
                    "index_vector": True}],
        "inference": {"External": {"dimensions": 16, "precision": "F32",
                                   "quantization": "None",
                                   "similarity": "Euclidean"}},
        "clustering": "None",
    })
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((20, 16)).astype(np.float32)
    client.index_documents(iid, [{"vector": v.tolist()} for v in vecs])
    client.commit_index(iid)
    ids = client.query_binary(iid, vecs[7])
    assert ids[0] == 7

    r = client.query(iid, {
        "query": "", "query_vector": vecs[3].tolist(),
        "search_mode": {"Vector": {"ann_mode": "All",
                                   "similarity_threshold": None}},
    })
    assert r["results"][0]["_id"] == 3


def test_empty_query_gate(client):
    iid = client.create_index({
        "index_name": "gate",
        "schema": [{"field": "t", "field_type": "Text", "store": True,
                    "index_lexical": True}],
    })
    client.index_documents(iid, [{"t": "alpha"}, {"t": "beta"}])
    client.commit_index(iid)
    r = client.query(iid, {"query": ""})
    assert r["count_total"] == 0 and r["results"] == []
    r = client.query(iid, {"query": "", "enable_empty_query": True})
    assert r["count_total"] == 2


def test_quota_and_apikey_lifecycle(client, server):
    c = RestClient(client.base)
    key = c.create_apikey({"indices_max": 1, "rate_limit": 1000},
                          master_key=server["master"])
    c.apikey = key
    c.create_index({"index_name": "one", "schema": []})
    with pytest.raises(RestError) as e:
        c.create_index({"index_name": "two", "schema": []})
    assert e.value.status == 403
    c.delete_apikey(key, master_key=server["master"])
    with pytest.raises(RestError) as e:
        c.get_apikey_indices()
    assert e.value.status == 401


def test_synonyms_applied_at_indexing(client):
    iid = client.create_index({
        "index_name": "syn",
        "schema": [{"field": "t", "field_type": "Text", "store": True,
                    "index_lexical": True}],
        "synonyms": [{"terms": ["car", "automobile"], "multiway": True}],
    })
    client.index_documents(iid, [{"t": "a red car"}, {"t": "an old bike"}])
    client.commit_index(iid)
    r = client.query(iid, {"query": "automobile"})
    assert r["count_total"] == 1 and r["results"][0]["_id"] == 0


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.read().decode()


def test_openapi(client):
    import json as _json

    spec = _json.loads(_get(client.base + "/openapi.json"))
    assert spec["openapi"].startswith("3.")
    assert "/api/v1/index/{index_id}/query" in spec["paths"]


def test_web_ui_served(client):
    html = _get(client.base + "/")
    assert "seekstorm-tpu" in html and "<script>" in html


def test_metrics_endpoint(client):
    """GET /metrics renders the port's counters moved by earlier tests."""
    text = _get(client.base + "/metrics")
    assert "seekstorm_queries_total" in text
    assert "seekstorm_docs_indexed_total" in text
    assert "seekstorm_commits_total" in text


def test_trace_from_two_request_threads(client, server, tmp_path):
    """/trace/start and /trace/stop sent from two threads (each request
    on a server thread of its own) both answer 200, and the written
    session holds the program's spans, each with a batch id, inside the
    profiler's window."""
    iid = client.create_index({"index_name": "traced", "schema": [
        {"field": "body", "field_type": "Text", "index_lexical": True}]})
    client.index_documents(iid, [{"body": f"w{i % 7} w{i % 11}"}
                                 for i in range(200)])
    client.commit_index(iid)
    client.index_documents(iid, [{"body": "w1 w2"}] * 20)

    def post(path, body=None):
        got = []
        t = threading.Thread(target=lambda: got.append(client._call(
            "POST", path, body, apikey=server["master"])))
        t.start()
        t.join(60)
        assert not t.is_alive()
        return got[0]

    assert post("/trace/start", {"log_dir": str(tmp_path)}) == {
        "tracing": True}
    r = client.query(iid, {"query": "w1 w2", "query_type_default": "Union",
                           "realtime": True})
    assert r["count_total"] > 0
    assert post("/trace/stop") == {"stopped": True}
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (w,) = [e for e in events if e.get("cat") == "Trace"
            and e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "seekstorm"]
    names = {e["name"] for e in spans}
    assert {"search_batch", "search_parse", "tail_merge",
            "search_finalize"} <= names
    assert len({e["args"]["batch"] for e in spans}) == 1
    assert all(e["args"]["batch"] > 0 for e in spans)
    for e in spans:
        assert w["ts"] - 1e3 <= e["ts"]
        assert e["ts"] + e["dur"] <= w["ts"] + w["dur"] + 1e3


def test_pdf_file_upload(client):
    from test_pdf import make_pdf

    iid = client.create_index({
        "index_name": "pdfix",
        "schema": [
            {"field": "title", "field_type": "Text", "stored": True,
             "indexed": True},
            {"field": "body", "field_type": "Text", "stored": True,
             "indexed": True},
        ],
    })
    pdf = make_pdf(["searchable pdf xyzygy content"], title="PDF Title")
    did = client.index_pdf_bytes(iid, pdf)
    assert isinstance(did, int)
    client.commit_index(iid)
    rs = client.query(iid, {"query": "xyzygy", "length": 10,
                            "fields": ["title", "body"]})
    assert rs["count_total"] == 1
    assert rs["results"][0]["title"] == "PDF Title"


def test_facets_minmax_and_range_histogram(client):
    iid = client.create_index({
        "index_name": "rangeix",
        "schema": [
            {"field": "body", "field_type": "Text", "stored": True,
             "indexed": True},
            {"field": "year", "field_type": "U16", "stored": True,
             "facet": True},
        ],
    })
    client.index_documents(iid, [
        {"body": f"doc {i}", "year": 1990 + (i % 30)} for i in range(90)
    ])
    client.commit_index(iid)
    info = client.get_index_info(iid)
    assert info["facets_minmax"]["year"] == [1990.0, 2019.0]
    lo, hi = info["facets_minmax"]["year"]
    w = (hi - lo) / 10
    r = client.query(iid, {
        "query": "doc", "length": 5,
        "query_facets": [{"field": "year", "length": 10, "ranges": {
            "field": "year", "range_type": "CountWithinRange",
            "ranges": [[str(i), lo + i * w] for i in range(10)]}}],
        "facet_filter": [{"field": "year", "range": [2000, 2009]}],
    })
    assert r["count_total"] == sum(1 for i in range(90)
                                   if 2000 <= 1990 + (i % 30) <= 2009)
    assert "year" in r["facets"]


def test_web_ui_has_range_slider_and_preview(client, server):
    html = _get(f"http://127.0.0.1:{server['port']}/")
    assert "rangeFields" in html and "preview" in html and "modal" in html


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_launch_counts_reach_metrics(k):
    """A kernel wrapper's launch count goes into METRICS as
    k<N>_launches_total, which a server's /metrics renders."""
    from seekstorm_tpu_torch.ops import (dense_scan, facet_hist,
                                         vector_scan, wand_rescore,
                                         wand_rungs, wand_scan)

    mod = (wand_scan, dense_scan, facet_hist, vector_scan, wand_rescore,
           wand_rungs)[k - 1]
    name = f"k{k}_launches_total"
    n0, m0 = mod.LAUNCHES, pt.METRICS.snapshot().get(name, 0)
    mod._count_launch()
    assert mod.LAUNCHES == n0 + 1
    assert pt.METRICS.snapshot()[name] == m0 + 1
    assert f"seekstorm_{name} " in pt.METRICS.render_prometheus()
    mod.LAUNCHES = n0


# -- parity with the JAX package's server ------------------------------------

_WORDS = [f"w{i:02d}" for i in range(30)]


def _parity_docs():
    rng = np.random.default_rng(21)
    docs = []
    for i in range(160):
        docs.append({
            "title": " ".join(rng.choice(_WORDS, 3)),
            "body": " ".join(rng.choice(_WORDS, 12)),
            "year": int(1990 + i % 30),
        })
    vecs = rng.standard_normal((160, 16)).astype(np.float32)
    return docs, vecs


_LEX_INDEX = {
    "index_name": "lex",
    "schema": [
        {"field": "title", "field_type": "Text", "store": True,
         "index_lexical": True, "boost": 10.0},
        {"field": "body", "field_type": "Text", "store": True,
         "index_lexical": True},
        {"field": "year", "field_type": "U16", "store": True, "facet": True},
    ],
}
_VEC_INDEX = {
    "index_name": "vec",
    "schema": [{"field": "vector", "field_type": "Json",
                "index_vector": True},
               {"field": "body", "field_type": "Text", "store": True,
                "index_lexical": True}],
    "inference": {"External": {"dimensions": 16, "precision": "F32",
                               "quantization": "None",
                               "similarity": "Euclidean"}},
    "clustering": "None",
}


def _session(c):
    """Every response of one REST session, in order, times dropped."""
    docs, vecs = _parity_docs()
    out = []

    def q(iid, body):
        r = c.query(iid, body)
        assert r.pop("time") >= 0
        out.append(r)
        return r

    lex = c.create_index(_LEX_INDEX)
    out.append(c.index_documents(lex, docs[:120]))
    c.commit_index(lex)
    out.append(c.index_documents(lex, docs[120:]))      # realtime tail
    q(lex, {"query": "w01 w02", "query_type_default": "Union",
            "fields": ["title"], "length": 20})
    q(lex, {"query": "w03 w04"})
    q(lex, {"query": "+w05 w06 -w07", "query_type_default": "Union",
            "offset": 3, "length": 7, "result_type": "Topk"})
    q(lex, {"query": "w08", "result_type": "Count"})
    q(lex, {"query": "w09 w10", "query_type_default": "Union",
            "query_facets": [
                {"field": "year", "length": 10, "ranges": {
                    "field": "year", "range_type": "CountWithinRange",
                    "ranges": [[str(y), float(y)]
                               for y in range(1990, 2020, 5)]}}],
            "facet_filter": [{"field": "year", "range": [1995, 2010]}]})
    q(lex, {"query": "w11", "query_type_default": "Union",
            "query_facets": [{"field": "year", "length": 5}],
            "result_sort": [{"field": "year", "order": "Ascending"}]})
    q(lex, {"query": "w12 w13", "query_type_default": "Union",
            "field_filter": ["body"]})
    r = c._call("GET", f"/api/v1/index/{lex}/query?query=w14&length=5")
    r.pop("time")
    out.append(r)
    out.append(c.delete_documents_by_query(
        lex, {"query": "w15", "query_type_default": "Union"}))
    q(lex, {"query": "w15 w16", "query_type_default": "Union",
            "realtime": True})
    info = c.get_index_info(lex)
    out.append({k: info[k] for k in ("indexed_doc_count", "facets_minmax")})

    vec = c.create_index(_VEC_INDEX)
    out.append(c.index_documents(
        vec, [{"vector": v.tolist(), "body": d["body"]}
              for v, d in zip(vecs, docs)]))
    c.commit_index(vec)
    out.append(c.query_binary(vec, vecs[7]))
    out.append(c.query_binary(vec, vecs[40] + 0.1))
    q(vec, {"query": "", "query_vector": vecs[3].tolist(), "length": 5,
            "search_mode": {"Vector": {"ann_mode": "All",
                                       "similarity_threshold": None}}})
    q(vec, {"query": "w17 w18", "query_type_default": "Union",
            "query_vector": (vecs[9] * 0.5).tolist(), "length": 8,
            "search_mode": "Hybrid"})
    out.append(c.delete_documents_by_query(vec, {"query": "w19"}))
    q(vec, {"query": "w19 w20", "query_type_default": "Union",
            "realtime": True})
    return out


def test_rest_parity_with_reference_server(tmp_path):
    """The same documents and requests give the same JSON bodies (but for
    the time field) from the JAX package's server and the port's."""
    bodies = []
    for package, args in (("seekstorm_tpu", ()),
                          ("seekstorm_tpu_torch", ("device=cpu",))):
        proc, port, master = _boot(package, tmp_path / package, *args)
        try:
            bodies.append(_session(_client(port, master)))
        finally:
            _stop(proc)
    ref, got = bodies
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a == b, (i, a, b)


# -- concurrency -------------------------------------------------------------

def _mixed_index(path):
    rng = np.random.default_rng(33)
    meta = pt.IndexMeta(vector=pt.VectorConfig(
        enabled=True, dim=16, similarity=pt.VectorSimilarity.Euclidean,
        inference=pt.InferenceType.External))
    schema = [pt.SchemaField("vec", pt.FieldType.Json, index_vector=True),
              pt.SchemaField("title", pt.FieldType.Text, indexed=True,
                             boost=5.0),
              pt.SchemaField("body", pt.FieldType.Text, indexed=True),
              pt.SchemaField("brand", pt.FieldType.String16, facet=True),
              pt.SchemaField("price", pt.FieldType.U16, facet=True)]
    vecs = rng.standard_normal((700, 16)).astype(np.float32)
    docs = [{"vec": v.tolist(),
             "title": " ".join(rng.choice(_WORDS, 3)),
             "body": " ".join(rng.choice(_WORDS, 10)),
             "brand": f"b{i % 6}", "price": int(i % 97)}
            for i, v in enumerate(vecs)]
    idx = pt.create_index(path, schema, meta=meta, shard_count=2,
                          device="cpu")
    # seed batch naming every brand first: ordinals follow ingest order
    idx.index_documents(docs[:6])
    idx.index_documents(docs[6:640])
    idx.commit()
    return docs, vecs


def _mixed_requests(vecs):
    R, QF, FF, RS = (pt.SearchRequest, pt.QueryFacet, pt.FacetFilter,
                     pt.ResultSort)
    reqs = []
    for i in range(8):
        a, b, c = _WORDS[i], _WORDS[i + 9], _WORDS[i + 17]
        reqs += [
            R(query=f"{a} {b}"),
            R(query=f"{a} {b} {c}", query_type_default=pt.QueryType.Intersection),
            R(query=f"+{a} {c} -{b}", offset=2, length=5),
            R(query=f"{b}", query_facets=[QF(field="brand"),
                                          QF(field="price")]),
            R(query=f"{c} {a}", facet_filter=[FF(field="price",
                                                 range=(10, 60))]),
            R(query=f"{a}", result_sort=[RS(field="price")]),
            R(query=f"{b} {c}", field_filter=["title"]),
            R(query=f"{a} {c}", result_type=pt.ResultType.Count),
            R(search_mode=pt.SearchMode.Vector,
              query_vector=vecs[i].tolist()),
            R(search_mode=pt.SearchMode.Vector,
              query_vector=(vecs[i + 30] + 0.1).tolist(), ann_mode="Nprobe",
              nprobe=2),
            R(query=f"{a}", search_mode=pt.SearchMode.Hybrid,
              query_vector=vecs[i + 60].tolist()),
        ]
    return reqs


def _answer(rs):
    return (rs.result_count, rs.result_count_total,
            [(r.doc_id, r.score) for r in rs.results],
            {k: list(v) for k, v in rs.facets.items()},
            rs.observed_vector_count, rs.observed_cluster_count)


@pytest.mark.parametrize("route", ["wand", "dense"])
def test_concurrent_queries_match_one_by_one(tmp_path, monkeypatch, route):
    """Eight threads send the requests of a mixed workload to one freshly
    opened index (so every first-use build races) and get the answers the
    same requests get one by one on another fresh open of it."""
    set_route(monkeypatch, route)
    docs, vecs = _mixed_index(tmp_path / "ix")
    reqs = _mixed_requests(vecs)

    def fresh():
        idx = pt.open_index(tmp_path / "ix", device="cpu")
        idx.index_documents(docs[640:])         # the same realtime tail
        return idx

    seq = fresh()
    want = [_answer(seq.search(r)) for r in reqs]

    idx = fresh()
    order = np.random.default_rng(2).permutation(len(reqs) * 2) % len(reqs)
    barrier = threading.Barrier(8)

    def run(chunk):
        barrier.wait()
        return [(i, _answer(idx.search(reqs[i]))) for i in chunk]

    with cf.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(run, order[t::8].tolist()) for t in range(8)]
        got = [x for f in futs for x in f.result()]
    assert len(got) == 2 * len(reqs)
    for i, ans in got:
        assert ans == want[i], (i, reqs[i])


def test_concurrent_first_requests_build_once(tmp_path, monkeypatch):
    """Eight threads' first requests on a fresh index build each piece of
    device state once: the WAND state, the dense arrays and their tf
    upload, the facet runtime and each shard's vector tensors (the global
    re-cluster).  Each build is slowed so that the threads overlap it."""
    from seekstorm_tpu_torch import facets as facets_mod
    from seekstorm_tpu_torch import vector_index
    from seekstorm_tpu_torch.ops import wand as wand_mod
    from seekstorm_tpu_torch.parallel import mesh

    monkeypatch.setenv("SEEKSTORM_TPU_WAND", "1")
    docs, vecs = _mixed_index(tmp_path / "ix")
    idx = pt.open_index(tmp_path / "ix", device="cpu")
    idx.index_documents(docs[640:])
    builds = {}
    lock = threading.Lock()

    def counted(name, fn):
        def run(*a, **kw):
            with lock:
                builds[name] = builds.get(name, 0) + 1
            time.sleep(0.2)
            return fn(*a, **kw)
        return run

    for mod, cls in ((wand_mod, "WandState"), (mesh, "StackedIndex"),
                     (facets_mod, "FacetRuntime")):
        base = getattr(mod, cls)
        monkeypatch.setattr(mod, cls, type(cls, (base,), {
            "__init__": counted(cls, base.__init__)}))
    monkeypatch.setattr(mesh.StackedIndex, "_upload_tf", counted(
        "tf", mesh.StackedIndex._upload_tf))
    monkeypatch.setattr(vector_index.IndexVectors, "_host_arrays", counted(
        "vectors", vector_index.IndexVectors._host_arrays))

    R = pt.SearchRequest
    reqs = [R(query="w01 w02"), R(query="w03", field_filter=["title"]),
            R(query="w04", query_facets=[pt.QueryFacet(field="brand")]),
            R(search_mode=pt.SearchMode.Vector,
              query_vector=vecs[5].tolist())]
    barrier = threading.Barrier(8)

    def run(t):
        barrier.wait()
        return _answer(idx.search(reqs[t % len(reqs)]))

    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(run, range(8)))
    assert builds == {"WandState": 1, "StackedIndex": 1, "tf": 1,
                      "FacetRuntime": 1, "vectors": 2}, builds
    for t in range(4, 8):
        assert got[t] == got[t - 4]


def test_full_f32_blocks_of_threads_nest():
    """TF32 is a process-wide switch: while one thread's full-f32 block is
    open, another's ending must not turn TF32 back on."""
    from seekstorm_tpu_torch.ops import vector as V

    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    flag.allow_tf32 = True
    try:
        a_in, b_in, a_out = (threading.Event() for _ in range(3))
        seen = []

        def a():
            with V.full_f32():
                a_in.set()
                b_in.wait()
            a_out.set()

        def b():
            a_in.wait()
            with V.full_f32():
                b_in.set()
                a_out.wait()
                seen.append(flag.allow_tf32)

        ts = [threading.Thread(target=f) for f in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert seen == [False]
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = prev


def test_delete_during_warmup_serves_no_stale_page(tmp_path, monkeypatch):
    """A delete that lands while commit's warmup runs leaves the warmup
    cache empty: a frequent word's page does not hold the deleted doc."""
    search_mod = importlib.import_module("seekstorm_tpu_torch.search")
    idx = pt.create_index(
        tmp_path / "ix", [pt.SchemaField("t", pt.FieldType.Text,
                                         indexed=True)],
        meta=pt.IndexMeta(frequent_words=pt.FrequentwordType.English),
        device="cpu")
    idx.index_documents([{"t": "the w" + str(i % 5)} for i in range(300)])
    real = search_mod.search_batch

    def racing(index, requests, device="cuda"):
        out = real(index, requests, device)
        if requests[0].length == 1000:          # the warmup's batch
            index.delete_document(0)
        return out

    monkeypatch.setattr(search_mod, "search_batch", racing)
    idx.commit()
    monkeypatch.setattr(search_mod, "search_batch", real)
    rs = idx.search(pt.SearchRequest(query="the", length=10,
                                     realtime=False))
    assert rs.result_count_total == 299
    assert 0 not in [r.doc_id for r in rs.results]


# -- the process and the device ----------------------------------------------

_SERVE_NO_JAX = BLOCK_JAX + r"""
import numpy as np
from seekstorm_tpu_torch.client import RestClient
from seekstorm_tpu_torch.server import start_server
srv = start_server(sys.argv[1], port=0, device="cpu")
c = RestClient(f"http://127.0.0.1:{srv.port}")
c.apikey = c.create_apikey({}, master_key=srv.master_key)
lex = c.create_index({"index_name": "t", "schema": [
    {"field": "t", "field_type": "Text", "store": True,
     "index_lexical": True}]})
c.index_documents(lex, [{"t": "alpha beta"}, {"t": "beta gamma"}])
c.commit_index(lex)
assert c.query(lex, {"query": "beta"})["count_total"] == 2
vec = c.create_index({"index_name": "v", "schema": [
    {"field": "vector", "field_type": "Json", "index_vector": True}],
    "inference": {"External": {"dimensions": 8}}})
x = np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32)
c.index_documents(vec, [{"vector": v.tolist()} for v in x])
c.commit_index(vec)
assert c.query_binary(vec, x[4])[0] == 4
srv.shutdown()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "seekstorm_tpu")]
print("ok")
"""


def test_server_process_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", _SERVE_NO_JAX,
                          str(tmp_path / "root")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cuda_without_a_card_exits(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "seekstorm_tpu_torch.server",
         f"index_path={tmp_path / 'root'}", "local_port=0", "device=cuda",
         "--no-console"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "listening" not in out.stdout
    from seekstorm_tpu_torch.server import SearchServer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchServer(tmp_path / "root2", port=0, device="cuda")
    assert not (tmp_path / "root2").exists()


def test_load_apikeys_raises_on_device_failure(tmp_path, monkeypatch,
                                               capsys):
    from seekstorm_tpu_torch import index as port_index
    from seekstorm_tpu_torch.server import tenancy

    ak = tenancy.ApikeyObject(apikey_hash="ab" * 32,
                              quota=tenancy.ApikeyQuota())
    ak.save(tmp_path)
    for iid in (0, 1):
        idx = pt.create_index(tmp_path / ak.apikey_hash / str(iid),
                              [pt.SchemaField("t", pt.FieldType.Text,
                                              indexed=True)], device="cpu")
        idx.index_documents([{"t": "x y"}])
        idx.commit()
    (tmp_path / ak.apikey_hash / "1" / "index.json").write_text("{")
    keys = tenancy.load_apikeys(tmp_path, "cpu")
    assert list(keys[ak.apikey_hash].index_list) == [0]
    assert keys[ak.apikey_hash].index_list[0].device.type == "cpu"
    err = capsys.readouterr().err
    assert "skipping index" in err and str(tmp_path / ak.apikey_hash / "1") \
        in err

    def broken(path, device="cuda"):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(port_index, "open_index", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tenancy.load_apikeys(tmp_path, "cpu")
