"""The port's timers, counters and trace spans (``metrics.py``) on the CPU.

  * A realtime lexical batch moves the parse, tail merge (gather, score,
    select) and finalize timers, ``tail_entries_total`` counts the tail
    entries the merge appended and ``tail_postings_total`` the (query,
    posting) pairs it scored; a realtime vector batch moves the committed
    scan (with its cluster selection), tail and merge timers and
    ``vector_dispatch_total``, and no lexical dispatch.
  * Under ``start_trace`` each timer is also a span in the written trace:
    it carries the id of its ``search_batch`` and lies inside that batch's
    own span and inside the profiler's window, from whichever thread ran
    the batch and whichever thread started and stopped the trace.
  * With no trace running no span is kept.
  * Snapshots and the Prometheus text carry sums and counts alone.
"""

import json
import threading

import numpy as np
import pytest

import seekstorm_tpu_torch as pt
from seekstorm_tpu_torch import metrics
from seekstorm_tpu_torch.metrics import METRICS, Metrics

LEX_TIMERS = ("search_parse", "tail_merge", "tail_gather", "tail_score",
              "tail_select", "search_finalize")
VEC_TIMERS = ("vector_scan", "vector_select", "vector_tail",
              "vector_merge")
QUERIES = ["w001", "w002 w003", "w004 w010 w011", "w012"]


def _words(rng, n, k, vocab=40):
    return [" ".join(f"w{int(i):03d}" for i in rng.integers(0, vocab, k))
            for _ in range(n)]


@pytest.fixture(scope="module")
def lexical(tmp_path_factory):
    """Two shards, 600 committed docs, a 300-doc realtime tail."""
    rng = np.random.default_rng(5)
    idx = pt.create_index(
        tmp_path_factory.mktemp("lex") / "ix",
        [pt.SchemaField("body", pt.FieldType.Text, indexed=True)],
        shard_count=2, device="cpu")
    idx.index_documents([{"body": b} for b in _words(rng, 600, 6)])
    idx.commit()
    tail = _words(rng, 300, 6)
    idx.index_documents([{"body": b} for b in tail])
    return idx, tail


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    """2,000 committed 16-d rows in IVF clusters, a 50-row tail."""
    rng = np.random.default_rng(3)
    meta = pt.IndexMeta(vector=pt.VectorConfig(
        enabled=True, dim=16, similarity=pt.VectorSimilarity.Euclidean,
        precision=pt.Precision.I8,
        quantization=pt.Quantization.ScalarQuantizationI8,
        inference=pt.InferenceType.External,
        clustering=pt.ClusteringConfig(mode=pt.ClusteringMode.Auto,
                                       min_points=100)))
    idx = pt.create_index(
        tmp_path_factory.mktemp("vec") / "ix",
        [pt.SchemaField("vector", pt.FieldType.Json, index_vector=True)],
        meta=meta, device="cpu")
    rows = rng.standard_normal((2050, 16)).astype(np.float32)
    idx.index_documents([{"vector": v.tolist()} for v in rows[:2000]])
    idx.commit()
    idx.index_documents([{"vector": v.tolist()} for v in rows[2000:]])
    return idx, rng.standard_normal((8, 16)).astype(np.float32)


def _lex_requests():
    return [pt.SearchRequest(query=q, length=10, realtime=True,
                             result_type=pt.ResultType.TopkCount,
                             query_type_default=pt.QueryType.Union)
            for q in QUERIES]


def _vec_requests(qv):
    return [pt.SearchRequest(query_vector=v.tolist(),
                             search_mode=pt.SearchMode.Vector,
                             ann_mode="Nprobe", nprobe=2, realtime=True)
            for v in qv]


def _moved(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def test_lexical_batch_moves_every_timer(lexical):
    idx, tail = lexical
    s0 = METRICS.snapshot()
    out = pt.search_batch(idx, _lex_requests(), device="cpu")
    s1 = METRICS.snapshot()
    assert all(rs.results for rs in out)
    for name in LEX_TIMERS:
        assert _moved(s0, s1, f"{name}_count") > 0, name
        assert _moved(s0, s1, f"{name}_seconds_total") > 0, name
    # a shard with a tail observes tail_merge and tail_gather twice, at its
    # view's first use (the idf of the batch's route) and in its merge; the
    # merge observes its scoring and selection once
    assert _moved(s0, s1, "tail_merge_count") == 4
    assert _moved(s0, s1, "tail_gather_count") == 4
    assert _moved(s0, s1, "tail_score_count") == 2
    assert _moved(s0, s1, "tail_select_count") == 2
    # the tail docs each query matches: every one is appended (< 1,024)
    want = sum(sum(any(w in doc.split() for w in q.split()) for doc in tail)
               for q in QUERIES)
    assert want > 0
    assert _moved(s0, s1, "tail_entries_total") == want
    # the (query, posting) pairs the merge scores: each query term's tail
    # docs
    pairs = sum(sum(w in doc.split() for doc in tail)
                for q in QUERIES for w in set(q.split()))
    assert _moved(s0, s1, "tail_postings_total") == pairs
    assert _moved(s0, s1, "vector_dispatch_total") == 0


def test_committed_batch_merges_no_tail(lexical):
    idx, _ = lexical
    reqs = [pt.SearchRequest(query=q, length=10, realtime=False)
            for q in QUERIES]
    s0 = METRICS.snapshot()
    pt.search_batch(idx, reqs, device="cpu")
    s1 = METRICS.snapshot()
    assert _moved(s0, s1, "search_parse_count") > 0
    assert _moved(s0, s1, "search_finalize_count") > 0
    for name in ("tail_merge_count", "tail_gather_count",
                 "tail_entries_total"):
        assert _moved(s0, s1, name) == 0, name


def test_vector_batch_moves_every_timer(vectors):
    idx, qv = vectors
    s0 = METRICS.snapshot()
    out = pt.search_batch(idx, _vec_requests(qv), device="cpu")
    s1 = METRICS.snapshot()
    assert all(len(rs.results) == 10 for rs in out)
    assert out[0].observed_cluster_count == 2   # cluster selection ran
    for name in VEC_TIMERS:
        assert _moved(s0, s1, f"{name}_count") == 1, name
        assert _moved(s0, s1, f"{name}_seconds_total") > 0, name
    assert _moved(s0, s1, "vector_dispatch_total") == 1
    assert _moved(s0, s1, "device_dispatch_total") == 0
    assert _moved(s0, s1, "queries_total") == len(qv)


def test_exhaustive_vector_batch_selects_no_cluster(vectors):
    idx, qv = vectors
    reqs = [pt.SearchRequest(query_vector=v.tolist(),
                             search_mode=pt.SearchMode.Vector,
                             ann_mode="All", realtime=False) for v in qv]
    s0 = METRICS.snapshot()
    pt.search_batch(idx, reqs, device="cpu")
    s1 = METRICS.snapshot()
    assert _moved(s0, s1, "vector_scan_count") == 1
    assert _moved(s0, s1, "vector_select_count") == 0


def _traced(tmp_path, work):
    """work() under a trace; the written trace's events."""
    assert metrics.start_trace(str(tmp_path)) is True
    try:
        work()
    finally:
        assert metrics.stop_trace() is True
    (path,) = tmp_path.glob("*.pt.trace.json")
    return json.loads(path.read_text())["traceEvents"]


def _spans(events):
    return [e for e in events if e.get("cat") == "seekstorm"]


def _window(events):
    (w,) = [e for e in events if e.get("cat") == "Trace"
            and e.get("ph") == "X"]
    return w["ts"], w["ts"] + w["dur"]


@pytest.mark.parametrize("where", ["caller", "thread"])
def test_spans_carry_their_batch_and_nest_in_it(lexical, vectors, tmp_path,
                                                where):
    idx, _ = lexical
    vidx, qv = vectors

    def batches():
        pt.search_batch(idx, _lex_requests(), device="cpu")
        pt.search_batch(vidx, _vec_requests(qv), device="cpu")

    def work():
        if where == "caller":
            return batches()
        t = threading.Thread(target=batches)
        t.start()
        t.join(60)
        assert not t.is_alive()

    events = _traced(tmp_path, work)
    spans = _spans(events)
    outer = {e["args"]["batch"]: e for e in spans
             if e["name"] == "search_batch"}
    assert len(outer) == 2 and 0 not in outer
    inner = [e for e in spans if e["name"] != "search_batch"]
    # every timer but the per-query sums, which are no spans
    assert {e["name"] for e in inner} >= (
        set(LEX_TIMERS + VEC_TIMERS) - {"tail_score", "tail_select"})
    lo, hi = _window(events)
    for e in inner:
        b = outer[e["args"]["batch"]]
        assert e["tid"] == b["tid"]
        assert b["ts"] <= e["ts"] and e["ts"] + e["dur"] <= b["ts"] + b["dur"]
    for e in spans:
        assert lo - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e3
    # each batch's own timers: the lexical batch's parse, the vector's scan
    by = {n: {e["args"]["batch"] for e in inner if e["name"] == n}
          for n in ("search_parse", "vector_scan")}
    assert len(by["search_parse"]) == len(by["vector_scan"]) == 1
    assert by["search_parse"] != by["vector_scan"]


def test_no_span_kept_without_a_trace(lexical, tmp_path):
    idx, _ = lexical
    pt.search_batch(idx, _lex_requests(), device="cpu")
    assert METRICS._spans is None
    events = _traced(tmp_path, lambda: None)
    assert _spans(events) == []
    assert METRICS._spans is None


def test_trace_stops_from_another_thread(tmp_path):
    """The profiler's start and stop run on one owner thread, whichever
    thread asks."""
    got = []
    t = threading.Thread(
        target=lambda: got.append(metrics.start_trace(str(tmp_path))))
    t.start()
    t.join(60)
    assert got == [True]
    with METRICS.timer("probe"):
        pass
    assert metrics.stop_trace() is True
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = _spans(json.loads(path.read_text())["traceEvents"])
    assert [(e["name"], e["args"]["batch"]) for e in spans] == [("probe", 0)]


def test_snapshot_has_sums_and_counts_alone():
    m = Metrics()

    def worker():
        with m.timer("dev"):
            pass

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    m.inc("hits", 3)
    s = m.snapshot()
    assert s == {"hits": 3.0, "dev_count": 4,
                 "dev_seconds_total": s["dev_seconds_total"]}
    assert s["dev_seconds_total"] > 0
    text = m.render_prometheus()
    assert "busy" not in text and "_avg" not in text
    assert "seekstorm_dev_seconds_count 4" in text
