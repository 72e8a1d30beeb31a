"""Vector and hybrid search of the torch port (seekstorm_tpu_torch) on the
CPU against the JAX package.

  * The committed scan's plain version (``ops/vector.vector_scan_ref``, what
    kernel K4 is held to on the card) against the reference's
    ``ops/vector.vector_scan_topk`` on the same numpy inputs, over every
    static mode, with deleted rows, a threshold that cuts half the queries
    and the ``kk < k`` padding.  i8 is held bitwise (scores, rows, counts):
    the dots are exact integers and the corrections follow the reference's
    contracted order.  f32 differs only by the dot's sum order, so scores
    agree within 2.1*d*2^-24*sum|q_i r_i| (two orders each within
    d*2^-24*sum|q_i r_i| of the exact sum; doubled for Euclidean, plus 4
    ulps of the score), rows agree wherever neighbouring scores stand
    further apart than twice that, and counts differ by at most the rows
    within it of the threshold.
  * ``medoid_select`` against the reference's (i8 bitwise, f32 within the
    same bound) and ``cluster_level`` (Lloyd, PAM, Fixed, Null): order and
    offsets equal on a well-separated Gaussian mixture, where no
    assignment sits between two centroids a few ulps apart.
  * Every behaviour of tests/test_vector.py and tests/test_inference.py
    through both packages: pages, counts and the observed-work counters
    equal, scores bitwise (i8) or within the same bound (f32: the committed
    dots differ by sum order; the realtime tail is the same numpy code).
  * The K4 wrapper: CPU tensors take the plain version, anything it cannot
    launch raises before it builds.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.ops import vector as ref_vec
from seekstorm_tpu_torch.ops import vector as V
from seekstorm_tpu_torch.ops import vector_scan as vs
from test_torch_native import native_for_both
from test_torch_search import _Pair, _to_port


@pytest.fixture(scope="module", autouse=True)
def _native_library():
    """Both packages on the native library (test_torch_native's
    native_for_both)."""
    native_for_both()


EPS = 2.0 ** -24
T = 256
# -inf - -inf in the bound checks of masked entries
pytestmark = pytest.mark.filterwarnings(
    "ignore:invalid value encountered in subtract:RuntimeWarning")


# ---------------------------------------------------------------------------
# the scan and the medoid selection against the reference's, on numpy inputs


def _pool(rng, n_tiles, d, quantized, n_fields=3):
    if quantized:
        data = rng.integers(-128, 128, (n_tiles, T, d)).astype(np.int8)
        scale = (rng.random((n_tiles, T)) * 0.02 + 1e-3).astype(np.float32)
        zp = rng.standard_normal((n_tiles, T)).astype(np.float32)
        qsum = data.astype(np.float32).sum(-1)
        xh = (data.astype(np.float32) + 128.0) * scale[..., None] \
            + zp[..., None]
        norm2 = (xh * xh).sum(-1).astype(np.float32)
    else:
        data = rng.standard_normal((n_tiles, T, d)).astype(np.float32)
        scale = np.ones((n_tiles, T), np.float32)
        zp = np.zeros((n_tiles, T), np.float32)
        qsum = np.zeros((n_tiles, T), np.float32)
        norm2 = (data * data).sum(-1).astype(np.float32)
    docid = np.arange(n_tiles * T, dtype=np.int32).reshape(n_tiles, T)
    docid[-1, T // 2:] = -1
    fieldid = rng.integers(0, n_fields, (n_tiles, T)).astype(np.int32)
    deleted = rng.random(n_tiles * T + 64) < 0.1
    return [data, scale, zp, qsum, norm2, docid, fieldid, deleted]


def _queries(rng, B, d, quantized):
    if quantized:
        q = rng.integers(-128, 128, (B, d)).astype(np.int8)
        qs = (rng.random(B) * 0.02 + 1e-3).astype(np.float32)
        qz = rng.standard_normal(B).astype(np.float32)
        qq = q.astype(np.float32).sum(-1)
        qh = (q.astype(np.float32) + 128.0) * qs[:, None] + qz[:, None]
        qn = (qh * qh).sum(-1).astype(np.float32)
    else:
        q = rng.standard_normal((B, d)).astype(np.float32)
        qs = np.ones(B, np.float32)
        qz = qq = np.zeros(B, np.float32)
        qn = (q * q).sum(-1).astype(np.float32)
    return [q, qs, qz, qq, qn]


def _bound(q, rows, euclidean, scores):
    """Per-query bound on the f32 scores' difference (module docstring)."""
    d = q.shape[1]
    A = (np.abs(q).astype(np.float64) @ np.abs(rows).T.astype(np.float64))
    tol = 2.1 * d * EPS * A.max(axis=1)
    if euclidean:
        tol = 2 * tol + 4 * EPS * np.abs(scores).max(axis=1)
    return tol


def _assert_f32_close(got, want, tol, smin, band):
    (gs, gr, gc), (ws_, wr, wc) = got, want
    t = tol[:, None]
    fin = np.isfinite(gs) & np.isfinite(ws_)
    np.testing.assert_array_equal(fin, np.isfinite(ws_) | np.isfinite(gs))
    assert (np.abs(gs - ws_)[fin] <= np.broadcast_to(t, gs.shape)[fin]).all()
    assert (np.abs(gc.astype(np.int64) - wc) <= band).all()
    w = np.where(fin, ws_, -1e30)
    gap_up = np.concatenate([np.full((len(w), 1), np.inf),
                             w[:, :-1] - w[:, 1:]], 1)
    gap_dn = np.concatenate([w[:, :-1] - w[:, 1:],
                             np.zeros((len(w), 1))], 1)
    iso = fin & (gap_up > 2 * t) & (gap_dn > 2 * t) \
        & (np.abs(w - smin[:, None]) > 2 * t)
    iso[:, -1] = False
    np.testing.assert_array_equal(gr[iso], wr[iso])
    assert iso.sum() > fin.sum() // 4


@pytest.mark.parametrize("use_ff", [False, True], ids=["all_fields", "ff"])
@pytest.mark.parametrize("exhaustive", [True, False], ids=["all", "sel"])
@pytest.mark.parametrize("euclidean", [False, True], ids=["dot", "euclid"])
@pytest.mark.parametrize("quantized", [True, False], ids=["i8", "f32"])
@pytest.mark.parametrize("with_counts", [True, False], ids=["cnt", "nocnt"])
def test_scan_ref_matches_reference(quantized, euclidean, exhaustive, use_ff,
                                    with_counts):
    rng = np.random.default_rng(
        [quantized, euclidean, exhaustive, use_ff, with_counts])
    n_tiles, d, B = 6, 128, 12
    pool = _pool(rng, n_tiles, d, quantized)
    qargs = _queries(rng, B, d, quantized)
    # selected tiles end in -1 padding; kk < k (NT*256 < 2048) in half the
    # cases
    tid = np.array([1, 3, 5, -1], np.int32)
    field_ok = np.array([True, False, True, False])
    k = 2048 if exhaustive == with_counts else 32
    st_kw = dict(quantized=quantized, euclidean=euclidean,
                 with_counts=with_counts, exhaustive=exhaustive,
                 use_field_filter=use_ff)

    def ref(smin, k=k):
        out = ref_vec.vector_scan_topk(*pool, tid, field_ok, *qargs, smin,
                                       k=k, **st_kw)
        return [np.asarray(x) for x in out]

    def port(smin, k=k):
        t = [torch.from_numpy(np.ascontiguousarray(x))
             for x in pool + [tid, field_ok] + qargs + [smin]]
        return [x.numpy() for x in V.vector_scan_topk(*t, k=k, **st_kw)]

    none = np.full(B, -np.inf, np.float32)
    cut = ref(none, k=100)[0][:, -1]             # the 100th best score
    smin = np.where(np.arange(B) % 2 == 0, cut, -np.inf).astype(np.float32)
    want, got = ref(smin), port(smin)
    NT = n_tiles if exhaustive else len(tid)
    kk = min(k, NT * T)
    assert want[0].shape == (B, k) and np.isinf(want[0][:, kk:]).all()
    if with_counts:
        assert (want[2] > 0).all() and (want[2][::2] <= 100).all()
    if quantized:
        np.testing.assert_array_equal(got[0].view(np.int32),
                                      want[0].view(np.int32))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        return
    every = ref(none, k=NT * T)[0]
    rows = pool[0].reshape(-1, d)
    tol = _bound(qargs[0], rows, euclidean,
                 np.where(np.isfinite(every), every, 0))
    band = (np.abs(every - smin[:, None]) <= tol[:, None]).sum(1)
    _assert_f32_close(got, want, tol, smin, band)


@pytest.mark.parametrize("nprobe", [0, 3])
@pytest.mark.parametrize("euclidean", [False, True], ids=["dot", "euclid"])
@pytest.mark.parametrize("quantized", [True, False], ids=["i8", "f32"])
def test_medoid_select_matches_reference(quantized, euclidean, nprobe):
    rng = np.random.default_rng([quantized, euclidean, nprobe, 7])
    C, d, B = 16, 128, 9
    data, scale, zp, qsum, norm2 = _pool(rng, 1, d, quantized)[:5]
    med = [data[0, :C], scale[0, :C], zp[0, :C], qsum[0, :C], norm2[0, :C]]
    valid = np.arange(C) < 13
    always = np.arange(C) == 14
    qargs = _queries(rng, B, d, quantized)
    cthr = np.full(B, -np.inf, np.float32)
    kw = dict(quantized=quantized, euclidean=euclidean, nprobe=nprobe)
    _, s_ref = ref_vec.medoid_select(*med, valid, always, *qargs, cthr, **kw)
    # a cluster threshold that cuts, for odd queries: halfway between the
    # sixth and seventh best of the 13 valid medoids' scores
    top = -np.sort(-np.asarray(s_ref)[:, :13], axis=1)
    cthr = np.where(np.arange(B) % 2 == 1, (top[:, 5] + top[:, 6]) / 2,
                    -np.inf).astype(np.float32)
    sel_r, s_r = (np.asarray(x) for x in ref_vec.medoid_select(
        *med, valid, always, *qargs, cthr, **kw))
    sel_p, s_p = (x.numpy() for x in V.medoid_select(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in med + [valid, always] + qargs + [cthr]), **kw))
    np.testing.assert_array_equal(sel_p, sel_r)
    if quantized:
        np.testing.assert_array_equal(s_p.view(np.int32), s_r.view(np.int32))
    else:
        fin = np.isfinite(s_r)
        tol = _bound(qargs[0], med[0], euclidean, np.where(fin, s_r, 0))
        assert (np.abs(s_p - s_r)[fin]
                <= np.broadcast_to(tol[:, None], s_r.shape)[fin]).all()
        np.testing.assert_array_equal(np.isfinite(s_p), fin)
    assert sel_r.any() and not sel_r.all()


def _mixture(rng, n=2000, d=32, n_centers=25):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 5.0
    assign = rng.integers(0, n_centers, size=n)
    data = (centers[assign] + rng.standard_normal((n, d))).astype(np.float32)
    return centers, data


@pytest.mark.parametrize("case", ["lloyd", "pam", "fixed", "null"])
def test_cluster_level_matches_reference(case, monkeypatch):
    from seekstorm_tpu.clustering import cluster_level as ref_cluster
    from seekstorm_tpu_torch.clustering import cluster_level as port_cluster

    if case == "pam":
        monkeypatch.setenv("SEEKSTORM_TPU_CLUSTER_ALGO", "pam")
    _, data = _mixture(np.random.default_rng(3))
    mode = {"fixed": "Fixed", "null": "Null"}.get(case, "Auto")
    for sim in ("Euclidean", "Dot"):
        cfg_r = st.ClusteringConfig(mode=st.ClusteringMode[mode],
                                    cluster_count=10, min_points=100)
        order_r, off_r = ref_cluster(data, st.VectorSimilarity[sim], cfg_r)
        order_p, off_p = port_cluster(data, pt.VectorSimilarity[sim],
                                      _to_port(cfg_r), device="cpu")
        np.testing.assert_array_equal(order_p, order_r)
        np.testing.assert_array_equal(off_p, off_r)
        assert (len(off_r) > 2) == (case != "null")
        if case == "fixed":
            assert len(off_r) == 11


# ---------------------------------------------------------------------------
# the reference's vector behaviours, through both packages


def _meta(pkg, dim, similarity, precision="I8",
          quantization="ScalarQuantizationI8", clustering="Auto",
          min_points=100):
    return pkg.IndexMeta(vector=pkg.VectorConfig(
        enabled=True, dim=dim, similarity=pkg.VectorSimilarity[similarity],
        precision=pkg.Precision[precision],
        quantization=pkg.Quantization[quantization],
        inference=pkg.InferenceType.External,
        clustering=pkg.ClusteringConfig(
            mode=pkg.ClusteringMode[clustering], min_points=min_points)))


def _vec_schema(pkg):
    return [pkg.SchemaField("vector", pkg.FieldType.Json, index_vector=True),
            pkg.SchemaField("label", pkg.FieldType.Text, stored=True)]


def _both(path, schema_fn, meta_fn, docs, shard_count=1, tail=()):
    """One index per package: `docs` committed, `tail` left uncommitted."""
    out = []
    for pkg in (st, pt):
        kw = {"device": "cpu"} if pkg is pt else {}
        idx = pkg.create_index(path / pkg.__name__, schema_fn(pkg),
                               meta=meta_fn(pkg), shard_count=shard_count,
                               **kw)
        idx.index_documents(list(docs))
        idx.commit()
        if tail:
            idx.index_documents(list(tail))
        out.append(idx)
    return _Pair(*out)


def _search(pair, reqs, bound=None):
    """The requests through both packages; pages, counts and observed
    counters equal; scores bitwise, or for an f32 index within `bound` of
    the ranking score (a Euclidean page's distance d is the score -d^2).
    Returns the port's results."""
    ref = st.search_batch(pair.ref, reqs)
    port = pt.search_batch(pair.port, _to_port(reqs), device="cpu")
    euclid = pair.ref.meta.vector.similarity == st.VectorSimilarity.Euclidean
    for a, b in zip(ref, port):
        assert [r.doc_id for r in b.results] == [r.doc_id for r in a.results]
        assert (b.result_count, b.result_count_total,
                b.observed_vector_count, b.observed_cluster_count) == (
            a.result_count, a.result_count_total, a.observed_vector_count,
            a.observed_cluster_count)
        sa = np.array([r.score for r in a.results])
        sb = np.array([r.score for r in b.results])
        if bound is None or reqs[0].search_mode == st.SearchMode.Hybrid:
            np.testing.assert_array_equal(sb, sa)
        elif euclid:
            np.testing.assert_allclose(sb * sb, sa * sa, rtol=0, atol=bound)
        else:
            np.testing.assert_allclose(sb, sa, rtol=0, atol=bound)
    return port


def _bound_of(queries, data):
    """The f32 bound for these queries and vectors: two dot sum orders
    differ by at most 2.1*d*2^-24*|q||x| (Cauchy-Schwarz on the module
    docstring's bound), doubled for the Euclidean form, plus 4 ulps of the
    largest score."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    x = np.atleast_2d(np.asarray(data, np.float64))
    d = max(q.shape[1], 128)
    nq, nx = np.linalg.norm(q, axis=1).max(), np.linalg.norm(x, axis=1).max()
    return 4.2 * d * EPS * nq * nx + 4 * EPS * (nq + nx) ** 2


def _vreq(v, **kw):
    return st.SearchRequest(search_mode=st.SearchMode.Vector,
                            query_vector=np.asarray(v).tolist(), **kw)


def test_external_lifecycle(tmp_path):
    """tests/test_vector.py::test_external_lifecycle: 3 external f32
    vectors on 2 shards, All returns all 3, nearest first; both reopen in
    either package."""
    vecs = [np.arange(1, 129, dtype=np.float32) * 0.001 + i * 0.128
            for i in range(3)]
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, 128, "Euclidean", "F32", "Null", "Null"),
                 [{"vector": v.tolist(), "label": str(i)}
                  for i, v in enumerate(vecs)], shard_count=2)
    assert pair.port.indexed_doc_count == 3
    assert pair.port.info()["vector_count"] == \
        pair.ref.info()["vector_count"]
    rs, = _search(pair, [_vreq(vecs[0], result_type=st.ResultType.TopkCount)],
                  bound=_bound_of(vecs, vecs))
    assert len(rs.results) == rs.result_count == rs.result_count_total == 3
    assert rs.results[0].doc_id == 0 and rs.results[0].score < 1e-3
    for opened in (pt.open_index(pair.port.path, device="cpu"),
                   pt.open_index(pair.ref.path, device="cpu")):
        rs = pt.search(opened, _to_port(_vreq(vecs[1])), device="cpu")
        assert rs.results[0].doc_id == 1
    rs = st.search_batch(st.open_index(pair.port.path), [_vreq(vecs[2])])[0]
    assert rs.results[0].doc_id == 2


@pytest.mark.parametrize("similarity", ["Cosine", "Dot", "Euclidean"])
def test_recall_vs_bruteforce(tmp_path, similarity):
    """i8 exhaustive scan reproduces the exact f32 top-10 (recall >= 0.9),
    and equals the reference's pages bit for bit."""
    rng = np.random.default_rng(11)
    n, d = 600, 64
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((8, d)).astype(np.float32)
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, d, similarity, clustering="Null"),
                 [{"vector": data[i].tolist(), "label": str(i)}
                  for i in range(n)])
    if similarity == "Cosine":
        dn = data / np.linalg.norm(data, axis=1, keepdims=True)
        sims = (queries / np.linalg.norm(queries, axis=1,
                                         keepdims=True)) @ dn.T
    elif similarity == "Dot":
        sims = queries @ data.T
    else:
        sims = -((queries ** 2).sum(1)[:, None] + (data ** 2).sum(1)[None]
                 - 2 * queries @ data.T)
    out = _search(pair, [_vreq(q, length=10) for q in queries])
    for qi, rs in enumerate(out):
        truth = set(np.argsort(-sims[qi])[:10].tolist())
        assert len({r.doc_id for r in rs.results} & truth) >= 9


@pytest.mark.parametrize("algo", ["lloyd", "pam"])
def test_nprobe_recall(tmp_path, algo, monkeypatch):
    """IVF nprobe on a Gaussian mixture (tests/test_vector.py's
    test_nprobe_recall and test_pam_build_clustering): the same clusters,
    pages and observed counters; recall grows with nprobe, >= 0.8 at 16."""
    if algo == "pam":
        monkeypatch.setenv("SEEKSTORM_TPU_CLUSTER_ALGO", "pam")
    rng = np.random.default_rng(5)
    centers, data = _mixture(rng)
    # 8 queries: a batch at which the reference's gathered scan contracts
    # in one order throughout (ops/vector.py's docstring)
    queries = (centers[rng.integers(0, 25, size=8)]
               + rng.standard_normal((8, 32))).astype(np.float32)
    pair = _both(tmp_path, _vec_schema, lambda p: _meta(p, 32, "Euclidean"),
                 [{"vector": data[i].tolist(), "label": str(i)}
                  for i in range(len(data))])
    lv_r = pair.ref.vectors.shards[0].levels[0]
    lv_p = pair.port.vectors.shards[0].levels[0]
    assert lv_p.n_clusters == lv_r.n_clusters > 1
    np.testing.assert_array_equal(lv_p.docid, lv_r.docid)
    sims = -((queries ** 2).sum(1)[:, None] + (data ** 2).sum(1)[None]
             - 2 * queries @ data.T)
    recalls = {}
    for nprobe in (2, 16):
        out = _search(pair, [_vreq(q, length=10, ann_mode="Nprobe",
                                   nprobe=nprobe) for q in queries])
        assert all(rs.observed_cluster_count == nprobe for rs in out)
        recalls[nprobe] = sum(
            len({r.doc_id for r in rs.results}
                & set(np.argsort(-sims[qi])[:10].tolist()))
            for qi, rs in enumerate(out)) / 80
    assert recalls[16] >= recalls[2] and recalls[16] >= 0.8, recalls


def test_realtime_tail_and_multivector(tmp_path):
    """A committed doc and an uncommitted two-chunk doc: the tail hit
    first, deduplicated; a delete removes it; realtime=False skips it."""
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 16)).astype(np.float32)
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, 16, "Cosine", clustering="Null"),
                 [{"vector": a.tolist(), "label": "committed"}],
                 tail=[{"vector": [b.tolist(), (b * 2).tolist()],
                        "label": "tail"}])
    rs, = _search(pair, [_vreq(b, length=10)])
    assert rs.results[0].doc_id == 1
    assert [r.doc_id for r in rs.results].count(1) == 1
    rs, = _search(pair, [_vreq(b, length=10, realtime=False)])
    assert [r.doc_id for r in rs.results] == [0]
    for idx in (pair.ref, pair.port):
        idx.delete_document(1)
    rs, = _search(pair, [_vreq(b, length=10)])
    assert 1 not in [r.doc_id for r in rs.results]


def test_deleted_committed_and_counts(tmp_path):
    """Deletes of committed docs reach the cached deleted mask; TopkCount
    and Count count the live rows, Topk pages count the ranked ones."""
    rng = np.random.default_rng(13)
    data = rng.standard_normal((300, 24)).astype(np.float32)
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, 24, "Dot", clustering="Null"),
                 [{"vector": v.tolist(), "label": "x"} for v in data])
    reqs = [_vreq(data[i], length=5, result_type=rt) for i in (0, 7)
            for rt in (st.ResultType.Topk, st.ResultType.TopkCount,
                       st.ResultType.Count)]
    _search(pair, reqs)                     # builds the deleted masks
    for idx in (pair.ref, pair.port):
        idx.delete_documents([0, 1, 2, 50])
    out = _search(pair, reqs)
    assert 0 not in [r.doc_id for r in out[0].results]
    assert out[1].result_count_total == 296


def test_similarity_threshold(tmp_path):
    """An f32 cosine threshold of 0.5 keeps the query's own basis vector
    alone, under SimilarityThreshold and NprobeSimilarityThreshold."""
    base = np.eye(8, dtype=np.float32)
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, 8, "Cosine", "F32", "Null", "Null"),
                 [{"vector": base[i].tolist(), "label": str(i)}
                  for i in range(8)])
    for mode in ("SimilarityThreshold", "NprobeSimilarityThreshold"):
        rs, = _search(pair, [_vreq(base[0], length=10, ann_mode=mode,
                                   nprobe=2, similarity_threshold=0.5,
                                   result_type=st.ResultType.TopkCount)],
                      bound=_bound_of(base, base))
        assert [r.doc_id for r in rs.results] == [0]
        assert rs.result_count_total == 1


def test_hybrid_rrf(tmp_path):
    """RRF fusion of the lexical and vector lists (k = 0.6): the same
    fused page in both packages, its head the manual fusion's best."""
    rng = np.random.default_rng(17)
    vs_ = rng.standard_normal((4, 16)).astype(np.float32)

    def schema(pkg):
        return [pkg.SchemaField("text", pkg.FieldType.Text, stored=True,
                                indexed=True),
                pkg.SchemaField("vector", pkg.FieldType.Json,
                                index_vector=True)]

    texts = ["apple banana", "banana cherry", "cherry date", "date apple"]
    pair = _both(tmp_path, schema,
                 lambda p: _meta(p, 16, "Cosine", clustering="Null"),
                 [{"text": t, "vector": v.tolist()}
                  for t, v in zip(texts, vs_)])
    rs, = _search(pair, [st.SearchRequest(
        query="banana", search_mode=st.SearchMode.Hybrid,
        query_vector=vs_[2].tolist(), length=4)])
    lex = pt.search(pair.port, pt.SearchRequest(query="banana", length=4),
                    device="cpu")
    vec = pt.search(pair.port, _to_port(_vreq(vs_[2], length=4)),
                    device="cpu")
    fused = {}
    for lst in (lex.results, vec.results):
        for rank, r in enumerate(lst):
            fused[r.doc_id] = fused.get(r.doc_id, 0) + 1 / (0.6 + rank)
    assert rs.results[0].doc_id == max(fused.items(),
                                       key=lambda kv: kv[1])[0]


def test_turboquant_qjl_quantizer():
    """The port's quantize module is the reference's: TurboQuant's stored
    form and preprocessing equal, bit for bit."""
    from seekstorm_tpu import quantize as rq
    from seekstorm_tpu_torch import quantize as pq

    x = np.random.default_rng(3).normal(0, 1, (500, 96)).astype(np.float32)
    for quant in ("TurboQuantI8", "ScalarQuantizationI8"):
        a = rq.prepare_vectors(x, st.VectorSimilarity.Dot, st.Precision.I8,
                               st.Quantization(quant))
        b = pq.prepare_vectors(x, pt.VectorSimilarity.Dot, pt.Precision.I8,
                               pt.Quantization(quant))
        for f in ("data", "scale", "zp", "qsum", "norm2"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    c = pq.prepare_vectors(x, pt.VectorSimilarity.Dot, pt.Precision.I8,
                           pt.Quantization.TurboQuantI8)
    np.testing.assert_allclose(c.zp, -128.0 * c.scale, rtol=1e-6)


def test_global_recluster_field_alignment(tmp_path):
    """The device build's global re-cluster keeps per-row metadata aligned:
    field-filtered nprobe search through both packages."""
    rng = np.random.default_rng(5)
    A = rng.normal(0, 5, (200, 8)).astype(np.float32)
    B = rng.normal(50, 5, (200, 8)).astype(np.float32)

    def schema(pkg):
        return [pkg.SchemaField("a", pkg.FieldType.Json, index_vector=True),
                pkg.SchemaField("b", pkg.FieldType.Json, index_vector=True)]

    pair = _both(tmp_path, schema,
                 lambda p: _meta(p, 8, "Euclidean", "F32", "Null",
                                 min_points=32),
                 [{"a": A[i], "b": B[i]} for i in range(200)])
    for idx in (pair.ref, pair.port):
        idx.vectors._global_recluster = lambda levels, n: n >= 32
    kw = dict(length=3, top_n=3, ann_mode="Nprobe", nprobe=4, realtime=False)
    bound = _bound_of(np.concatenate([A, B]) + 0.01, np.concatenate([A, B]))
    r, = _search(pair, [_vreq(A[150] + 0.01, **kw)], bound=bound)
    assert r.results and r.results[0].doc_id == 150
    rb, = _search(pair, [_vreq(B[7] + 0.01, field_filter=["b"], **kw)],
                  bound=bound)
    assert rb.results and rb.results[0].doc_id == 7
    dev = pair.port.vectors.device(pair.port.shards[0], "cpu")
    assert dev["n_clusters"] > 1


def test_mesh_vector_build_one_position(tmp_path):
    """The mesh build: a one-position mesh holds the shard's device tensors
    themselves (no second copy), with its clusters' row counts."""
    pair = _both(tmp_path, _vec_schema,
                 lambda p: _meta(p, 8, "Dot", clustering="Null"),
                 [{"vector": [1.0] * 8, "label": "x"}])
    mesh = pt.make_mesh(["cpu"])
    out = pair.port.vectors.device_stacked(mesh)
    one = pair.port.vectors.device(pair.port.shards[0], "cpu")
    pos, = out["positions"]
    h, = pos["shards"]
    assert h is one and out["per_shard"] == [one]
    assert (out["n_tiles"], out["C_pad"]) == (one["n_tiles"], one["C_pad"])
    assert one["sizes"].tolist() == [1] + [0] * (one["C_pad"] - 1)


# ---------------------------------------------------------------------------
# tests/test_inference.py through both packages


@pytest.fixture()
def model_dir(tmp_path):
    words = ["cat", "dog", "fish", "bird", "car", "bike", "train", "plane",
             "red", "blue", "green", "fast", "slow", "big", "small", "the",
             "a", "is", "very"]
    emb = np.random.default_rng(21).standard_normal(
        (len(words), 16)).astype(np.float32)
    p = tmp_path / "model"
    p.mkdir()
    np.save(p / "embeddings.npy", emb)
    with open(p / "vocab.json", "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)
    return p, words, emb


INF = [importlib.import_module(f"{pkg}.inference")
       for pkg in ("seekstorm_tpu", "seekstorm_tpu_torch")]


@pytest.mark.parametrize("text,limit", [
    ("First sentence. Second one! Third? " + "x" * 50, 30),
    ("", 100), ("y" * 500, 100),
    ("Mixed. Sentences here, and a very long one " * 20, 64)])
def test_chunking(text, limit):
    ref, port = (m.chunk_text(text, limit) for m in INF)
    assert port == ref
    assert "".join(port).replace(" ", "") == text.replace(" ", "")


def test_model_encode(model_dir):
    p, words, emb = model_dir
    ref, port = (m.Model2Vec.load(p) for m in INF)
    texts = ["cat dog", "zzzz unknown", "the very big red car"]
    np.testing.assert_array_equal(port.encode(texts), ref.encode(texts))
    np.testing.assert_allclose(port.encode(["cat dog"])[0],
                               (emb[0] + emb[1]) / 2, rtol=1e-6)


@pytest.mark.parametrize("cached", [False, True], ids=["missing", "cached"])
def test_predefined_model_names(tmp_path, monkeypatch, cached):
    """Predefined Model2Vec names resolve from a local cache dir or raise
    the no-download error, in both packages."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "nohub"))
    if cached:
        d = tmp_path / "minishlab--potion-base-2M"
        d.mkdir()
        np.save(d / "embeddings.npy", np.ones((8, 4), np.float32))
        (d / "vocab.json").write_text(
            json.dumps({chr(97 + i): i for i in range(8)}))
        monkeypatch.setenv("SEEKSTORM_TPU_MODEL_DIR", str(tmp_path))
        assert [m.Model2Vec.load("minishlab/potion-base-2M").dim
                for m in INF] == [4, 4]
        return
    monkeypatch.delenv("SEEKSTORM_TPU_MODEL_DIR", raising=False)
    for m in INF:
        with pytest.raises(RuntimeError, match="network download"):
            m.Model2Vec.load("minishlab/potion-base-2M")
        with pytest.raises(RuntimeError, match="Model2VecCustom"):
            m.Model2Vec.load("minishlab/potion-base-2M")


def test_text_vector_index_end_to_end(tmp_path, model_dir):
    """Model2VecCustom inference at ingest and for the query string:
    vector and hybrid pages equal in both packages."""
    p, _, emb = model_dir
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)

    def meta(pkg):
        return pkg.IndexMeta(vector=pkg.VectorConfig(
            enabled=True, dim=0, similarity=pkg.VectorSimilarity.Cosine,
            precision=pkg.Precision.F32, quantization=pkg.Quantization.Null,
            inference=pkg.InferenceType.Model2VecCustom, model=str(p),
            chunk_size=1000,
            clustering=pkg.ClusteringConfig(mode=pkg.ClusteringMode.Null)))

    def schema(pkg):
        return [pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                                indexed=True, index_vector=True)]

    pair = _both(tmp_path, schema, meta, [
        {"body": "the cat is very big"}, {"body": "a fast red car"},
        {"body": "the blue bird is small"}])
    rs, = _search(pair, [st.SearchRequest(
        query="fast car", search_mode=st.SearchMode.Vector, length=3)],
        bound=_bound_of(emb, emb))
    assert rs.results[0].doc_id == 1
    rs, = _search(pair, [st.SearchRequest(
        query="cat", search_mode=st.SearchMode.Hybrid, length=3)])
    assert rs.results


# ---------------------------------------------------------------------------
# K4's split: the top-kk of each contiguous slot range, then the merge


def _split_inputs(rng, quantized, euclidean, n_tiles=7, d=128, B=12):
    """A pool where tile 4 repeats tile 1 (equal scores in two ranges),
    every row of tile 2 is deleted (a range with no admitted row), and in
    f32 query 0 is zero with |q|^2 = -0 against tile 3's |r|^2 of -0 and
    +0 in its first 32 rows (Euclidean scores +0 and -0, tied by
    position, at the top of every query's page)."""
    pool = _pool(rng, n_tiles, d, quantized)
    data, scale, zp, qsum, norm2, docid, fieldid, deleted = pool
    for x in (data, scale, zp, qsum, norm2, fieldid):
        x[4] = x[1]
    deleted[docid[2]] = True
    qargs = _queries(rng, B, d, quantized)
    if not quantized:
        qargs[0][0] = 0.0
        qargs[4] = qargs[4].copy()
        qargs[4][0] = -0.0
        norm2[3, :32:2] = -0.0
        norm2[3, 1:32:2] = 0.0
    # a threshold at the 100th best score for half the queries
    smin = np.full(B, -np.inf, np.float32)
    return pool, qargs, smin


def _split_args(mode, k):
    """_split_inputs as tensors with their keywords and NT: tiles 0-6 (all)
    or 0, 1, 2, 4, 6 and three -1 slots (sel), a field filter on the
    selected ones, and a threshold at the 100th best score for the odd
    queries."""
    quantized = mode.startswith("i8")
    exhaustive = "_all_" in mode
    euclidean = mode.endswith("euclid")
    rng = np.random.default_rng([quantized, exhaustive, k])
    pool, qargs, smin = _split_inputs(rng, quantized, euclidean)
    tid = np.array([0, 1, 2, 4, 6, -1, -1, -1], np.int32)
    field_ok = np.array([True, False, True, True])
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in pool + [tid, field_ok] + qargs + [smin]]
    kw = dict(quantized=quantized, euclidean=euclidean, with_counts=True,
              exhaustive=exhaustive, use_field_filter=not exhaustive)
    cut = V.vector_scan_ref(*t, k=100, **kw)[0][:, -1]
    t[-1] = torch.where(torch.arange(len(smin)) % 2 == 1, cut, t[-1])
    return t, kw, 7 if exhaustive else len(tid)


def _assert_bitwise(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("G", ["one", "three", "over_NT"])
@pytest.mark.parametrize("mode", ["i8_all_euclid", "i8_sel_dot",
                                  "f32_all_euclid", "f32_sel_euclid"])
def test_split_ref_equals_one_scan(mode, G, k):
    """vector_scan_split_ref (each of G slot ranges' top kk, merged in
    range order) equals one vector_scan_ref bitwise: scores, rows, counts,
    with ties across ranges, -0 and +0, a range of deleted rows, a
    threshold that cuts half the queries, -1 padding slots and G > NT."""
    t, kw, NT = _split_args(mode, k)
    n = {"one": 1, "three": 3, "over_NT": NT + 2}[G]
    want = V.vector_scan_ref(*t, k=k, **kw)
    _assert_bitwise(V.vector_scan_split_ref(*t, k=k, n_ranges=n, **kw), want)
    # the cases hold what they claim: equal scores from tiles 1 and 4,
    # fewer admitted rows than kk for the cut queries, and (f32) both zeros
    s, r = want[0], want[1].long()
    assert (want[2][1::2] <= 102).all()        # 100 and its ties
    if k > 100:
        assert torch.isinf(s[1::2, -1]).all()
        assert ((r // T == 1).any(dim=1) & (r // T == 4).any(dim=1)).any()
    if not kw["quantized"] and kw["euclidean"] and kw["exhaustive"]:
        zeros = s[0][s[0] == 0]
        assert (zeros.view(torch.int32) == 0).any()
        assert (zeros.view(torch.int32) != 0).any()


@pytest.mark.parametrize("k", [16, 32, 48, 64])
@pytest.mark.parametrize("G", ["one", "three", "NT"])
@pytest.mark.parametrize("mode", ["i8_all_euclid", "i8_sel_dot",
                                  "f32_all_euclid", "f32_sel_euclid"])
def test_running_ref_equals_one_scan(mode, G, k):
    """vector_scan_running_ref (the running scan's ranges walked in turns
    under its three thresholds, then the merge under the shared one)
    equals one vector_scan_ref bitwise on the split cases."""
    t, kw, NT = _split_args(mode, k)
    n = {"one": 1, "three": 3, "NT": NT}[G]
    _assert_bitwise(V.vector_scan_running_ref(*t, k=k, n_ranges=n, **kw),
                    V.vector_scan_ref(*t, k=k, **kw))


@pytest.mark.parametrize("B,n_sel,k,G", [
    (3, 0, 32, 40), (1, 32, 32, 32), (5, 0, 16, 16), (2, 36, 32, 36),
    (3, 0, 64, 70), (1, 64, 64, 64), (2, 70, 64, 70)])
def test_running_ref_ties_at_the_threshold(B, n_sel, k, G):
    """Forty copies of one tile (70 where the ranges or the selected tiles
    need them; no row deleted): every range's first slot holds the same
    best score, so the largest bucket is the kk-th best key itself when G
    >= kk, and that row must still enter its list.  All tiles or the first
    n_sel, G ranges (G == kk, G > kk), pages of 32 and 64 entries, bitwise
    equal to vector_scan_ref."""
    rng = np.random.default_rng([B, n_sel, k, G])
    pool = _pool(rng, max(40, G, n_sel), 128, True)
    for x in (pool[0], pool[1], pool[2], pool[3], pool[4], pool[6]):
        x[:] = x[0]
    pool[7][:] = False
    tid = np.arange(max(n_sel, 1), dtype=np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in pool + [tid, np.ones(4, bool)] + _queries(rng, B, 128, True)
         + [np.full(B, -np.inf, np.float32)]]
    kw = dict(quantized=True, euclidean=True, with_counts=True,
              exhaustive=n_sel == 0, use_field_filter=False)
    want = V.vector_scan_ref(*t, k=k, **kw)
    _assert_bitwise(V.vector_scan_running_ref(*t, k=k, n_ranges=G, **kw),
                    want)
    # the page's first score comes from the first kk tiles, one row each
    assert (want[0] == want[0][:, :1]).all()
    assert torch.equal(want[1] // T, torch.arange(k).expand(B, k).int())


@pytest.mark.parametrize("NT,B,k,n_sm,G", [
    (4096, 64, 32, 132, 132), (4096, 256, 16, 132, 33), (4, 1, 32, 132, 4),
    (4, 65, 16, 132, 4), (100, 1000, 32, 132, 8), (3, 9000, 32, 132, 1),
    (4096, 64, 32, 300, 256), (4096, 64, 33, 132, 132), (4, 1, 256, 132, 0),
    (4096, 128, 64, 132, 66), (4096, 64, 65, 132, 0)])
def test_k4_ranges(NT, B, k, n_sm, G):
    """The running scan's G: one CTA an SM over the query blocks, at least
    one, at most one range a slot and 256 in all; 0, the per-tile scan, for
    pages deeper than 64."""
    assert vs.n_ranges(NT, B, k, n_sm) == G


@pytest.mark.parametrize("per_tile", [False, True])
def test_k4_counts_its_per_tile_calls(per_tile):
    """Every K4 call adds one to k4_launches_total and, where it took the
    per-tile scan, one to k4_per_tile_total; a running-scan call adds 0,
    so the counter is there from the first call on."""
    n0 = vs.LAUNCHES
    before = pt.METRICS.snapshot()
    vs._count_launch(per_tile)
    after = pt.METRICS.snapshot()
    vs.LAUNCHES = n0
    assert after["k4_launches_total"] == before.get("k4_launches_total",
                                                    0) + 1
    assert after["k4_per_tile_total"] == before.get("k4_per_tile_total",
                                                    0) + per_tile


# ---------------------------------------------------------------------------
# the K4 wrapper


def _wrapper_inputs(quantized=True):
    rng = np.random.default_rng(1)
    pool = _pool(rng, 3, 128, quantized)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in pool + [np.array([0, 2, -1, -1], np.int32),
                          np.ones(4, bool)] + _queries(rng, 5, 128,
                                                       quantized)
         + [np.full(5, -np.inf, np.float32)]]
    return t, dict(k=32, quantized=quantized, euclidean=True,
                   with_counts=True, exhaustive=False, use_field_filter=True)


def test_k4_wrapper_routes_cpu_tensors_to_the_plain_version():
    args, kw = _wrapper_inputs()
    vs.LAUNCHES = 0
    got = V.vector_scan_topk(*args, **kw)
    want = V.vector_scan_ref(*args, **kw)
    assert vs.LAUNCHES == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no vector scan"):
        V.vector_scan_topk(*meta, **kw)


def test_k4_wrapper_checks_inputs_before_launch():
    """vector_scan_cuda refuses tensors on the CPU, a wrong dtype, shape or
    width before it builds or launches anything; without a card the
    entry points refuse "cuda"."""
    args, kw = _wrapper_inputs()
    names = ["data", "r_scale", "r_zp", "r_qsum", "r_norm2", "row_docid",
             "row_field", "deleted", "tile_ids", "field_ok", "q_data",
             "q_scale", "q_zp", "q_qsum", "q_norm2", "score_min"]
    with pytest.raises(ValueError, match="CUDA"):
        vs.vector_scan_cuda(*args, **kw)
    meta = [x.to("meta") for x in args]
    bad = [("data", meta[0].float()), ("data", meta[0][:, :128]),
           ("r_scale", meta[1][:, :7]), ("row_docid", meta[5].long()),
           ("q_data", meta[10][:, :64]), ("tile_ids", meta[8].long()),
           ("score_min", meta[15][:3]), ("data", torch.zeros(
               (3, 256, 96), dtype=torch.int8, device="meta"))]
    for name, x in bad:
        a = list(meta)
        a[names.index(name)] = x
        with pytest.raises(ValueError, match=name):
            vs.vector_scan_cuda(*a, **kw)
    assert vs.LAUNCHES == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.search_batch(None, [pt.SearchRequest(
                search_mode=pt.SearchMode.Vector, query_vector=[1.0])])
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.create_index("/nonexistent", _vec_schema(pt),
                            meta=_meta(pt, 8, "Dot"))
