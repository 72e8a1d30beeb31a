"""The tf path of the torch port (seekstorm_tpu_torch) on the CPU against the
JAX package: ``field_filter`` batches, whose boost profile differs from the
commit-time one.

First the scan itself: the same numpy inputs, made from a seed, go through
the reference's jitted ``ops/lexical.lexical_scan`` (with ``_block_step``)
and through the port's ``ops/lexical.tf_scan`` / ``tf_scan_pairs``.
Tolerance: none.  Scores, doc ids, counts and facet counts are equal bit for
bit, because the port writes the reference's sums in the order XLA's CPU
backend gives them (fma chains over the fields, the slots and the dense
rows).

Then the path end to end: the same documents and requests through
``seekstorm_tpu.search_batch`` and ``seekstorm_tpu_torch.search_batch`` on
the CPU, one and two shards, committed docs (with a term dense enough for
the dense-term store) and the realtime tail: counts, facet lists and page
ids exact, scores within rtol 3e-5 (the bound of the search parity tests),
sort keys exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from seekstorm_tpu_torch import plan as pp
from seekstorm_tpu_torch.ops import lexical as lx
from test_torch_facets import _both
from test_torch_search import _Pair, _create, _to_port
from test_wand import _Page

ref_lex = importlib.import_module("seekstorm_tpu.ops.lexical")
port_search = importlib.import_module("seekstorm_tpu_torch.search")

NB = 2            # blocks of the synthetic index
VPAD = 32         # the slot axis as StackedIndex.run pads it
FCM = 16


def _synth(seed, boosts, n_dense, B=16, V=6):
    """A random two-block index in the tf layout (sorted posting ranges with
    per-field tf, comp, dense-term rows, deleted docs, facet codes, a sort
    key) and a random batch over it (weights, required and negated slots)."""
    rng = np.random.default_rng(seed)
    F = len(boosts)
    docids, tfs, off = [], [], 0
    seg_off = np.zeros((NB, VPAD), np.int32)
    seg_len = np.zeros((NB, VPAD), np.int32)
    for b in range(NB):
        for v in range(V - n_dense):
            n = int(rng.integers(50, 3000))
            docids.append(np.sort(rng.choice(BLOCK_SIZE, n, replace=False)))
            tfs.append(rng.integers(0, 6, (n, F)))     # a field may hold 0
            seg_off[b, v], seg_len[b, v] = off, n
            off += n
    VD = 4
    dense_ids = np.full((NB, VD), -1, np.int32)
    dense_slots = np.zeros((NB, VD), np.int32)
    for b in range(NB):
        for j in range(n_dense):
            dense_ids[b, j] = b * n_dense + j
            dense_slots[b, j] = V - n_dense + j
    nd = max(n_dense * NB, 1)
    dense_tf = (rng.integers(0, 4, (nd, BLOCK_SIZE, F))
                * (rng.random((nd, BLOCK_SIZE, F)) < 0.6))
    W = np.zeros((B, VPAD), np.float32)
    REQ = np.zeros((B, VPAD), bool)
    NEG = np.zeros((B, VPAD), bool)
    for q in range(B):
        for s in rng.choice(V, int(rng.integers(1, 5)), replace=False):
            if rng.random() < 0.2 and (W[q] > 0).any():
                NEG[q, s] = True
            else:
                W[q, s] = rng.random() * 5 + 0.5
                REQ[q, s] = rng.random() < 0.3
    return dict(
        pl_docid=np.concatenate(docids).astype(np.uint16),
        pl_tf=np.concatenate(tfs).astype(np.uint16),
        comp=(rng.random((NB * BLOCK_SIZE, F)) * 2.5 + 0.3).astype(np.float32),
        deleted=rng.random(NB * BLOCK_SIZE) < 0.02,
        seg_off=seg_off, seg_len=seg_len, W=W, REQ=REQ & ~NEG, NEG=NEG,
        boosts=np.asarray(boosts, np.float32),
        dense_tf=dense_tf.astype(np.uint16), dense_ids=dense_ids,
        dense_slots=dense_slots,
        fcod=rng.integers(-2, FCM + 3, (2, NB * BLOCK_SIZE)).astype(np.int32),
        skey=rng.choice(np.float32([-3.0, 0.0, 1.5, 7.0, 9.25]),
                        NB * BLOCK_SIZE))


def _reference_scan(x, k, facets, sort_desc):
    """lexical_scan on x as StackedIndex.run calls it (one shard)."""
    B = x["W"].shape[0]
    P_max = 4096
    while P_max < int(x["seg_len"].sum(axis=1).max()):
        P_max *= 2
    bst = np.zeros((VPAD, len(x["boosts"])), np.float32)
    bst[:] = x["boosts"]
    use_sort = sort_desc is not None
    ts, ti, cnt, fc = ref_lex.lexical_scan(
        jnp.asarray(x["pl_docid"]), jnp.asarray(x["pl_tf"]),
        jnp.asarray(x["comp"]), jnp.asarray(x["deleted"]),
        jnp.arange(NB, dtype=jnp.int32), jnp.asarray(x["seg_off"]),
        jnp.asarray(x["seg_len"]),
        jnp.full((NB, (B + 31) // 32), -1, jnp.int32),
        jnp.asarray(x["W"]),
        jnp.asarray(np.where(x["NEG"], np.float32(-1e4),
                             x["REQ"].astype(np.float32))),
        jnp.asarray(x["REQ"].sum(axis=1).astype(np.int32)), jnp.asarray(bst),
        jnp.asarray(x["fcod"]) if facets else jnp.zeros((1, 1), jnp.int32),
        jnp.asarray(x["skey"]) if use_sort else jnp.zeros((1,), jnp.float32),
        jnp.asarray(x["dense_tf"]), jnp.asarray(x["dense_ids"]),
        jnp.asarray(x["dense_slots"]),
        P_max=P_max, k=k, with_counts=True, n_facets=2 if facets else 0,
        facet_codes_max=FCM if facets else 1, use_sort_key=use_sort,
        sort_desc=bool(sort_desc))
    return (np.asarray(ts), np.asarray(ti), np.asarray(cnt), np.asarray(fc))


def _port_inputs(x, order=None):
    """x as the port's tf arrays and pair tables (every block of every
    query, block-major; `order` permutes the pairs)."""
    B = x["W"].shape[0]
    use = (x["W"] != 0) | x["REQ"] | x["NEG"]
    T = int(use.sum(axis=1).max())
    pb, pq = np.divmod(np.arange(NB * B), B)
    if order is not None:
        pb, pq = pb[order], pq[order]
    P = len(pb)
    s_off = np.zeros((P, T), np.int64)
    s_len = np.zeros((P, T), np.int32)
    s_dense = np.full((P, T), -1, np.int32)
    s_w = np.zeros((P, T), np.float32)
    s_flag = np.zeros((P, T), np.int32)
    for p, (b, q) in enumerate(zip(pb, pq)):
        for j, v in enumerate(np.flatnonzero(use[q])):
            s_off[p, j], s_len[p, j] = x["seg_off"][b, v], x["seg_len"][b, v]
            hit = np.flatnonzero((x["dense_ids"][b] >= 0)
                                 & (x["dense_slots"][b] == v))
            if len(hit):
                s_dense[p, j] = x["dense_ids"][b, hit[0]]
            s_w[p, j] = x["W"][q, v]
            s_flag[p, j] = (pp.FLAG_REQ * x["REQ"][q, v]
                            | pp.FLAG_NEG * x["NEG"][q, v])
    delw = np.packbits(x["deleted"].reshape(NB, -1, 32), axis=-1,
                       bitorder="little").view(np.uint32).reshape(NB, -1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    arrays = (t(x["pl_docid"].view(np.int16)), t(x["pl_tf"].view(np.int16)),
              t(x["dense_tf"].view(np.int16)), t(x["comp"]),
              t(delw.view(np.int32)))
    pairs = (t(pb.astype(np.int32)), t(pq.astype(np.int32)),
             t(x["REQ"].sum(axis=1).astype(np.int32)[pq]), t(s_off),
             t(s_len), t(s_dense), t(s_w), t(s_flag))
    return arrays, pairs, t(x["boosts"])


def _merge(vals, docs, pairs, B, k):
    """Per-query pages from per-pair top-k lists, in ascending block order
    (what StackedIndex.run does with merge_rows)."""
    pb, pq = pairs[0].long(), pairs[1].long()
    gids = torch.where(docs >= 0, pb[:, None] * BLOCK_SIZE + docs, 0)
    ts, gid = lx.merge_rows(vals, gids, pq, pb, B, NB, k)
    return ts.numpy(), gid.numpy()


CASES = [
    ("title10_body1", 0, (10.0, 1.0), 1),
    ("title_only", 1, (10.0, 0.0), 1),
    ("body_only", 2, (0.0, 1.0), 0),
    ("odd_boosts", 5, (3.3, 1.7), 1),
    ("three_fields", 6, (1.3, 2.7, 0.9), 2),
    ("three_fields_sparse", 7, (1.3, 0.0, 0.9), 0),
]


@pytest.mark.parametrize("name, seed, boosts, n_dense", CASES,
                         ids=[c[0] for c in CASES])
def test_tf_scan_matches_lexical_scan(name, seed, boosts, n_dense):
    """Scores, ids, counts and facet counts of tf_scan_pairs against the
    reference's lexical_scan: equal bit for bit."""
    x = _synth(seed, boosts, n_dense)
    B, k = x["W"].shape[0], 64
    ts, ti, cnt, fc = _reference_scan(x, k, facets=True, sort_desc=None)
    arrays, pairs, bst = _port_inputs(x)
    vals, docs, mcnt, mfc = lx.tf_scan_pairs(
        arrays, pairs, bst, k, B, fcod=torch.from_numpy(x["fcod"]), fcm=FCM)
    mts, mgid = _merge(vals, docs, pairs, B, k)
    assert (cnt > 0).sum() > B // 2
    np.testing.assert_array_equal(mcnt.numpy(), cnt)
    np.testing.assert_array_equal(mfc.numpy(), fc.astype(np.int32))
    fin = np.isfinite(ts)
    np.testing.assert_array_equal(np.isfinite(mts), fin)
    np.testing.assert_array_equal(mts.view(np.int32)[fin],
                                  ts.view(np.int32)[fin])
    np.testing.assert_array_equal(mgid[fin], ti[fin])


@pytest.mark.parametrize("sort_desc", [True, False], ids=["desc", "asc"])
def test_tf_scan_sort_key_matches_lexical_scan(sort_desc):
    """Under a sort key a matched doc ranks by the key (ties to the lower
    doc), as the reference's lexical_scan ranks it."""
    x = _synth(3, (10.0, 0.0), 1)
    B, k = x["W"].shape[0], 64
    ts, ti, cnt, _ = _reference_scan(x, k, facets=False, sort_desc=sort_desc)
    arrays, pairs, bst = _port_inputs(x)
    rank = torch.from_numpy(x["skey"] if sort_desc else -x["skey"])
    vals, docs, mcnt, mfc = lx.tf_scan_pairs(arrays, pairs, bst, k, B,
                                             rank=rank)
    mts, mgid = _merge(vals, docs, pairs, B, k)
    assert mfc is None
    np.testing.assert_array_equal(mcnt.numpy(), cnt)
    fin = np.isfinite(ts)
    np.testing.assert_array_equal(np.isfinite(mts), fin)
    np.testing.assert_array_equal(mts[fin], ts[fin])
    np.testing.assert_array_equal(mgid[fin], ti[fin])


def test_tf_scan_zero_boost_is_absent():
    """A term found only in fields of boost 0 scores 0 and is not present:
    it does not match, does not satisfy a required slot and does not
    exclude as a negated one (lexical.py:129, 148, 171)."""
    F = 2
    docid = np.array([5, 9, 40, 9, 40, 77], np.uint16)   # slot 0 | slot 1
    tf = np.array([[2, 0], [0, 3], [1, 1],               # slot 0
                   [0, 4], [0, 2], [5, 0]], np.uint16)   # slot 1
    comp = np.ones((BLOCK_SIZE, F), np.float32)

    def run(flags, boosts, nreq):
        t = torch.from_numpy
        out, cnt, mw = lx.tf_scan(
            t(docid.view(np.int16)), t(tf.view(np.int16)),
            torch.zeros((1, BLOCK_SIZE, F), dtype=torch.int16), t(comp),
            torch.zeros((1, BLOCK_SIZE // 32), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.tensor([nreq], dtype=torch.int32),
            torch.tensor([[0, 3]]), torch.tensor([[3, 3]], dtype=torch.int32),
            torch.full((1, 2), -1, dtype=torch.int32),
            torch.tensor([[1.0, 2.0]]), torch.tensor([flags], dtype=torch.int32),
            1, True, boosts=torch.tensor(boosts))
        docs = torch.nonzero(torch.isfinite(out[0])).flatten().tolist()
        assert int(cnt) == len(docs)
        assert torch.equal(lx.unpack_words(mw)[0], torch.isfinite(out[0]))
        return docs

    assert run([0, 0], [10.0, 1.0], 0) == [5, 9, 40, 77]
    # title only: doc 9 holds both terms in the body alone
    assert run([0, 0], [10.0, 0.0], 0) == [5, 40, 77]
    # slot 1 required: under title only it is present in doc 77 alone
    assert run([0, pp.FLAG_REQ], [10.0, 0.0], 1) == [77]
    assert run([0, pp.FLAG_REQ], [10.0, 1.0], 1) == [9, 40, 77]
    # slot 1 negated: under title only it excludes nothing but doc 77
    assert run([0, pp.FLAG_NEG], [10.0, 0.0], 0) == [5, 40]
    assert run([0, pp.FLAG_NEG], [0.0, 1.0], 0) == []


# ---------------------------------------------------------------------------
# end to end


def _schema(pkg):
    return [
        pkg.SchemaField("title", pkg.FieldType.Text, indexed=True,
                        boost=10.0),
        pkg.SchemaField("body", pkg.FieldType.Text, indexed=True),
        pkg.SchemaField("brand", pkg.FieldType.String16, facet=True),
        pkg.SchemaField("price", pkg.FieldType.U16, facet=True),
    ]


def _docs(n, seed, vocab=250):
    """Random two-field docs; the word "the" is in the body of two docs in
    three, so its postings in a full block pass lexindex.DENSE_MIN and it is
    stored as a dense term."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(vocab)])
    title = words[rng.integers(0, vocab, size=(n, 3))]
    body = words[rng.integers(0, vocab, size=(n, 12))]
    the = rng.random(n) < 0.67
    return [{"title": " ".join(a),
             "body": " ".join(b) + (" the" if t else ""),
             "brand": f"b{int(c)}", "price": int(p)}
            for a, b, t, c, p in zip(title, body, the,
                                     rng.integers(0, 5, n),
                                     rng.integers(1, 400, n))]


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def index(request, tmp_path_factory):
    """Two blocks in the largest shard, deletes, and an uncommitted tail."""
    path = tmp_path_factory.mktemp("tf") / "ix"
    n = (BLOCK_SIZE + 3_000) * request.param
    out = []
    for pkg in (st, pt):
        idx = _create(pkg, path, _schema(pkg), shard_count=request.param)
        idx.index_documents(_docs(n, 7))
        idx.commit()
        idx.delete_documents(list(range(0, 40_000, 97)))
        idx.index_documents(_docs(400, 8))
        out.append(idx)
    return _Pair(*out)


QUERIES = ["w001", "w001 w002", "+w001 w002", "w001 -w002", "the w003",
           "+the +w004", "w005 w006 w007", '"w001 w002"', "the"]


def _request(query, **kw):
    return st.SearchRequest(**{"query": query, "length": 10,
                               "result_type": st.ResultType.TopkCount, **kw})


@pytest.fixture
def scans(monkeypatch):
    """Counts the port's tf scans and impact scans."""
    calls = {"tf": 0, "imp": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(lx, "tf_scan_pairs",
                        counted("tf", lx.tf_scan_pairs))
    monkeypatch.setattr(lx, "scan_pairs", counted("imp", lx.scan_pairs))
    return calls


def test_dense_term_is_stored(index):
    """The fixture reaches the dense-term rows of the tf path."""
    assert any(sh.lexical.dense_tf is not None and len(sh.lexical.dense_tf)
               for sh in index.port.shards)


@pytest.mark.parametrize("realtime", [False, True], ids=["committed", "tail"])
@pytest.mark.parametrize("fields", [["title"], ["body"]],
                         ids=["title", "body"])
def test_field_filter_matches_reference(index, fields, realtime, scans):
    matching = 0
    for q in QUERIES:
        ref, mine = _both(index, _request(q, field_filter=fields,
                                          realtime=realtime))
        matching += mine.result_count_total > 0
    assert scans["tf"] > 0 and scans["imp"] == 0
    # "the" is in no title; every other query matches in either field
    assert matching >= len(QUERIES) - 3


def test_field_filter_selects_the_field(tmp_path):
    """tests/test_lexical.py::test_field_filter through both packages: a
    doc whose only hit lies in a field left out does not match."""
    both = []
    for pkg in (st, pt):
        idx = _create(pkg, tmp_path, _schema(pkg)[:2])
        idx.index_documents([{"title": "alpha beta", "body": "gamma"},
                             {"title": "gamma", "body": "alpha"}])
        idx.commit()
        both.append(idx)
    idx = _Pair(*both)
    for fields, want in ((["title"], [0]), (["body"], [1]),
                         (["title", "body"], [0, 1])):
        ref, mine = _both(idx, st.SearchRequest(query="alpha",
                                                field_filter=fields))
        assert [r.doc_id for r in mine.results] == want


def test_field_filter_with_facets_filter_and_sort(index, scans):
    """Facet counts (K3's plain version from the tf scan's matched words),
    a facet filter and a sort key under field_filter."""
    facets = [st.QueryFacet(field="brand"),
              st.QueryFacet(field="price", ranges=st.Ranges(
                  field="price", ranges=[("low", 0), ("high", 200)]))]
    for q in ("w001 w002", "the w003"):
        ref, mine = _both(index, _request(
            q, field_filter=["title"], query_facets=facets))
        assert sum(c for _, c in mine.facets["brand"]) == \
            mine.result_count_total
        _both(index, _request(
            q, field_filter=["body"], query_facets=facets,
            facet_filter=[st.FacetFilter(field="brand",
                                         values=["b1", "b3"])]))
        for order in ("Ascending", "Descending"):
            _both(index, _request(
                q, field_filter=["body"], result_type=st.ResultType.Topk,
                result_sort=[st.ResultSort(field="price", order=order)]))
    assert scans["tf"] > 0 and scans["imp"] == 0


def test_field_filter_count_and_deep_page(index, scans):
    ref, mine = _both(index, _request("w001 w002", field_filter=["body"],
                                      result_type=st.ResultType.Count))
    assert mine.result_count_total > 0
    # past 1024: kk > 128, the sort-based top-k of a tile
    ref, mine = _both(index, _request("the w003", field_filter=["body"],
                                      offset=1100, length=20))
    assert len(mine.results) == 20
    assert scans["tf"] > 0 and scans["imp"] == 0


def test_field_filter_of_every_field_is_none(index, scans):
    """Naming every indexed field leaves the boost profile as it is: the
    batch takes the impact routes and gives the unfiltered pages, which are
    the reference's under the search parity tests' page equality."""
    for q in ("w001 w002", "the w003"):
        req = _request(q, field_filter=["title", "body"])
        mine, plain = pt.search_batch(
            index.port, [_to_port(req), _to_port(_request(q))], device="cpu")
        assert [(r.doc_id, r.score) for r in mine.results] == \
            [(r.doc_id, r.score) for r in plain.results]
        assert mine.result_count_total == plain.result_count_total > 0
        assert _Page(mine) == _Page(st.search_batch(index.ref, [req])[0])
    assert scans["tf"] == 0 and scans["imp"] > 0


def test_tf_plan_matches_reference_plan(index):
    """plan_shard(mode="tf") selects the reference's blocks and names the
    reference's posting ranges and dense rows."""
    ref_search = importlib.import_module("seekstorm_tpu.search")
    queries = ["w001 w002", "the w003", "+the +w004"]
    qt = [st.QueryType.Union] * len(queries)
    rslots, rspecs = ref_search._build_specs(index.ref, queries, qt)
    pslots, pspecs = port_search._build_specs(
        index.port, queries, [pt.QueryType.Union] * len(queries))
    for rsh, psh in zip(index.ref.shards, index.port.shards):
        want = ref_search._plan_shard(index.ref, rsh, rslots, rspecs, True,
                                      True, 16, mode="tf")
        got = pp.plan_shard(index.port, psh, pslots, pspecs, True, True, 16,
                            mode="tf")
        assert got.mode == "tf" and got.full == want.full
        np.testing.assert_array_equal(got.block_ids, want.block_ids)
        np.testing.assert_array_equal(got.W, want.W)
        dense = {}
        if want.dense_ids is not None:
            for b, (ids, sl) in enumerate(zip(want.dense_ids,
                                              want.dense_slots)):
                dense.update({(b, int(v)): int(r)
                              for r, v in zip(ids, sl) if r >= 0})
        assert dense, "the fixture has a dense term"
        pos = np.searchsorted(got.block_ids, got.p_block)
        for p, (b, q) in enumerate(zip(pos, got.p_query)):
            for j, v in enumerate(pspecs[q].slots):
                assert got.s_len[p, j] == want.seg_len[b, v]
                if got.s_len[p, j]:
                    assert got.s_off[p, j] == want.seg_off[b, v]
                assert got.s_bm[p, j] == dense.get((int(b), v), -1)
