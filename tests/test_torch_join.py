"""The posting-space join of the torch port (seekstorm_tpu_torch/ops/join.py
and its route in search.py) against the JAX reference on the CPU.

  * join_scan: the port's torch ops and the reference's jitted join_scan on
    the same numpy inputs (the reference's own plans of a small index),
    scores bit for bit and ids at every finite score: CSR-only windows and
    a bitmap slot with its stash, under Union, Intersection and +/-
    queries, and a window of 8,192 lanes (V*PW > 16384, _topk_flat's
    two-stage path) over planted ties cut by the page end;
  * search_batch with SEEKSTORM_TPU_JOIN=1 in both packages over the five
    behaviours of tests/test_join.py (parity with the doc-space route, the
    multi-bitmap fallback, two shards of unequal size, the deep-paging
    fallback, the realtime tail): a joined page equals the reference's bit
    for bit (ids, order, scores, counts); a row left to the dense path is
    held under tests/test_wand.py's _Page, as the dense route's tests hold
    it;
  * the port's join pages against its own dense route by
    tests/test_join.py's rule (tie classes cut by the page end may differ
    in membership, not in size);
  * a budget that forces groups of one query gives the pages of one group;
  * the gate: on for the CPU, off for CUDA unless SEEKSTORM_TPU_JOIN=1, and
    never for an index with deletes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu import lexindex as ref_lexindex
from seekstorm_tpu.ops import join as ref_join
from seekstorm_tpu.parallel import mesh as ref_mesh
from seekstorm_tpu.schema import BLOCK_SIZE
from seekstorm_tpu_torch import lexindex as port_lexindex
from seekstorm_tpu_torch.ops import join as pj
from seekstorm_tpu_torch.parallel import mesh as pmesh
from test_join import _assert_equivalent
from test_torch_search import _Pair, _create, _to_port
from test_wand import _Page

sm = importlib.import_module("seekstorm_tpu.search")
ps = importlib.import_module("seekstorm_tpu_torch.search")

QUERIES = {
    "union": ["w01 w02", "w03", "w04 w05 w06", "common w01", "common",
              "r001 r002", "common r003 r004", "r005 w07 w08"],
    "intersection": ["w01 w02", "w04 w05 w06", "common w01", "r001 w02",
                     "common r003", "r004 r005 w09", "w10 w11"],
    "plusminus": ["w07 -w08", "w09 +w10", "w02 -common", "+common r006",
                  "+w01 w02 -w03", "r007 -w04 w05", "r010 -common",
                  "+r011 w12"],
}
QTYPE = {"union": st.QueryType.Union,
         "intersection": st.QueryType.Intersection,
         "plusminus": st.QueryType.Union}


def _mixed_docs(n=600, seed=11):
    """tests/test_join.py's mixed corpus (one heavy term 'common', 40 mid
    terms), plus two rare terms a doc from 300, which stay CSR terms
    beside a bitmap term."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:02d}" for i in range(40)]
    rare = [f"r{i:03d}" for i in range(300)]
    docs = []
    for i in range(n):
        body = ["common", "filler"] + list(rng.choice(vocab, 15))
        if i % 7 == 0:
            body += ["common"]          # tf=2 -> CSR residual
        body += list(rng.choice(rare, 2))
        title = list(rng.choice(vocab, 3))
        docs.append({"title": " ".join(title), "body": " ".join(body)})
    return docs


def _schema(pkg):
    return [
        pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                        indexed=True, boost=10.0),
        pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                        indexed=True),
    ]


def _body_schema(pkg):
    return [pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                            indexed=True)]


def _pair(path, docs, monkeypatch, bitmap_min=8, shards=1, tail=(),
          schema=_schema):
    """One index per package from the same documents, with BITMAP_MIN set
    in both, committed, plus an uncommitted tail."""
    for mod in (ref_lexindex, port_lexindex):
        monkeypatch.setattr(mod, "BITMAP_MIN", bitmap_min)
    out = []
    for pkg in (st, pt):
        idx = _create(pkg, path, schema(pkg), shard_count=shards)
        idx.index_documents(docs)
        idx.commit()
        if tail:
            idx.index_documents(list(tail))
        out.append(idx)
    return _Pair(*out)


# ---------------------------------------------------------------------------
# join_scan on the same numpy inputs


def _scan_inputs(idx, queries, qtype):
    """The reference's join inputs for the join-eligible queries: per
    shard (arrays, plan arrays) and the statics."""
    slots, specs = sm._build_specs(idx, queries, [qtype] * len(queries))
    infos = sm._join_shard_infos(idx, slots, False)
    jspecs = [s for s in specs if sm._join_query_ok(s, infos)]
    assert jspecs, "no query fits the join"
    bufs, statics = sm._build_join_plans(idx, slots, jspecs, infos, 16)
    out = []
    for sh, buf in zip(idx.shards, bufs):
        lex = sh.lexical
        pc = len(lex.dev_docid)
        docid = np.zeros(max((pc + 127) // 128, 1) * 128, np.uint16)
        imp = np.zeros(len(docid), np.float32)
        docid[:pc] = lex.dev_docid
        imp[:pc] = lex.dev_imp
        sat1 = np.zeros(lex.n_blocks * BLOCK_SIZE, np.float32)
        sat1[:len(lex.sat1)] = lex.sat1[:len(sat1)]
        bm = lex.bitmaps if lex.bitmaps is not None and len(lex.bitmaps) \
            else np.zeros((1, BLOCK_SIZE // 32), np.uint32)
        plan = [np.asarray(x) for x in ref_mesh._unpack_plan_join(
            jnp.asarray(buf), statics["B"], statics["V"], statics["NR"],
            statics["NS"], statics["NBp"])]
        out.append(((docid, imp, sat1, bm), plan))
    return out, statics, len(jspecs)


def _both_scans(inputs, statics):
    """(reference, port) outputs of join_scan on each shard's inputs."""
    kw = dict(k=statics["k"], PW=statics["PW"], has_bm=statics["has_bm"])
    for (docid, imp, sat1, bm), plan in inputs:
        ref = ref_join.join_scan(
            jnp.asarray(docid.reshape(-1, 128)),
            jnp.asarray(imp.reshape(-1, 128)), jnp.asarray(sat1),
            jnp.asarray(bm), *[jnp.asarray(x) for x in plan], **kw)
        mine = pj.join_scan(
            torch.from_numpy(docid.view(np.int16)), torch.from_numpy(imp),
            torch.from_numpy(sat1),
            torch.from_numpy(np.ascontiguousarray(bm).view(np.int32)),
            *[torch.from_numpy(np.array(x)) for x in plan], **kw)
        yield [np.asarray(x) for x in ref], [x.numpy() for x in mine]


def _assert_bitwise(ref, mine):
    """Scores bit for bit, ids equal at every finite score (an id beside a
    -inf pad is not a result: the reference's is whatever its unmatched
    lane held, the port's 0)."""
    (rs, rid), (ms, mid) = ref, mine
    assert ms.dtype == np.float32 and ms.shape == rs.shape
    np.testing.assert_array_equal(ms.view(np.int32), rs.view(np.int32))
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(mid[fin], rid.astype(np.int64)[fin])


@pytest.mark.parametrize("queries", ["union", "intersection", "plusminus"])
@pytest.mark.parametrize("layout", ["csr", "bitmap"])
def test_join_scan_matches_reference(tmp_path, monkeypatch, layout, queries):
    """CSR-only windows (no bitmaps), or 'common' as a bitmap slot with
    its stash and CSR residual beside CSR slots."""
    pair = _pair(tmp_path, _mixed_docs(), monkeypatch,
                 bitmap_min=8 if layout == "bitmap" else 10 ** 9)
    inputs, statics, n = _scan_inputs(pair.ref, QUERIES[queries],
                                      QTYPE[queries])
    assert statics["has_bm"] == (layout == "bitmap")
    assert n >= 2
    for ref, mine in _both_scans(inputs, statics):
        assert np.isfinite(ref[0]).any()
        _assert_bitwise(ref, mine)


def test_join_scan_two_stage_ties(tmp_path, monkeypatch):
    """6,000 docs of three words each: 'tie' in all, so its window holds
    8,192 lanes and V*PW = 32,768 takes _topk_flat's two stages; every
    score class is a tie of hundreds of docs that the page end cuts."""
    docs = [{"body": f"tie a{i % 40:02d} b{i % 70:02d}"} for i in range(6000)]
    pair = _pair(tmp_path, docs, monkeypatch, bitmap_min=10 ** 9,
                 schema=_body_schema)
    for queries, qtype in ((["tie", "tie a01", "tie b02 a03"],
                            st.QueryType.Union),
                           (["tie a04", "+tie -a05"],
                            st.QueryType.Intersection)):
        inputs, statics, n = _scan_inputs(pair.ref, queries, qtype)
        assert n == len(queries)
        assert statics["V"] * statics["PW"] > 16384
        for ref, mine in _both_scans(inputs, statics):
            assert (ref[0][:, 0] == ref[0][:, -1]).any(), "no cut tie class"
            _assert_bitwise(ref, mine)


def test_topk_flat_ties_follow_reference():
    """_topk_flat on planted ties, one stage and two: values and indices
    equal to the reference's."""
    rng = np.random.default_rng(3)
    for N in (4096, 32768, 65536):
        x = rng.integers(0, 6, size=(5, N)).astype(np.float32)
        x[x == 0] = -np.inf
        for k in (16, 64):
            rv, ri = ref_join._topk_flat(jnp.asarray(x), k)
            mv, mi = pj._topk_flat(torch.from_numpy(x), k)
            np.testing.assert_array_equal(mv.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(mi.numpy(), np.asarray(ri))


def test_lower_bound_matches_reference():
    """_lower_bound's pos and found on every lane, inside sorted ranges of
    unsorted rows (the rest of a window is not sorted)."""
    rng = np.random.default_rng(5)
    B, V, PW = 3, 4, 256
    tw = rng.integers(0, 5000, size=(B, PW)).astype(np.int32)
    lo = rng.integers(0, 100, size=B).astype(np.int32)
    hi = (lo + rng.integers(0, 150, size=B)).astype(np.int32)
    for b in range(B):
        tw[b, lo[b]:hi[b]] = np.sort(tw[b, lo[b]:hi[b]])
    cand = rng.integers(0, 5000, size=(B, V, PW)).astype(np.int32)
    cand[:, 0, :50] = tw[:, 60:110]       # planted hits
    rp, rf = ref_join._lower_bound(jnp.asarray(tw.reshape(-1)),
                                   jnp.asarray(lo), jnp.asarray(hi),
                                   jnp.asarray(cand), PW)
    base = (torch.arange(B) * PW).view(B, 1, 1)
    mp, mf = pj._lower_bound(torch.from_numpy(tw.reshape(-1)), base,
                             torch.from_numpy(lo).view(B, 1, 1),
                             torch.from_numpy(hi).view(B, 1, 1),
                             torch.from_numpy(cand), PW)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(mf.numpy(), np.asarray(rf))
    assert np.asarray(rf).any()
    # fewer steps that still cover the longest range: the same lower bound
    steps = pj._steps(torch.from_numpy(hi - lo))
    assert steps < PW.bit_length()
    mp, mf = pj._lower_bound(torch.from_numpy(tw.reshape(-1)), base,
                             torch.from_numpy(lo).view(B, 1, 1),
                             torch.from_numpy(hi).view(B, 1, 1),
                             torch.from_numpy(cand), PW, steps)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(mf.numpy(), np.asarray(rf))


# ---------------------------------------------------------------------------
# search_batch through both packages


def _reqs(queries, qtype=st.QueryType.Union, length=10, offset=0,
          realtime=False):
    return [st.SearchRequest(query=q, length=length, offset=offset,
                             result_type=st.ResultType.Topk,
                             realtime=realtime, query_type_default=qtype)
            for q in queries]


def _bits(rs):
    return (rs.result_count_total,
            [(r.doc_id, np.float32(r.score).view(np.int32).item())
             for r in rs.results])


def _search(pair, reqs, monkeypatch, **env):
    """(reference, port) result sets under env in both packages, and the
    port's join dispatches."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        ref = st.search_batch(pair.ref, reqs)
        before = pt.METRICS.snapshot().get("join_dispatch_total", 0.0)
        mine = pt.search_batch(pair.port, _to_port(reqs), device="cpu")
        n = pt.METRICS.snapshot().get("join_dispatch_total", 0.0) - before
    finally:
        for k in env:
            monkeypatch.delenv(k)
    return ref, mine, n


def _joined(pair, reqs):
    """Which requests the port's join takes (every shard's windows fit)."""
    slots, specs = ps._build_specs(pair.port, [r.query for r in reqs],
                                   [_to_port(r.query_type_default)
                                    for r in reqs])
    infos = ps._join_shard_infos(pair.port, slots, reqs[0].realtime)
    return [infos is not None and ps._join_query_ok(s, infos)
            for s in specs]


def _hold(pair, reqs, ref, mine):
    """Joined pages bit for bit; pages left to the dense path under
    _Page."""
    joined = _joined(pair, reqs)
    for j, a, b in zip(joined, ref, mine):
        if j:
            assert _bits(b) == _bits(a)
        else:
            assert _Page(b) == _Page(a)
    return joined


def _pages(rs_list):
    return [[(r.doc_id, round(float(r.score), 4)) for r in rs.results]
            for rs in rs_list]


@pytest.fixture
def mixed(tmp_path, monkeypatch):
    return _pair(tmp_path, _mixed_docs(), monkeypatch)


@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_join_matches_reference(mixed, monkeypatch, qtype):
    """tests/test_join.py's parity case: the port joins, its pages equal
    the reference's join pages, and agree with its own dense route."""
    reqs = _reqs(QUERIES["union"], qtype)
    ref, mine, n = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 1
    assert sum(_hold(mixed, reqs, ref, mine)) >= 4
    dense = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="0")[1]
    _assert_equivalent(_pages(mine), _pages(dense))


def test_join_is_the_cpu_default(mixed, monkeypatch):
    """No switch: a Topk batch on the CPU joins in both packages."""
    monkeypatch.delenv("SEEKSTORM_TPU_JOIN", raising=False)
    reqs = _reqs(QUERIES["plusminus"])
    ref, mine, n = _search(mixed, reqs, monkeypatch)
    assert n == 1
    assert any(_hold(mixed, reqs, ref, mine))


def test_join_multi_bitmap_fallback(mixed, monkeypatch):
    """Queries of two bitmap terms leave the join for the dense path and
    split correctly from an otherwise eligible batch."""
    reqs = _reqs(["common filler", "w01 common", "r001 r002", "w02 w03"])
    ref, mine, n = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    joined = _hold(mixed, reqs, ref, mine)
    assert n == 1 and joined[2] and not joined[0]


@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_join_two_unequal_shards(tmp_path, monkeypatch, qtype):
    """Two shards of unequal size: each shard's windows index its own
    stretch of the port's end-to-end arrays (the reference's own arrays a
    shard), past a first shard whose CSR does not end on a 128-lane row."""
    rng = np.random.default_rng(3)
    vocab = [f"v{i:02d}" for i in range(30)]
    rare = [f"r{i:03d}" for i in range(200)]
    # docs go to shards round robin: shard 0 gets 451 docs of 15 words,
    # shard 1 450 of 5
    docs = [{"body": " ".join(["hot"] + list(rng.choice(vocab, 12 if i % 2
                                                         == 0 else 2))
                              + list(rng.choice(rare, 2)))}
            for i in range(901)]
    pair = _pair(tmp_path, docs, monkeypatch, bitmap_min=300, shards=2,
                 schema=_body_schema)
    assert [any(w["has_bm"] for w in info["wins"]) for info in
            ps._join_shard_infos(pair.port, ps._build_specs(
                pair.port, ["hot"], [pt.QueryType.Union])[0], False)] == \
        [True, True], "'hot' is a bitmap term in both shards"
    sizes = [(sh.committed_doc_count, len(sh.lexical.pl_docid))
             for sh in pair.port.shards]
    assert sizes[0][0] == 451 and sizes[1][0] == 450
    assert sizes[0][1] > 2 * sizes[1][1]
    assert len(pair.port.shards[0].lexical.dev_docid) % 128
    reqs = _reqs(["v01 v02", "hot v03", "v04", "v05 -v06", "r001 hot",
                  "r002 r003 v07"], qtype)
    ref, mine, n = _search(pair, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 1 and sum(_hold(pair, reqs, ref, mine)) >= 4
    dense = _search(pair, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="0")[1]
    _assert_equivalent(_pages(mine), _pages(dense))


@pytest.mark.parametrize("shards", [1, 2])
def test_join_tie_cut_matches_reference(tmp_path, monkeypatch, shards):
    """No switch, the CPU: pages that the page end cuts out of a tie class
    of thousands (docs of three words, 30 more uncommitted) hold the
    same docs in both packages, bit for bit, with the realtime tail; the
    window of 'tie' (6,000 docs a shard) takes _topk_flat's two stages."""
    monkeypatch.delenv("SEEKSTORM_TPU_JOIN", raising=False)
    docs = [{"body": f"tie a{i % 40:02d} b{i % 70:02d}"}
            for i in range(6000 * shards)]
    tail = [{"body": f"tie a{i % 40:02d} b{i % 3:02d}"} for i in range(30)]
    pair = _pair(tmp_path, docs, monkeypatch, bitmap_min=10 ** 9,
                 shards=shards, tail=tail, schema=_body_schema)
    reqs = _reqs(["tie", "tie a01", "a02 b03", "+tie -a04 b05"],
                 length=10, realtime=True)
    ref, mine, n = _search(pair, reqs, monkeypatch)
    assert n == 1 and all(_hold(pair, reqs, ref, mine))
    for rs in mine[:2]:
        assert len(rs.results) == 10 and \
            len({r.score for r in rs.results}) == 1, "no tie class cut"
    _, _, statics, _ = pt.join_plans(pair.port, _to_port(reqs),
                                     device="cpu")
    assert statics["V"] * statics["PW"] > 16384


def test_join_deep_paging_fallback(mixed, monkeypatch):
    """offset + length past STASH_K leaves the join (the dense path serves
    the page), in both packages."""
    reqs = _reqs(["common w01", "r001 w02"], offset=80)
    ref, mine, n = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 0
    assert [_Page(b) for b in mine] == [_Page(a) for a in ref]


@pytest.mark.parametrize("shards", [1, 2])
def test_join_realtime_tail(tmp_path, monkeypatch, shards):
    """The join's pages merge with the uncommitted tail."""
    docs = [{"body": f"alpha beta doc{i}"} for i in range(50)]
    tail = [{"body": "alpha beta fresh"} for _ in range(3)]
    pair = _pair(tmp_path, docs, monkeypatch, bitmap_min=1344,
                 shards=shards, tail=tail, schema=_body_schema)
    reqs = _reqs(["alpha beta", "beta doc7"], st.QueryType.Intersection,
                 length=60, realtime=True)
    ref, mine, n = _search(pair, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 1 and all(_hold(pair, reqs, ref, mine))
    assert len(mine[0].results) == 53


def test_join_groups_give_one_groups_pages(mixed, monkeypatch):
    """A byte budget that holds one query a group: several join_scan calls,
    the same pages."""
    reqs = _reqs(QUERIES["union"] + QUERIES["intersection"])
    _, whole, _ = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    calls = []

    def counted(*a, **kw):
        calls.append(a[4].shape[0])
        return orig(*a, **kw)

    orig = pj.join_scan
    monkeypatch.setattr(pj, "join_scan", counted)
    monkeypatch.setattr(pmesh, "JOIN_GROUP_BYTES", 1)
    _, grouped, n = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 1 and len(calls) > 1 and set(calls) == {1}
    assert [_bits(b) for b in grouped] == [_bits(a) for a in whole]


def test_join_gate():
    """On for the CPU, off for a CUDA device unless SEEKSTORM_TPU_JOIN=1;
    SEEKSTORM_TPU_JOIN=0 turns the CPU's off.  No card needed: the gate
    reads the device string."""
    import os

    saved = os.environ.pop("SEEKSTORM_TPU_JOIN", None)
    try:
        assert ps._join_backend_ok("cpu")
        assert not ps._join_backend_ok("cuda")
        assert not ps._join_backend_ok("cuda:0")
        os.environ["SEEKSTORM_TPU_JOIN"] = "1"
        assert ps._join_backend_ok("cuda")
        os.environ["SEEKSTORM_TPU_JOIN"] = "0"
        assert not ps._join_backend_ok("cpu")
    finally:
        os.environ.pop("SEEKSTORM_TPU_JOIN", None)
        if saved is not None:
            os.environ["SEEKSTORM_TPU_JOIN"] = saved


def test_join_off_with_deletes(mixed, monkeypatch):
    """A shard with deletes never joins: the batch takes the dense path in
    both packages and the pages agree."""
    for idx in (mixed.ref, mixed.port):
        idx.delete_documents([3, 17, 250])
    reqs = _reqs(QUERIES["union"])
    slots, _ = ps._build_specs(mixed.port, [r.query for r in reqs],
                               [pt.QueryType.Union] * len(reqs))
    assert ps._join_shard_infos(mixed.port, slots, False) is None
    ref, mine, n = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    assert n == 0
    assert [_Page(b) for b in mine] == [_Page(a) for a in ref]
    assert not {3, 17, 250} & {r.doc_id for rs in mine for r in rs.results}


def test_join_plans_run_the_routes_join(mixed, monkeypatch):
    """join_plans gives the rows the route joins and plans whose run_join
    pages are the route's pages (committed docs only, so no tail merge)."""
    reqs = _reqs(QUERIES["union"])
    rows, plans, statics, stacked = pt.join_plans(mixed.port, _to_port(reqs),
                                                  device="cpu")
    assert rows == [i for i, j in enumerate(_joined(mixed, reqs)) if j]
    ts, gid = stacked.run_join(plans, statics)
    _, mine, _ = _search(mixed, reqs, monkeypatch, SEEKSTORM_TPU_JOIN="1")
    for r, qi in enumerate(rows):
        page = [(int(g), float(s)) for s, g in zip(ts[r], gid[r])
                if np.isfinite(s)]
        page.sort(key=lambda x: (-x[1], x[0]))
        assert page[:10] == [(x.doc_id, x.score) for x in mine[qi].results]
