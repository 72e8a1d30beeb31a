"""Dense impact path of the torch port (seekstorm_tpu_torch/plan.py,
ops/dense_scan.py, ops/lexical.py, parallel/mesh.py) against the JAX
reference (search._plan_shard, parallel.mesh.StackedIndex,
ops.lexical._topk_block) on the CPU, each package on its own index built
from the same documents, deletes and commits.

  * planner: selected blocks, per-query selection, full, ub_unscored, W,
    Mreq, nreq equal to _plan_shard's, full and pruned, in the reference's
    "imp" and "qt" modes; every (pair, slot) names its directory segment;
  * executor: dense_scan_ref plus the port's top-k and merges against the
    reference StackedIndex.run on plans of the same batch: counts exact,
    pages equal under tests/test_wand.py's _Page;
  * the exact f32 fma, the block top-k's tie order and the merges' tie
    order on constructed ties;
  * K2's fused mode: its plain version against topk_block of the masked
    scores and the reference's _topk_block, on random pairs with and
    without ties and with fewer matches than kk; scan_pairs's choice
    between the fused mode (k <= KMAX, one call) and unfused tiles; the
    wrappers' input checks.
"""

import importlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as stt
from seekstorm_tpu.parallel.mesh import StackedIndex as RefStacked
from seekstorm_tpu.parallel.mesh import \
    merge_shard_results as ref_merge_shards
from seekstorm_tpu.schema import BLOCK_SIZE
from seekstorm_tpu_torch import plan as pp
from seekstorm_tpu_torch.ops import dense_scan as ds
from seekstorm_tpu_torch.ops import lexical as lx
from seekstorm_tpu_torch.parallel import mesh as pm
from test_torch_search import QUERIES, _build
from test_wand import _Page

sm = importlib.import_module("seekstorm_tpu.search")
ps = importlib.import_module("seekstorm_tpu_torch.search")
ref_lex = importlib.import_module("seekstorm_tpu.ops.lexical")

LONG = [" ".join(f"w{i:03d}" for i in range(3, 13)),
        "+w001 " + " ".join(f"w{i:03d}" for i in range(20, 29)) + " -w050"]
QS = QUERIES + LONG


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def index(request, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("tl") / "ix", request.param)


@pytest.fixture
def pruned(monkeypatch):
    """Plans prune to one block per query in both packages."""
    for mod in (sm, pp):
        monkeypatch.setattr(mod, "FULL_PLAN_BLOCKS", 1)
        monkeypatch.setattr(mod, "PRUNE_BLOCKS", 1)


def _specs(mod, idx, qtype=st.QueryType.Union):
    """The batch's slots and specs by `mod`'s own parser (the reference's
    search module or the port's)."""
    return mod._build_specs(idx, QS, [qtype] * len(QS))


@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
@pytest.mark.parametrize("need_full", [True, False], ids=["full", "prune"])
@pytest.mark.parametrize("mode", ["imp", "qt"])
def test_plan_matches_reference(index, mode, need_full, qtype, pruned):
    slots, specs = _specs(sm, index.ref, qtype)
    pslots, pspecs = _specs(ps, index.port, qtype)
    seen_pruned = False
    for rsh, sh in zip(index.ref.shards, index.port.shards):
        ref = sm._plan_shard(index.ref, rsh, slots, specs, True, need_full,
                             1, mode=mode)
        mine = pp.plan_shard(index.port, sh, pslots, pspecs, True,
                             need_full, 1, mode=mode)
        assert (ref is None) == (mine is None)
        if ref is None:
            continue
        seen_pruned |= not mine.full
        assert mine.full == ref.full
        for name in ("ub_unscored", "W", "nreq"):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(ref, name), err_msg=name)
        # the reference's matmul form of the flags: -1e4 for a negation
        np.testing.assert_array_equal(
            np.where(mine.neg, np.float32(-1e4), mine.req), ref.Mreq)
        pairs = set(zip(mine.p_block.tolist(), mine.p_query.tolist()))
        if mode == "imp":
            np.testing.assert_array_equal(mine.block_ids, ref.block_ids)
            np.testing.assert_array_equal(mine.qsel, ref.qsel)
            bi, q = np.nonzero(ref.qsel)
            want = set(zip(ref.block_ids[bi].tolist(), q.tolist()))
        else:
            # query tiles: (block, up to 32 selecting queries) each
            want = {(int(b), int(q)) for b, qs in zip(ref.block_ids,
                                                      ref.t_qid)
                    for q in qs if q >= 0}
        assert pairs == want
    if not need_full and index.shard_count == 1:
        assert seen_pruned


def test_pairs_name_each_slot_segment(index):
    """Each pair lists its query's slots in ascending slot id with the
    slot's segment in that block (CSR remainder and bitmap row)."""
    slots, specs = _specs(ps, index.port)
    n_bitmap = 0
    for sh in index.port.shards:
        p = pp.plan_shard(index.port, sh, slots, specs, True, True, 16)
        d = sh.lexical.directory
        for i, (b, q) in enumerate(zip(p.p_block, p.p_query)):
            spec = specs[q]
            use = sorted(set(spec.weights) | {s for s, n in
                                              spec.negated.items() if n})
            assert p.s_len.shape[1] >= len(use)
            for t, v in enumerate(use):
                ti = d.lookup(slots[v].hash)
                segs = [] if ti < 0 else [
                    e for e in range(int(d.seg_start[ti]),
                                     int(d.seg_start[ti + 1]))
                    if d.seg_block[e] == b]
                if segs:
                    e = segs[0]
                    assert p.s_off[i, t] == d.seg_dev_offset[e]
                    assert p.s_len[i, t] == d.seg_dev_len[e]
                    assert p.s_bm[i, t] == d.seg_bitmap[e]
                    n_bitmap += int(d.seg_bitmap[e] >= 0)
                else:
                    assert p.s_len[i, t] == 0 and p.s_bm[i, t] == -1
                assert p.s_w[i, t] == p.W[q, v]
                neg = spec.negated.get(v, False)
                req = spec.required.get(v, False) and not neg
                assert p.s_flag[i, t] == (pp.FLAG_REQ * req
                                          + pp.FLAG_NEG * neg)
            assert (p.s_len[i, len(use):] == 0).all()
            assert (p.s_bm[i, len(use):] == -1).all()
    assert n_bitmap > 0


def _as_page(scores, gids, count):
    ok = np.isfinite(scores)
    return _Page(st.ResultSet(result_count_total=int(count), results=[
        st.ResultObject(doc_id=int(g), score=float(s))
        for s, g in zip(scores[ok], gids[ok])]))


@pytest.mark.parametrize("k", [16, 2048])
@pytest.mark.parametrize("with_counts", [True, False],
                         ids=["counts", "nocounts"])
@pytest.mark.parametrize("qtype", [st.QueryType.Union,
                                   st.QueryType.Intersection])
def test_executor_matches_reference(index, qtype, with_counts, k):
    slots, specs = _specs(sm, index.ref, qtype)
    pslots, pspecs = _specs(ps, index.port, qtype)
    ref_plans = [sm._plan_shard(index.ref, sh, slots, specs, True, True, 16)
                 for sh in index.ref.shards]
    my_plans = [pp.plan_shard(index.port, sh, pslots, pspecs, True, True,
                              16)
                for sh in index.port.shards]
    ts, gid, cnt, _ = RefStacked(index.ref).run(
        ref_plans, index.ref.boosts_or_default(), k, with_counts)
    mts, mgid, mcnt, _ = pm.get_stacked(index.port, "cpu").run(
        my_plans, k, with_counts)
    assert mts.shape == (len(QS), k) and mgid.dtype == np.int64
    if with_counts:
        np.testing.assert_array_equal(mcnt, cnt)
        assert (mcnt > 0).sum() > len(QS) // 2
    else:
        assert not mcnt.any()
    for q in range(len(QS)):
        assert _as_page(mts[q], mgid[q], mcnt[q]) == \
            _as_page(ts[q], gid[q], mcnt[q]), q


def test_dense_plans_give_the_batch_pairs(index):
    """seekstorm_tpu_torch.dense_plans: a batch's full plans, as the
    planner makes them, and the StackedIndex whose pair tables K2 scans;
    the plain scan over those tables counts what the reference counts."""
    reqs = [stt.SearchRequest(query=q, result_type=stt.ResultType.TopkCount,
                              realtime=True,
                              query_type_default=stt.QueryType.Union)
            for q in QS]
    plans, stacked = stt.dense_plans(index.port, reqs, device="cpu")
    assert stacked is pm.get_stacked(index.port, "cpu")
    slots, specs = _specs(ps, index.port)
    for p, sh in zip(plans, index.port.shards):
        want = pp.plan_shard(index.port, sh, slots, specs, True, True,
                             pp.PRUNE_BLOCKS)
        assert p.full
        np.testing.assert_array_equal(p.p_block, want.p_block)
        np.testing.assert_array_equal(p.p_query, want.p_query)
        np.testing.assert_array_equal(p.s_w, want.s_w)
    pairs = [torch.from_numpy(np.ascontiguousarray(x))
             for x in stacked.pair_tables(plans)[:8]]
    _, cnt = ds.dense_scan_ref(*stacked.arrays, *pairs, len(QS))
    rslots, rspecs = _specs(sm, index.ref)
    ref_plans = [sm._plan_shard(index.ref, sh, rslots, rspecs, True, True,
                                16)
                 for sh in index.ref.shards]
    _, _, rcnt, _ = RefStacked(index.ref).run(
        ref_plans, index.ref.boosts_or_default(), 16, True)
    np.testing.assert_array_equal(cnt.numpy(), rcnt)
    assert (rcnt > 0).sum() > len(QS) // 2


def test_dense_scan_ref_semantics():
    """One block, two pairs: CSR, bitmap and negated slots, a required
    count and a deleted doc, checked against values worked out by hand."""
    docid = torch.tensor([1, 5, 40, 41], dtype=torch.int16)
    imp = torch.tensor([1.5, 2.0, 3.0, 7.0])
    bm = np.zeros((1, ds.NWORDS), np.uint32)
    for doc in (5, 40, 41, 70):
        bm[0, doc >> 5] |= np.uint32(1 << (doc & 31))
    bitmaps = torch.from_numpy(bm.view(np.int32))
    sat1 = torch.full((BLOCK_SIZE,), 0.5)
    sat1[41] = 0.25
    dw = np.zeros((1, ds.NWORDS), np.uint32)
    dw[0, 40 >> 5] |= np.uint32(1 << (40 & 31))            # doc 40 deleted
    delw = torch.from_numpy(dw.view(np.int32))
    # pair 0 = query 0: slot a (CSR docs 1, 5, 40; required), slot b
    # (bitmap; required), slot c (CSR doc 41; negated) -> needs a and b
    # pair 1 = query 1: slots a and b, none required
    s_off = torch.tensor([[0, 0, 3], [0, 0, 0]])
    s_len = torch.tensor([[3, 0, 1], [3, 0, 0]], dtype=torch.int32)
    s_bm = torch.tensor([[-1, 0, -1], [-1, 0, -1]], dtype=torch.int32)
    s_w = torch.tensor([[2.0, 3.0, 0.0], [2.0, 3.0, 0.0]])
    R, N = pp.FLAG_REQ, pp.FLAG_NEG
    s_flag = torch.tensor([[R, R, N], [0, 0, 0]], dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    out, cnt = ds.dense_scan_ref(
        docid, imp, bitmaps, sat1, delw, torch.tensor([0, 0], **i32),
        torch.tensor([0, 1], **i32), torch.tensor([2, 0], **i32),
        s_off, s_len, s_bm, s_w, s_flag, 2)
    got = [{d: float(out[p, d]) for d in torch.nonzero(
        torch.isfinite(out[p])).flatten().tolist()} for p in range(2)]
    # doc 5: fma(3, 0.5, 2*2) = 5.5; doc 41 negated in pair 0, 3*0.25 in
    # pair 1; doc 70 bitmap only: 1.5; doc 1 CSR only: 3
    assert got[0] == {5: 5.5}
    assert got[1] == {1: 3.0, 5: 5.5, 41: 0.75, 70: 1.5}
    assert cnt.tolist() == [1, 4]


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32) * 9
    b = rng.standard_normal(4000).astype(np.float32) * 9
    c = rng.standard_normal(4000).astype(np.float32) * 90
    got = ds.fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        for nb in (np.nextafter(r, np.float32(np.inf)),
                   np.nextafter(r, np.float32(-np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)
    # the single rounding differs from a separate mul and add somewhere
    assert (got != a * b + c).any()


@pytest.mark.parametrize("k", [1, 16, 128, 129, 2048])
def test_topk_block_keeps_lowest_doc_on_ties(k):
    rng = np.random.default_rng(k)
    rank = rng.choice(np.array([-np.inf, 1.0, 2.0, 2.5], np.float32),
                      size=(3, BLOCK_SIZE), p=[0.5, 0.3, 0.19, 0.01])
    vals, docs = ds.topk_block(torch.from_numpy(rank), k)
    ts, ti = ref_lex._topk_block(jnp.asarray(rank), k)
    for r in range(3):
        want = np.lexsort((np.arange(BLOCK_SIZE), -rank[r]))[:k]
        np.testing.assert_array_equal(docs[r].numpy(), want)
        np.testing.assert_array_equal(vals[r].numpy(), rank[r, want])
        np.testing.assert_array_equal(docs[r].numpy(), np.asarray(ti[r]))
        np.testing.assert_array_equal(vals[r].numpy(), np.asarray(ts[r]))


def test_merges_keep_reference_tie_order():
    """Across blocks the earlier block wins a tie (the running lax.top_k
    merge); across shards the earlier shard (shard-major top_k), as in
    the reference's merge_shard_results."""
    vals = torch.tensor([[3.0, 1.0], [3.0, 2.0], [5.0, 1.0]])
    gids = torch.tensor([[10, 11], [20, 21], [30, 31]])
    # pairs 0 and 1 feed row 0 (blocks in that order), pair 2 feeds row 1
    ts, gid = lx.merge_rows(vals, gids, torch.tensor([0, 0, 1]),
                            torch.tensor([0, 1, 0]), 2, 2, 3)
    assert gid[0].tolist() == [10, 20, 21] and ts[0].tolist() == [3, 3, 2]
    assert gid[1, :2].tolist() == [30, 31] and ts[1, 2] == float("-inf")

    rng = np.random.default_rng(3)
    S, B, k = 3, 4, 8
    ts_all = -np.sort(-rng.choice(np.float32([1, 2, 3]), size=(S, B, k)))
    gid_all = rng.integers(0, 1000, size=(S, B, k)).astype(np.int32)
    mts, mgid = lx.merge_shard_results(torch.from_numpy(ts_all),
                                       torch.from_numpy(gid_all), k)
    f32, i32 = ref_merge_shards(jnp.asarray(ts_all), jnp.asarray(gid_all),
                                jnp.zeros((S, B), jnp.int32),
                                jnp.zeros((S, 1, B, 1), jnp.float32), k=k)
    np.testing.assert_array_equal(mts.numpy(), np.asarray(f32)[:B, :k])
    np.testing.assert_array_equal(mgid.numpy(), np.asarray(i32)[:B, :k])


def _random_pairs(seed, ties, P=12, T=3, NBLK=2):
    """A small random index (sorted CSR segments, bitmap rows, sat1,
    deleted docs) and P pairs over it, as K2's input tensors; with ties,
    impacts, weights and sat1 come from a few values, so many docs tie.
    The last pair names one three-posting segment: fewer matches than kk."""
    rng = np.random.default_rng(seed)
    segs, docid, imp, off = [], [], [], 0
    for n in [3] + list(rng.integers(1, 3000, 15)):
        docid.append(np.sort(rng.choice(BLOCK_SIZE, n, replace=False)))
        imp.append(rng.choice(np.float32([0.5, 1.0, 1.5]), n) if ties
                   else rng.random(n).astype(np.float32) * 3 + 0.01)
        segs.append((off, n))
        off += n
    words = (rng.random((4 + NBLK, ds.NWORDS, 32))
             < np.array([0.001, 0.05, 0.3, 0.9] + [0.02] * NBLK)[:, None,
                                                                  None])
    words = (words * (np.uint64(1) << np.arange(32, dtype=np.uint64))
             ).sum(axis=2).astype(np.uint32)
    sat1 = (rng.choice(np.float32([1.0, 2.0]), NBLK * BLOCK_SIZE) if ties
            else rng.random(NBLK * BLOCK_SIZE).astype(np.float32) + 0.5)
    s_off = np.zeros((P, T), np.int64)
    s_len = np.zeros((P, T), np.int32)
    s_bm = np.full((P, T), -1, np.int32)
    s_w = np.zeros((P, T), np.float32)
    s_flag = np.zeros((P, T), np.int32)
    for p in range(P - 1):
        for t in range(int(rng.integers(1, T + 1))):
            if rng.random() < 0.8:
                s_off[p, t], s_len[p, t] = segs[rng.integers(1, len(segs))]
            if rng.random() < 0.4:
                s_bm[p, t] = rng.integers(4)
            s_w[p, t] = (rng.choice(np.float32([1.0, 2.0])) if ties
                         else rng.random() * 2 + 0.1)
            s_flag[p, t] = pp.FLAG_REQ if rng.random() < 0.2 else 0
    s_off[P - 1, 0], s_len[P - 1, 0] = segs[0]
    s_w[P - 1, 0] = 1.0
    t = torch.from_numpy
    arrays = (t(np.concatenate(docid).astype(np.uint16).view(np.int16)),
              t(np.concatenate(imp)), t(words[:4].view(np.int32)), t(sat1),
              t(words[4:].view(np.int32)))
    pairs = (t(rng.integers(0, NBLK, P).astype(np.int32)),
             t(np.arange(P, dtype=np.int32) // 2),
             t(rng.integers(0, 2, P).astype(np.int32)), t(s_off), t(s_len),
             t(s_bm), t(s_w), t(s_flag))
    return arrays, pairs, (P + 1) // 2


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
@pytest.mark.parametrize("kk", [1, 10, 16, 128])
def test_fused_topk_matches_plain_and_reference(kk, ties):
    """K2's fused plain version: topk_block of dense_scan_ref's masked
    scores with the fill (-inf, doc -1) past a pair's last match, and the
    same top-kk as the reference's _topk_block of those scores."""
    arrays, pairs, B = _random_pairs(kk, ties)
    vals, docs, cnt = ds.dense_topk_ref(*arrays, *pairs, B, kk)
    scores, want_cnt = ds.dense_scan_ref(*arrays, *pairs, B)
    want_v, want_d = ds.topk_block(scores, kk)
    fin = torch.isfinite(want_v)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(docs[fin], want_d[fin])
    assert (docs[~fin] == -1).all() and (~fin).any()       # the fill
    assert torch.equal(cnt, want_cnt)
    ts, ti = ref_lex._topk_block(jnp.asarray(scores.numpy()), kk)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ts))
    np.testing.assert_array_equal(docs[fin].numpy(), np.asarray(ti)[fin])
    if ties and kk > 1:      # a top-kk holds a run of equal scores
        assert (vals[:, 1:] == vals[:, :-1])[fin[:, 1:]].any()


@pytest.mark.parametrize("k", [16, 128, 129, 2048])
def test_scan_pairs_takes_fused_mode_up_to_kmax(k, monkeypatch):
    """scan_pairs makes one fused call for k <= KMAX and unfused tiles of
    TILE_PAIRS above it; both give the same entries."""
    arrays, pairs, B = _random_pairs(5, True)
    calls = []
    for name in ("dense_topk", "dense_scan"):
        fn = getattr(lx, name)
        monkeypatch.setattr(lx, name, lambda *a, _n=name, _f=fn: (
            calls.append(_n), _f(*a))[1])
    monkeypatch.setattr(ds, "TILE_PAIRS", 5)
    vals, docs, cnt, _ = lx.scan_pairs(arrays, pairs, k, B)
    P = pairs[0].shape[0]
    assert calls == (["dense_topk"] if k <= ds.KMAX
                     else ["dense_scan"] * -(-P // 5))
    scores, want_cnt = ds.dense_scan_ref(*arrays, *pairs, B)
    want_v, want_d = ds.topk_block(scores, k)
    fin = torch.isfinite(want_v)
    assert vals.shape == (P, k) and docs.dtype == torch.int64
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(docs[fin], want_d[fin])
    assert torch.equal(cnt, want_cnt)


def test_dense_scan_refuses_other_devices():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        ds.dense_scan(meta, meta, *[None] * 11, 1)
    with pytest.raises(ValueError):
        ds.dense_topk(meta, meta, *[None] * 11, 1, 16)


def _k2_call(wrapper, ins, **kw):
    if wrapper == "fused":
        return ds.dense_topk_cuda(**ins, n_queries=1, kk=kw.get("kk", 16),
                                  split=kw.get("split"))
    return ds.dense_scan_cuda(**ins, n_queries=1)


def test_k2_wrapper_checks_inputs_before_launch():
    """dense_scan_cuda and dense_topk_cuda refuse a wrong dtype, shape,
    device or slot count (and the fused one a kk or split it does not
    take) before they build or launch anything."""
    i32 = dict(dtype=torch.int32)
    P, T = 2, 3
    good = dict(
        docid=torch.zeros(4, dtype=torch.int16), imp=torch.zeros(4),
        bitmaps=torch.zeros((1, ds.NWORDS), **i32),
        sat1=torch.zeros(BLOCK_SIZE), delw=torch.zeros((1, ds.NWORDS), **i32),
        p_blk=torch.zeros(P, **i32), p_q=torch.zeros(P, **i32),
        p_nreq=torch.zeros(P, **i32),
        s_off=torch.zeros((P, T), dtype=torch.int64),
        s_len=torch.zeros((P, T), **i32), s_bm=torch.zeros((P, T), **i32),
        s_w=torch.zeros((P, T)), s_flag=torch.zeros((P, T), **i32))
    bad = [("docid", good["docid"].to(torch.int32)),
           ("sat1", torch.zeros(BLOCK_SIZE - 1)),
           ("s_off", good["s_off"].to(torch.int32)),
           ("s_w", torch.zeros((P, T + 1))),
           ("p_q", torch.zeros(P, device="meta", **i32))]
    wide = {k: (v.repeat(1, 43) if k.startswith("s_") else v)
            for k, v in good.items()}                        # T = 129
    for wrapper in ("unfused", "fused"):
        for name, x in bad:
            with pytest.raises(ValueError, match=name):
                _k2_call(wrapper, {**good, name: x})
        with pytest.raises(ValueError, match="CUDA"):      # all on the CPU
            _k2_call(wrapper, good)
        with pytest.raises(ValueError, match="slots"):
            _k2_call(wrapper, wide)
    for kk in (0, ds.KMAX + 1):
        with pytest.raises(ValueError, match="kk"):
            _k2_call("fused", good, kk=kk)
    with pytest.raises(ValueError, match="split"):
        _k2_call("fused", good, split=3)
