"""WAND device layer of the torch port (seekstorm_tpu_torch/ops/wand.py)
against the JAX reference (seekstorm_tpu/ops/wand.py) on a real two-shard
index with deletes, built by each package from the same documents.

  * pools: the port's WandState equals the reference's after ensure_slots
    on the same terms, bit for bit;
  * phase 2: _rung_topks on the same UBs: values bit-exact, region ids
    equal wherever the values are untied;
  * phases 3-4: _rescore_regions, _page_topk and _ladder_device (over
    rescore_page's pages) on the reference's pools carried across with
    pools_from_numpy: scores within
    rtol 3e-7 (XLA may contract mul+add; the port rounds twice), lanes,
    found counts and ladder codes exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from seekstorm_tpu.search import _build_specs
from seekstorm_tpu_torch.ops import wand as pw
from test_torch_search import _Pair, _create

wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")
ps = importlib.import_module("seekstorm_tpu_torch.search")

RTOL = 3e-7


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """bench.py's bursty zipf corpus (varied bucket maxima, so most pages
    terminate on the device ladder and some escalate), a reference and a
    port index."""
    path = tmp_path_factory.mktemp("tw")
    docs = bench.make_corpus(BLOCK_SIZE + 6_000, 3_000,
                             np.random.default_rng(7))
    both = []
    for pkg in (st, pt):
        schema = [
            pkg.SchemaField("title", pkg.FieldType.Text, indexed=True,
                            boost=10.0),
            pkg.SchemaField("body", pkg.FieldType.Text, indexed=True),
        ]
        idx = _create(pkg, path, schema, shard_count=2)
        idx.index_documents(docs)
        idx.commit()
        idx.delete_documents(list(range(0, 40_000, 97)))
        both.append(idx)
    return _Pair(*both)


QUERIES = [q for q, _ in bench.make_queries(40, np.random.default_rng(1))] + [
    "-w00030 w00031 w00032", "+w00040 w00041 w00042 w00043",
    "w00050 w00051 w00052 w00053 w00054", "w00001 w00002", "+w00003 +w00004"]


@pytest.fixture(scope="module")
def batch(index):
    """The port's batch tables for QUERIES, and the reference WandState
    built on the same terms."""
    slots, specs = ps._build_specs(index.port, QUERIES,
                                   [pt.QueryType.Union] * len(QUERIES))
    idf = np.stack([ps._shard_idf(sh, slots, False)
                    for sh in index.port.shards])
    state = pw.WandState(index.port, "cpu")
    with state.lock:
        slotmap, tslot, treq, tneg, wsh, _ = pw.plan_batch(
            state, slots, specs, idf)
    used = sorted({s for sp in specs for s in sp.slots})
    jstate = wand_mod.WandState(index.ref, None)
    jstate.ensure_slots([slots[s].hash for s in used])
    return dict(state=state, jstate=jstate, slotmap=slotmap, tslot=tslot,
                treq=treq, tneg=tneg, wsh=wsh)


def _jpools(js):
    return (js.ppool, js.vpool, js.rpool, js.ipool, js.sp_prow, js.sp_ioff,
            js.delw_dev, js.sid_dev)


def _ref_pools(js):
    """The reference's pools carried across, cut to its first nblk blocks
    (the reference pads the block axis for its 8-block scan step; the
    port does not)."""
    pp, vp, rp, ip, prow, ioff, delw, sid = [np.asarray(x)
                                             for x in _jpools(js)]
    n = js.nblk
    return pw.pools_from_numpy(pp, vp, rp, ip, prow[:, :n], ioff[:, :n],
                               delw[:n], sid[:n], device="cpu")


def _tq(b):
    return [torch.from_numpy(b[k]) for k in
            ("slotmap", "tslot", "treq", "tneg", "wsh")]


def _jq(b):
    return [jnp.asarray(b[k]) for k in
            ("slotmap", "tslot", "treq", "tneg", "wsh")]


def test_pools_match_reference(index, batch):
    state, jstate = batch["state"], batch["jstate"]
    assert state.nblk == jstate.nblk
    np.testing.assert_array_equal(state.blk_shard,
                                  jstate.blk_shard[:jstate.nblk])
    carried = _ref_pools(jstate)
    names = ("ppool", "vpool", "rpool", "ipool", "sp_prow", "sp_ioff",
             "delw", "sid")
    for name, mine, ref in zip(names, state.pools, carried):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape, name
        assert torch.equal(mine.view(torch.int32), ref.view(torch.int32)), \
            name
    assert int((state.delw_dev != 0).sum()) > 0
    for h, sr in jstate.slot_cache.items():
        mine = state.slot_cache[h]
        assert mine.row == sr.row and mine.df == sr.df
        np.testing.assert_array_equal(mine.keys, sr.keys)
        np.testing.assert_array_equal(mine.imps.view(np.int32),
                                      sr.imps.view(np.int32))


def test_pools_grow_like_reference(index):
    """Two rounds of ensure_slots: the second grows every pool."""
    slots, _ = _build_specs(index.ref, [" ".join(f"w{i:05d}" for i in range(
        40 * r, 40 * r + 40)) for r in range(3)],
        [st.QueryType.Union] * 3)
    hashes = [s.hash for s in slots]
    state = pw.WandState(index.port, "cpu")
    jstate = wand_mod.WandState(index.ref, None)
    for part in (hashes[:5], hashes):
        state.ensure_slots(part)
        jstate.ensure_slots(part)
        carried = _ref_pools(jstate)
        for mine, ref in zip(state.pools, carried):
            assert mine.shape == ref.shape
            assert torch.equal(mine.view(torch.int32), ref.view(torch.int32))
    assert state.ppool.shape[0] > 64


def _assert_untied_ids_equal(vals, ids_a, ids_b):
    v = np.asarray(vals)
    untied = np.ones(v.shape, bool)
    untied[:, 1:] &= v[:, 1:] != v[:, :-1]
    untied[:, :-1] &= v[:, :-1] != v[:, 1:]
    untied &= np.isfinite(v)
    np.testing.assert_array_equal(np.asarray(ids_a)[untied],
                                  np.asarray(ids_b)[untied])
    return int(untied.sum())


@pytest.mark.parametrize("source", ["index", "ties"])
def test_rung_topks_match_reference(index, batch, source):
    if source == "index":
        state = batch["state"]
        NBLK = state.nblk
        allub = pw.scan_ub(state.ppool, state.vpool, state.sp_prow,
                           state.delw_dev, state.sid_dev, *_tq(batch),
                           with_counts=False)[0]
    else:
        rng = np.random.default_rng(4)
        NBLK = 3
        x = rng.integers(0, 4000, size=(16, NBLK * pw.NW)).astype(np.float32)
        x[rng.random(x.shape) < 0.5] = -np.inf
        x[3] = -np.inf                          # a query with no match
        allub = torch.from_numpy(x)
    mine = pw._rung_topks(allub, NBLK)
    ref = wand_mod._rung_topks(jnp.asarray(allub.numpy()), NBLK)
    n_untied = 0
    for (mv, mi), (rv, ri) in zip(mine, ref):
        rv = np.asarray(rv)
        assert mv.dtype == torch.float32 and mi.dtype == torch.int32
        np.testing.assert_array_equal(mv.numpy().view(np.int32),
                                      rv.view(np.int32))
        n_untied += _assert_untied_ids_equal(rv, mi.numpy(), ri)
    assert n_untied > 0


@pytest.fixture(scope="module")
def phases(batch):
    """Both packages' rescore functions over the reference's pools carried
    across, and the rungs both ladders start from."""
    jp = _jpools(batch["jstate"])
    tp = pw.pools_from_numpy(*[np.asarray(x) for x in jp], device="cpu")
    tq, jq = _tq(batch), _jq(batch)
    (cnt, rungs), _ = pw.wand_scan(*tp, *tq, with_counts=True,
                                   with_rescore=False)
    Bq, T = batch["tslot"].shape

    def mine(ids, vals):
        return pw._rescore_regions(tp[0], *tp[2:], *tq, ids, vals)

    def mine_page(ids, vals):
        return pw.rescore_page(tp[0], *tp[2:], *tq, ids, vals)

    def ref(ids, vals):
        return wand_mod._rescore_regions(
            jp[0][0], jp[2][0], jp[3][0], jp[4], jp[5], jp[6], jp[7],
            jnp.zeros((1, 1), jnp.uint32), *jq, ids, vals, Bq=Bq, T=T,
            bucket_off=jnp.int32(0), with_filter=False)

    jrungs = [(jnp.asarray(v.numpy()), jnp.asarray(i.numpy()))
              for v, i in rungs]
    return dict(cnt=cnt, rungs=rungs, jrungs=jrungs, mine=mine,
                mine_page=mine_page, ref=ref)


def _assert_scores_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL)
    return int(fin.sum())


@pytest.mark.parametrize("rung", [0, 1])
def test_rescore_regions_match_reference(phases, rung):
    vals, ids = phases["rungs"][rung]
    jvals, jids = phases["jrungs"][rung]
    sc, lane, found = phases["mine"](ids[:, :pw.K_SEL], vals[:, :pw.K_SEL])
    rsc, rlane, rfound = phases["ref"](jids[:, :pw.K_SEL],
                                       jvals[:, :pw.K_SEL])
    assert _assert_scores_close(sc.numpy(), rsc) > 0
    np.testing.assert_array_equal(lane.numpy(), np.asarray(rlane))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))


def test_page_topk_matches_reference(phases):
    vals, ids = phases["rungs"][0]
    sc, lane, _ = phases["mine"](ids[:, :pw.K_SEL], vals[:, :pw.K_SEL])
    psc, plane, n_ge = pw._page_topk(sc, lane)
    rpsc, rplane, rn_ge = wand_mod._page_topk(jnp.asarray(sc.numpy()),
                                              jnp.asarray(lane.numpy()))
    np.testing.assert_array_equal(psc.numpy().view(np.int32),
                                  np.asarray(rpsc).view(np.int32))
    np.testing.assert_array_equal(plane.numpy(), np.asarray(rplane))
    np.testing.assert_array_equal(n_ge.numpy(), np.asarray(rn_ge))


@pytest.mark.parametrize("need,multi", [(1, False), (10, False),
                                        (10, True)])
def test_ladder_device_matches_reference(phases, need, multi):
    Bq = phases["cnt"].shape[0]
    out = pw._ladder_device(phases["cnt"], phases["rungs"],
                            lambda i, v: [phases["mine_page"](i, v)],
                            need=need, multi=multi, s_gt1=True).numpy()
    ref = np.asarray(wand_mod._ladder_device(
        jnp.asarray(phases["cnt"].numpy()), phases["jrungs"],
        phases["ref"], Bq=Bq, need=need, multi=multi, s_gt1=True))
    assert out.shape == ref.shape and out.dtype == ref.dtype
    P = pw.P_PAGE
    np.testing.assert_array_equal(out[:, :4], ref[:, :4])  # cnt code found
    # pages terminate at rung 1 and others escalate (rung 2 runs)
    assert (out[:, 1] == 0).any() and (out[:, 1] == 2).any()
    sc = out[:, 4: 4 + P].view(np.float32)
    rsc = ref[:, 4: 4 + P].view(np.float32)
    _assert_scores_close(sc, rsc)
    fin = np.isfinite(sc)
    np.testing.assert_array_equal(out[:, 4 + P: 4 + 2 * P][fin],
                                  ref[:, 4 + P: 4 + 2 * P][fin])
    np.testing.assert_array_equal(out[:, 4 + 2 * P:], ref[:, 4 + 2 * P:])
