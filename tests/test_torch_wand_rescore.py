"""WAND phases 3-4 of the torch port (seekstorm_tpu_torch/ops/wand_rescore:
rescore_page and exact_fold, kernel K5 on CUDA) against the JAX reference.

On the CPU the wrappers run their plain versions, which are held against
the reference's _rescore_regions + _page_topk and wand_exact_scan on the
reference's pools carried across (tests/test_torch_wand.py's two-block
index with deletes), in the cases tests/test_torch_wand.py leaves out:
the rung-2 width (K=256), unselected buckets, pages of fewer than 64
matches (the lanes of their -inf entries too), negated terms, deletes and
a facet filter, and a mesh part's bucket offset with masked UBs.  Scores
agree within RTOL (XLA on the CPU contracts the reference's chain into
fmas; the port rounds twice a term), lanes, found and n_ge exactly; the
exact scan agrees in ids, order and counts with scores within one ulp.

K5's selections are restated in numpy (page_select_ref, exact_fold_ref on
top of wand_rungs.radix_topk_ref); those restatements are held bit for bit
against _page_topk and the plain exact scan on synthetic pools whose small
integer impacts tie everywhere.  The kernel meets its plain version on the
card (chip_smoke.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekstorm_tpu_torch.ops import wand as pw
from seekstorm_tpu_torch.ops import wand_rescore as wr
from test_torch_wand import (_assert_scores_close, _jpools, _jq, _tq,  # noqa
                             batch, index)

wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")

NW = wr.NW
P = wr.P_PAGE


@pytest.fixture(scope="module")
def carried(batch):
    """The reference's pools and both packages' batch tables, and the
    rungs of the port's phases 1-2 on them."""
    jp = _jpools(batch["jstate"])
    tp = pw.pools_from_numpy(*[np.asarray(x) for x in jp], device="cpu")
    tq, jq = _tq(batch), _jq(batch)
    (_, rungs), _ = pw.wand_scan(*tp, *tq, with_counts=True,
                                 with_rescore=False)
    return dict(jp=jp, tp=tp, tq=tq, jq=jq, rungs=rungs)


def _mine(c, ids, vals, filtw=None, bucket_off=0):
    tp = c["tp"]
    return wr.rescore_page(tp[0], *tp[2:], *c["tq"], ids, vals, filtw,
                           bucket_off)


def _ref(c, ids, vals, filtw=None, bucket_off=0):
    jp = c["jp"]
    Bq, T = c["tq"][1].shape
    jf = jnp.zeros((1, 1), jnp.uint32) if filtw is None else \
        jnp.asarray(filtw.numpy().view(np.uint32))
    sc, lane, found = wand_mod._rescore_regions(
        jp[0][0], jp[2][0], jp[3][0], jp[4], jp[5], jp[6], jp[7], jf,
        *c["jq"], jnp.asarray(ids.numpy()), jnp.asarray(vals.numpy()),
        Bq=Bq, T=T, bucket_off=jnp.int32(bucket_off),
        with_filter=filtw is not None)
    return wand_mod._page_topk(sc, lane) + (found, sc, lane)


def _assert_page_matches(mine, ref):
    """Scores within RTOL, lanes, n_ge and found exact; and the
    reference's own scores paged by the port's rule bit for bit."""
    psc, plane, n_ge, found = [x.numpy() for x in mine]
    rpsc, rplane, rn_ge, rfound = [np.asarray(x) for x in ref[:4]]
    _assert_scores_close(psc, rpsc)
    np.testing.assert_array_equal(plane, rplane)
    np.testing.assert_array_equal(found, rfound)
    np.testing.assert_array_equal(n_ge, rn_ge)
    same = wr._page_topk(torch.from_numpy(np.array(ref[4])),
                         torch.from_numpy(np.array(ref[5])))
    for x, y in zip(same, (rpsc, rplane, rn_ge)):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.view(np.int32))


def _rung2(c):
    vals, ids = c["rungs"][1]
    Bq = ids.shape[0]
    idsb = (ids[:, :pw.K_SEL, None] * 4 + torch.arange(4, dtype=torch.int32)
            ).reshape(Bq, pw.K_SEL * 4)
    valsb = torch.repeat_interleave(vals[:, :pw.K_SEL], 4, dim=1)
    return idsb, valsb


def _cases(c):
    """(ids, vals, filtw, bucket_off) of each case, by name."""
    vals1, ids1 = [x[:, :pw.K_SEL] for x in c["rungs"][0]]
    Bq = ids1.shape[0]
    rng = np.random.default_rng(5)
    NBLK = c["tp"][4].shape[1]
    idsb, valsb = _rung2(c)
    unsel = vals1.clone()
    unsel[torch.from_numpy(rng.random(unsel.shape) < 0.4)] = float("-inf")
    unsel[0] = float("-inf")                   # a query with nothing left
    few = torch.full_like(vals1, float("-inf"))
    few[:, :2] = vals1[:, :2]                  # 64 docs at most
    filtw = torch.from_numpy(
        (rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
         ).view(np.int32))
    # a mesh part: the part's own buckets local (second block here), the
    # others masked to -1 / -inf, lanes offset by the part's first bucket
    off = NW
    mine = (ids1 >= off) & (vals1 > float("-inf"))
    part_ids = torch.where(mine, ids1 - off, -1)
    part_vals = torch.where(mine, vals1, float("-inf"))
    return {
        "rung1": (ids1, vals1, None, 0),
        "rung2": (idsb, valsb, None, 0),
        "unselected": (ids1, unsel, None, 0),
        "few_matches": (ids1, few, None, 0),
        "filter": (ids1, vals1, filtw, 0),
        "filter_rung2": (idsb, valsb, filtw, 0),
        "mesh_part": (part_ids, part_vals, None, off),
    }, Bq


CASE_NAMES = ["rung1", "rung2", "unselected", "few_matches", "filter",
              "filter_rung2", "mesh_part"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_rescore_page_matches_reference(carried, case):
    cases, _ = _cases(carried)
    ids, vals, filtw, off = cases[case]
    if case == "mesh_part":
        # the part's pools are the second block's columns of the slot tables
        tp = carried["tp"]
        part = dict(carried, tp=tuple(tp[:4]) + tuple(
            x.contiguous() for x in (tp[4][:, 1:], tp[5][:, 1:], tp[6][1:],
                                     tp[7][1:])))
        jp = carried["jp"]
        part["jp"] = (jp[0], jp[1], jp[2], jp[3], jp[4][:, 1:2],
                      jp[5][:, 1:2], jp[6][1:2], jp[7][1:2])
        mine = _mine(part, ids, vals, filtw, off)
        ref = _ref(part, ids, vals, filtw, off)
    else:
        mine = _mine(carried, ids, vals, filtw, off)
        ref = _ref(carried, ids, vals, filtw, off)
    _assert_page_matches(mine, ref)
    psc, _, n_ge, found = [x.numpy() for x in mine]
    assert found.sum() > 0
    if case == "few_matches":
        assert (found < P).all() and np.isneginf(psc).any()
    if case == "unselected":
        assert found[0] == 0 and np.isneginf(psc[0]).all()
    if case == "rung2":
        assert ids.shape[1] == 256
    # negated columns and deletes are in the batch and the pools
    assert carried["tq"][3].any() and int((carried["tp"][6] != 0).sum()) > 0


def test_rescore_page_ties_at_the_page_end(carried):
    """Pages whose last entry ties candidates past it: n_ge counts them
    (more than the page's own entries at that score)."""
    ids, vals = _rung2(carried)
    psc, _, n_ge, found = [x.numpy() for x in _mine(carried, ids, vals)]
    ref = _ref(carried, ids, vals)
    np.testing.assert_array_equal(n_ge, np.asarray(ref[2]))
    last = psc[:, -1]
    on_page = (psc >= last[:, None]) & np.isfinite(psc)
    tied = np.isfinite(last) & (n_ge > on_page.sum(axis=1))
    assert tied.any()


def test_rescore_page_is_the_plain_composition(carried):
    """rescore_page on the CPU is _page_topk(*_rescore_regions(...)[:2])
    with found, bit for bit."""
    ids, vals = _rung2(carried)
    tp = carried["tp"]
    sc, lane, found = wr._rescore_regions(tp[0], *tp[2:], *carried["tq"],
                                          ids, vals)
    want = wr._page_topk(sc, lane) + (found,)
    for x, y in zip(_mine(carried, ids, vals), want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("with_filter", [False, True])
def test_exact_scan_matches_reference(carried, with_filter):
    """wand_exact_scan (exact_fold, the plain loop on the CPU) against the
    reference's wand_exact_scan in groups of 4 queries: ids, order and
    counts equal, scores within one ulp."""
    tp, tq, jp = carried["tp"], carried["tq"], carried["jp"]
    NBLK = tp[4].shape[1]
    rng = np.random.default_rng(9)
    filtw = torch.from_numpy(
        (rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
         ).view(np.int32)) if with_filter else None
    Bq_all = tq[1].shape[0]
    n_fin = 0
    for g0 in range(0, Bq_all - 3, 12):
        rows = list(range(g0, g0 + 4))
        q = [tq[0], tq[1][rows], tq[2][rows], tq[3][rows], tq[4][:, rows]]
        psc, plane, found = pw.wand_exact_scan(*tp, *q, filtw=filtw)
        T = q[1].shape[1]
        S = q[4].shape[0]
        qargs = jnp.asarray(wand_mod._pack_qargs(*[x.numpy() for x in q]))
        jf = jnp.zeros((1, 1), jnp.uint32) if filtw is None else \
            jnp.asarray(np.pad(filtw.numpy().view(np.uint32),
                               ((0, jp[4].shape[1] - NBLK), (0, 0))))
        out = np.asarray(wand_mod.wand_exact_scan(
            *jp, qargs, jf, V=q[0].shape[0], Bq=4, T=T, S=S,
            with_filter=filtw is not None))
        rsc = out[:, :P].view(np.float32)
        rlane = out[:, P:2 * P]
        rfound = out[:, 2 * P]
        np.testing.assert_array_equal(found.numpy(), rfound)
        np.testing.assert_array_equal(plane.numpy(), rlane)
        a = psc.numpy()
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(rsc))
        fin = np.isfinite(a)
        ulps = np.abs(a[fin].view(np.int32).astype(np.int64)
                      - rsc[fin].view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= 1
        n_fin += int(fin.sum())
    assert n_fin > 0


# -- K5's selections restated in numpy, on synthetic pools with ties --------


def _synth_pools(rng, *, NBLK=2, V=6, Bq=9, T=4, S=2):
    """Pools in the WandState layout with small integer impacts (ties
    everywhere): one pool row per (slot, block) segment, ranks the
    exclusive popcount prefix of the row's words, impacts laid out per
    segment at sp_ioff.  Tensors for the port's functions."""
    R = V * NBLK
    ppool = rng.integers(0, 1 << 32, size=(R, NW), dtype=np.uint32)
    for _ in range(3):
        ppool &= rng.integers(0, 1 << 32, size=(R, NW), dtype=np.uint32)
    pc = np.array([bin(x).count("1") for x in range(256)], np.int64)
    per_word = pc[ppool.view(np.uint8)].reshape(R, NW, 4).sum(axis=2)
    rpool = (np.cumsum(per_word, axis=1) - per_word).astype(np.int32)
    sizes = per_word.sum(axis=1)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ipool = rng.integers(1, 4, size=int(sizes.sum())).astype(np.float32)
    sp_prow = np.full((V, NBLK), -1, np.int32)
    sp_ioff = np.full((V, NBLK), -1, np.int32)
    for v in range(V):
        for b in range(NBLK):
            if rng.random() < 0.85:
                sp_prow[v, b] = v * NBLK + b
                sp_ioff[v, b] = starts[v * NBLK + b]
    delw = (rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32))
    sid = ((np.arange(NBLK) * S) // NBLK).astype(np.int32)
    tslot = np.full((Bq, T), -1, np.int32)
    treq = np.zeros((Bq, T), bool)
    tneg = np.zeros((Bq, T), bool)
    wsh = np.zeros((S, Bq, T), np.float32)
    for q in range(Bq - 1):                     # the last row: padding
        n = int(rng.integers(1, T + 1))
        sl = rng.choice(V, size=n, replace=False)
        for j, s in enumerate(sl):
            tslot[q, j] = s
            tneg[q, j] = j > 0 and rng.random() < 0.2
            treq[q, j] = not tneg[q, j] and rng.random() < 0.3
            wsh[:, q, j] = rng.choice([0.5, 1.0, 2.0], size=S)

    def t(x):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x))

    return ([t(ppool), t(rpool), t(ipool), t(sp_prow), t(sp_ioff), t(delw),
             t(sid)],
            [t(np.arange(V, dtype=np.int32)), t(tslot), t(treq), t(tneg),
             t(wsh)])


def test_page_select_ref_equals_page_topk():
    """K5's page rule (radix select by (score desc, candidate asc)) on
    adversarial ties: equal scores across buckets, all -inf rows, fewer
    than 64 matched, +0 and -0, widths 64, 2,048 and 8,192."""
    rng = np.random.default_rng(11)
    for n in (64, 2048, 8192):
        sc = rng.integers(0, 4, size=(8, n)).astype(np.float32)
        sc[rng.random(sc.shape) < 0.8] = -np.inf
        sc[1] = -np.inf
        sc[2] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
        sc[3, :] = -np.inf
        sc[3, ::97] = 1.0                       # fewer than 64 matched
        sc[4] = 2.0                             # one tie class
        lane = np.sort(rng.integers(0, 1 << 24, size=(8, n)),
                       axis=1).astype(np.int32)
        want = wr._page_topk(torch.from_numpy(sc), torch.from_numpy(lane))
        got = wr.page_select_ref(sc, lane)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x.numpy().view(np.int32),
                                          y.view(np.int32))


@pytest.mark.parametrize("K", [64, 256])
def test_page_select_ref_on_rescored_pools(K):
    """The restated page over rescore scores of synthetic pools with ties
    equals _page_topk, and so rescore_page's contract."""
    rng = np.random.default_rng(K)
    pools, q = _synth_pools(rng)
    NBLK = pools[3].shape[1]
    Bq = q[1].shape[0]
    ids = torch.from_numpy(np.stack([
        rng.choice(NBLK * NW, size=K, replace=False)
        for _ in range(Bq)]).astype(np.int32))
    vals = torch.ones((Bq, K))
    vals[torch.from_numpy(rng.random((Bq, K)) < 0.25)] = float("-inf")
    sc, lane, found = wr._rescore_regions(*pools, *q, ids, vals)
    psc, plane, n_ge, fnd = wr.rescore_page(*pools, *q, ids, vals)
    got = wr.page_select_ref(sc.numpy(), lane.numpy())
    for x, y in zip((psc, plane, n_ge), got):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.view(np.int32))
    assert torch.equal(fnd, found) and int(found.sum()) > 0
    # score ties at the page end and pages padded with -inf both occur
    assert (n_ge.numpy() > (psc.numpy() >= psc.numpy()[:, -1:]).sum(1)).any()
    assert np.isneginf(psc.numpy()).any()


@pytest.mark.parametrize("nsplit,chunk", [(1, 256), (3, 256), (7, 100),
                                          (64, 64)])
def test_exact_fold_ref_equals_plain_scan(nsplit, chunk):
    """K5's fold mode restated (bucket ranges walked in chunks with a
    running page after the carried one, a chunk that beats nothing
    skipped, the ranges' pages merged in order) equals the plain loop over
    blocks, from the -inf page and from a carried page whose finite
    entries tie the new scores."""
    rng = np.random.default_rng(nsplit)
    pools, q = _synth_pools(rng)
    NBLK = pools[3].shape[1]
    Bq = q[1].shape[0]
    ids = torch.arange(NBLK * NW, dtype=torch.int32).expand(Bq, -1)
    sc, lane, _ = wr._rescore_regions(*pools, *q, ids,
                                      torch.ones(ids.shape))
    c_psc = np.full((Bq, P), -np.inf, np.float32)
    c_psc[:, :5] = [9.0, 6.0, 6.0, 3.0, 2.0]
    c_plane = rng.integers(0, 1 << 20, size=(Bq, P)).astype(np.int32)
    for carry in (wr.initial_carry(Bq, "cpu"),
                  (torch.from_numpy(c_psc), torch.from_numpy(c_plane))):
        want = wr.exact_fold(*pools, *q, carry=carry)
        got = wr.exact_fold_ref(sc.numpy(), lane.numpy(),
                                [x.numpy() for x in carry], nsplit, chunk)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x.numpy().view(np.int32),
                                          y.view(np.int32))
    assert np.isfinite(want[0].numpy()).all(axis=1).any()


def test_k5_wrappers_check_inputs_before_launch():
    """rescore_page_cuda and exact_fold_cuda refuse a column count, a
    width and a type they do not take before they build or launch."""
    rng = np.random.default_rng(3)
    pools, q = _synth_pools(rng, T=4)
    Bq = q[1].shape[0]
    ids = torch.zeros((Bq, 64), dtype=torch.int32)
    vals = torch.ones((Bq, 64))
    wide = [q[0], torch.cat([q[1]] * 3, 1), torch.cat([q[2]] * 3, 1),
            torch.cat([q[3]] * 3, 1), torch.cat([q[4]] * 3, 2)]
    with pytest.raises(ValueError, match="columns"):
        wr.rescore_page_cuda(*pools, *wide, ids, vals)
    with pytest.raises(ValueError, match="buckets a query"):
        wr.rescore_page_cuda(*pools, *q, ids[:, :1], vals[:, :1])
    with pytest.raises(ValueError, match="ipool"):
        wr.rescore_page_cuda(pools[0], pools[1], pools[2].double(),
                             *pools[3:], *q, ids, vals)
    with pytest.raises(ValueError, match="splits"):
        wr.exact_fold_cuda(*pools, *q, nsplit=wr.MAX_SPLITS + 1)


def test_k5_refuses_other_devices():
    rng = np.random.default_rng(3)
    pools, q = _synth_pools(rng)
    meta = [x.to("meta") for x in pools]
    with pytest.raises(ValueError):
        wr.rescore_page(*meta, *q, None, None)
    with pytest.raises(ValueError):
        wr.exact_fold(*meta, *q)
