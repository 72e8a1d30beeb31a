"""Bucket-WAND lexical engine on one torch device.

Port of ``seekstorm_tpu/ops/wand.py`` for a single device (D=1).  The
engine has four phases per batch:

  1. phase-1 scan (``ops/wand_scan.py``, kernel K1 on CUDA): matched words,
     exact counts by popcount, a per-bucket score upper bound (UB) and its
     maxima over 4, 16 and 128 buckets;
  2. ``rung_topks`` (``ops/wand_rungs.py``, kernel K6 on CUDA): exact
     top-(K_SEL+1) regions per query at 32-, 128- and 512-doc granularity,
     ranked on phase 1's maxima;
  3. ``rescore_page`` (``ops/wand_rescore.py``, kernel K5 on CUDA): exact
     rescore of the selected buckets through a positional CSR read of the
     flat impact pool, and each query's page of them;
  4. ``_ladder_device``: the WAND termination test and a rung-2 escalation
     (a second K5 launch) around those pages, returned as one slim i32
     buffer per query.

The glue between the kernels is a few element-wise torch ops.  A batch
may carry, as in the reference: a facet filter (packed disallowed words,
ANDed out of matching in phase 1, phase 3 and the host rescores like the
deleted words); facet codes, whose exact histogram over every matched
doc kernel K3 (``ops/facet_hist.py``) counts from phase 1's matched
words; and a rank key (sorted results): regions then rank by their
bucket's best sort key where a doc matched, the host ladder ranks
candidates by their exact keys over all three rungs with the strict
test, and the device ladder is off.  Queries the device ladder cannot
finish go through the host rung ladder (native ``st_rescore``). Queries
whose UBs saturate every rung are stragglers: on one shard under
``SEEKSTORM_TPU_WAND_DEV_EXACT`` the device exact scan
(``wand_exact_scan``, K5's fold mode over the same pools) finishes them;
otherwise at batch >= 512 (or under ``SEEKSTORM_TPU_WAND_DEFER_DENSE``)
they come back unhandled for the join or the dense path, as in the
reference, and below it the host exact evaluation (``_exact_fallback``)
finishes them.  The reference's parity modes send every query of a batch
to one of the two exact evaluations:
``SEEKSTORM_TPU_WAND_FORCE_FALLBACK`` to the host's,
``SEEKSTORM_TPU_WAND_FORCE_DEV_EXACT`` to the device's (one shard).

``wand_auto`` is the reference's routing test without its backend check:
indexes of ``WAND_MIN_BLOCKS`` blocks and up ride WAND unless the observed
fallback rate closes the adaptive gate; ``SEEKSTORM_TPU_WAND`` and
``SEEKSTORM_TPU_NO_WAND`` force either way.  The gate's and the dense
planner's statistics live in the port's own ``RouteStats``.

The host glue (slot rows, ladders, exact evaluation) restates the
reference's numpy code, because the reference module cannot be imported
without jax.  u32 words travel as int32 bit patterns (torch has no u32
shifts or comparisons on the CPU).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .. import native
from ..metrics import METRICS
from ..schema import BLOCK_SIZE
from ..utils import ceil_pow2
from .facet_hist import facet_hist, wand_pairs
from .wand_rescore import P_PAGE, exact_fold, rescore_page
from .wand_rungs import K_SEL, _sort_desc, rung_topks
from .wand_scan import scan_blocks
# phases 2-4's plain versions, where the tests find them beside the glue
from .wand_rescore import _page_topk, _rescore_regions  # noqa: F401,E402
from .wand_rungs import _rung_topks, _topk_lanes  # noqa: F401,E402

NW = BLOCK_SIZE // 32          # packed words per block == buckets per block
BUCKET = 32                    # docs per bucket (one u32 word)
T_MAX = 8                      # max term slots per query on this path
F_LADDER = (1, 4, 16)          # rung coarsening factors (32/128/512 docs)
# on-device WAND termination margin (the reference's _MARGIN): slightly
# stricter than the host ladder's 3e-7, never laxer
MARGIN = 1.000001
# pool budgets (the reference's SEEKSTORM_TPU_WAND_MB / _IMP_MB defaults):
# past them the slot cache flushes and rebuilds from the live working set
POOL_MB = 6144
IMP_MB = 3072
# blocks in the largest shard from which an index rides WAND by default
# (16 blocks = 1M docs); below it the dense path serves the whole batch
WAND_MIN_BLOCKS = 16
# batch size from which stragglers defer to the dense path
DEFER_MIN_BATCH = 512


# ---------------------------------------------------------------------------
# device phases (torch glue around kernels K1, K5 and K6)


def _ladder_device(cnt, rungs, rescore_fn, *, need: int, multi: bool,
                   s_gt1: bool):
    """Phases 3+4: rung-1 rescore, WAND termination test, rung-2
    escalation when any query did not terminate, packed into one slim i32
    buffer per query (the reference's layout):

      [0] exact match count  [1] code (0/1 = terminated at device rung,
      2 = pending -> host)   [2] matched-candidate count  [3] reserved
      [4 : 4+2*D*P] page (D*P scores as f32 bits | D*P lanes)
      [A : A+K_SEL+1] rung-3 region ids + next_ub
      [s_gt1: A+KP : A+2*KP] rung-1 bucket ids + next_ub.

    rescore_fn(ids, vals) returns one page (psc, plane, n_ge, found) per
    mesh position (one on one device, rescore_page's): each position pages
    its own candidates,
    and the reference's gather and psum hooks (wand.py:722-800) lay the
    positions' [Bq, P] pages side by side on cnt's device and add their
    found counts and tie-cut flags there."""
    dev = cnt.device
    ninf = float("-inf")
    margin = torch.tensor(MARGIN, dtype=torch.float32, device=dev)

    def gather(xs):
        return xs[0] if len(xs) == 1 else torch.cat([x.to(dev) for x in xs],
                                                    dim=1)

    def psum(xs):
        return xs[0] if len(xs) == 1 else sum(x.to(dev) for x in xs)

    def merge(pages, next_ub):
        psc = gather([p[0] for p in pages])
        plane = gather([p[1] for p in pages])
        found = psum([p[3] for p in pages])
        # one page is sorted already; several are ranked (lax.top_k)
        kth = psc[:, need - 1] if len(pages) == 1 else \
            torch.topk(psc, need, dim=1).values[:, need - 1]
        term = (next_ub == ninf) | ((found >= need)
                                    & (kth > next_ub * margin))
        if multi:
            bad = psum([(p[2] > P_PAGE).to(torch.int32) for p in pages])
            term = term & (bad == 0)
        return psc, plane, found, term

    vals1, ids1 = rungs[0]
    psc1, plane1, found1, term1 = merge(
        rescore_fn(ids1[:, :K_SEL], vals1[:, :K_SEL]), vals1[:, K_SEL])

    vals2, ids2 = rungs[1]
    F2 = F_LADDER[1]
    Bq = cnt.shape[0]
    if bool((~term1).any()):
        idsb = (ids2[:, :K_SEL, None] * F2
                + torch.arange(F2, dtype=torch.int32, device=dev)
                ).reshape(Bq, K_SEL * F2)
        valsb = torch.repeat_interleave(vals2[:, :K_SEL], F2, dim=1)
        pages2 = rescore_fn(idsb, valsb)
    else:
        skip = (torch.full((Bq, P_PAGE), ninf, device=dev),
                torch.zeros((Bq, P_PAGE), dtype=torch.int32, device=dev),
                torch.zeros(Bq, dtype=torch.int32, device=dev),
                torch.zeros(Bq, dtype=torch.int32, device=dev))
        pages2 = [skip] * (psc1.shape[1] // P_PAGE)
    psc2, plane2, found2, term2 = merge(pages2, vals2[:, K_SEL])

    code = torch.where(term1, 0, torch.where(term2, 1, 2)).to(torch.int32)
    psc = torch.where(term1[:, None], psc1, psc2)
    plane = torch.where(term1[:, None], plane1, plane2)
    found = torch.where(term1, found1, found2)

    vals3, ids3 = rungs[2]

    def bits(x):
        return x.contiguous().view(torch.int32)

    parts = [cnt[:, None].to(torch.int32), code[:, None], found[:, None],
             torch.zeros((Bq, 1), dtype=torch.int32, device=dev),
             bits(psc), plane,
             ids3[:, :K_SEL], bits(vals3[:, K_SEL:K_SEL + 1])]
    if s_gt1:
        parts += [ids1[:, :K_SEL], bits(vals1[:, K_SEL:K_SEL + 1])]
    return torch.cat(parts, dim=1)


def wand_exact_scan(ppool, vpool, rpool, ipool, sp_prow, sp_ioff, delw,
                    sid, slotmap, tslot, treq, tneg, wshard, filtw=None):
    """Full-coverage exact evaluation on the device for WAND stragglers
    (the reference's ``wand_exact_scan``, wand.py:811) over the resident
    pools: ``wand_rescore.exact_fold`` from the page of -inf scores at lane
    0, which is K5's fold mode on CUDA and on the CPU the plain loop over
    blocks (``exact_scan_ref``: every bucket of a block rescored with the
    same f32 chains as the host evaluation, folded into a running
    top-P_PAGE page, carried lanes before new ones on ties), so a page is
    (score desc, lane asc).  One shard only: there lane order is gid order.

    Returns (page scores f32[Bq, P_PAGE] -inf padded, page lanes i32[Bq,
    P_PAGE] = global bucket*32 + bit, matched count i32[Bq])."""
    return exact_fold(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                      slotmap, tslot, treq, tneg, wshard, filtw)


def batch_prow(sp_prow, slotmap):
    """The batch's slots joined to their pool rows: prow i32[NBLK, V],
    -1 where a slot has no row in a block."""
    return torch.where((slotmap >= 0)[:, None],
                       sp_prow[slotmap.clamp(min=0).long()],
                       -1).T.contiguous()


def scan_ub(ppool, vpool, sp_prow, delw, sid, slotmap, tslot, treq, tneg,
            wshard, *, with_counts: bool, filtw=None,
            with_matched: bool = False):
    """Phase 1 over the resident pools (K1 on CUDA).  Returns (allub
    f32[Bq, NBLK*NW], cnt i32[Bq], ub4, ub16, g1) as scan_blocks does, and
    with_matched the matched words as a sixth."""
    return scan_blocks(ppool, vpool, batch_prow(sp_prow, slotmap), delw,
                       filtw, tslot, treq, tneg, wshard, sid,
                       with_counts=with_counts, with_matched=with_matched)


def _scan_local(ppool, vpool, sp_prow, delw, sid, slotmap, tslot, treq,
                tneg, wshard, *, with_counts: bool, filtw=None, fcod=None,
                fcm: int = 1, skeyb=None):
    """Phases 1 and 2 over one device's pools (the reference's _scan_local):
    (cnt i32[Bq], rungs, fc i32[NF, Bq, fcm] or None), region ids local to
    the pools' blocks.  Arguments as wand_scan's."""
    NBLK = sp_prow.shape[1]
    want_matched = fcod is not None or skeyb is not None
    allub, cnt, *rest = scan_ub(ppool, vpool, sp_prow, delw, sid, slotmap,
                                tslot, treq, tneg, wshard,
                                with_counts=with_counts, filtw=filtw,
                                with_matched=want_matched)
    maxima = rest[:3]
    fc = None
    if want_matched:
        mwords = rest[3]
        Bq = mwords.shape[0]
        if fcod is not None:
            fc = facet_hist(mwords.view(Bq * NBLK, NW),
                            *wand_pairs(Bq, NBLK, mwords.device), fcod, fcm,
                            Bq)
        if skeyb is not None:
            allub = torch.where(mwords != 0, skeyb.reshape(1, NBLK * NW),
                                torch.full((), float("-inf"),
                                           device=mwords.device))
            maxima = None
    return cnt, rung_topks(allub, NBLK, maxima), fc


def wand_scan(ppool, vpool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
              slotmap, tslot, treq, tneg, wshard, *, with_counts: bool,
              with_rescore: bool, need: int = 0, multi: bool = False,
              filtw=None, fcod=None, fcm: int = 1, skeyb=None):
    """One WAND dispatch over one device's resident pools: _wand_parts
    over a single part, the tables as tensors on its device.

    filtw i32[NBLK, NW]: a facet filter's disallowed words.  fcod
    i32[NF, NBLK*BLOCK_SIZE] with code space fcm: the facet histogram fc
    i32[NF, Bq, fcm] over every matched doc, from phase 1's matched words
    (K3 on CUDA).  skeyb f32[NBLK, NW] (rank-by-key, the reference's
    wand.py:275-283): a bucket's bound is its best sort key where a doc
    matched, and the rungs rank those.

    Returns (out, fc), fc None without fcod: with_rescore=True out is the
    slim i32 buffer of _ladder_device; otherwise (cnt i32[Bq], rungs) for
    the host rung ladder."""
    def one(x):
        return None if x is None else [x]

    return _wand_parts(
        [((ppool, vpool, rpool, ipool, sp_prow, sp_ioff, delw, sid),
          (slotmap, tslot, treq, tneg, wshard))], sp_prow.shape[1],
        with_counts=with_counts, with_rescore=with_rescore, need=need,
        multi=multi, filtw=one(filtw), fcod=one(fcod), fcm=fcm,
        skeyb=one(skeyb))


def wand_scan_mesh(state, pools, qargs, **kw):
    """One WAND dispatch over the parts of a WandState (the positions of a
    mesh, or the one device's single part), the reference's
    make_wand_scan_mesh (wand.py:451-553): pools, each part's pools
    (WandState.parts[d].pools, taken under the state's lock); qargs, the
    batch tables (slotmap, tslot, treq, tneg, wshard) as numpy, sent to
    every part's device.  Keywords and returns as wand_scan's, with filtw,
    fcod and skeyb lists of each part's slice (WandState.aux) or None."""
    parts = [(pp, [torch.from_numpy(np.ascontiguousarray(a)).to(pp[0].device)
                   for a in qargs]) for pp in pools]
    return _wand_parts(parts, state.nblk_local, **kw)


def _wand_parts(parts, nl: int, *, with_counts: bool, with_rescore: bool,
                need: int = 0, multi: bool = False, filtw=None, fcod=None,
                fcm: int = 1, skeyb=None):
    """wand_scan over parts of nl blocks each, the first holding the global
    blocks [0, nl): every part scans its own blocks (K1 on its device, K3
    too with facet codes) and selects its rungs (K6), each rung's
    top-(K_SEL+1) region ids are offset by the part's first region, laid
    side by side on the lead device (the first part's) as [Bq,
    D*(K_SEL+1)] in part order and cut to the top K_SEL+1 by a stable sort
    (lax.top_k's order: exact, since the top of a union lies in the union
    of the parts' tops; one part's rungs are taken as they are); counts
    and facet histograms add up.  With the rescore, each part rescores and
    pages the buckets it owns (rescore_page, K5 on CUDA) and _ladder_device
    lays the parts' pages side by side (D*P_PAGE wide) and adds their found
    counts and tie-cut flags.

    parts: [(pools, tables)] a part, the tables (slotmap, tslot, treq,
    tneg, wshard) on its device; filtw, fcod, skeyb: a slice a part, or
    None."""
    lead = parts[0][0][0].device
    KP = K_SEL + 1
    per = []
    for d, ((pp, vp, _, _, prow, _, delw, sid), q) in enumerate(parts):
        per.append(_scan_local(
            pp, vp, prow, delw, sid, *q, with_counts=with_counts,
            filtw=None if filtw is None else filtw[d],
            fcod=None if fcod is None else fcod[d], fcm=fcm,
            skeyb=None if skeyb is None else skeyb[d]))
    # one part's rungs are in that order already (a stable sort of them is
    # the identity)
    rungs = per[0][1] if len(per) == 1 else []
    for f, F in enumerate(F_LADDER if len(per) > 1 else ()):
        v2 = torch.cat([r[1][f][0].to(lead) for r in per], dim=1)
        i2 = torch.cat([(r[1][f][1] + d * (nl * NW // F)).to(lead)
                        for d, r in enumerate(per)], dim=1)
        mv, sel = _sort_desc(v2)
        rungs.append((mv[:, :KP].contiguous(),
                      torch.gather(i2, 1, sel[:, :KP])))
    cnt = sum(r[0].to(lead) for r in per)
    fc = None if fcod is None else sum(
        r[2].to(lead, torch.int64) for r in per)
    if not with_rescore:
        return (cnt, rungs), fc

    def rescore_fn(gids, vals):
        outs = []
        for d, ((pp, _, rp, ip, prow, ioff, delw, sid), q) in \
                enumerate(parts):
            off = d * nl * NW
            loc = gids - off
            mine = (loc >= 0) & (loc < nl * NW) & (vals > float("-inf"))
            loc = torch.where(mine, loc, -1).to(pp.device)
            vm = torch.where(mine, vals, float("-inf")).to(pp.device)
            outs.append(rescore_page(
                pp, rp, ip, prow, ioff, delw, sid, *q, loc, vm,
                None if filtw is None else filtw[d], bucket_off=off))
        return outs

    return _ladder_device(cnt, rungs, rescore_fn, need=need, multi=multi,
                          s_gt1=parts[0][1][4].shape[0] > 1), fc


# ---------------------------------------------------------------------------
# per-slot host rows + device pools


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _popcount_u32(words: np.ndarray) -> np.ndarray:
    return _POPCNT8[words.view(np.uint8)].reshape(len(words), 4).sum(
        axis=1, dtype=np.uint32)


class _SlotRows:
    """Per-term cached structures covering all shards' blocks."""

    __slots__ = ("row", "keys", "imps", "df")

    def __init__(self):
        self.row = -1                 # row in the sp_* slot tables
        # host rescore join arrays: key = global_block << 16 | docid, sorted
        self.keys = np.zeros(0, np.uint32)
        self.imps = np.zeros(0, np.float32)
        self.df = 0


def pools_from_numpy(ppool, vpool, rpool, ipool, sp_prow, sp_ioff, delw,
                     sid, device):
    """The reference WandState's arrays (fetched as numpy, with or without
    the leading device axis) as the port's tensors on `device`:
    (ppool i32, vpool f32, rpool i32, ipool f32, sp_prow i32, sp_ioff i32,
    delw i32, sid i32).  u32 words become int32 bit patterns and the u16
    rank rows widen to int32."""
    def strip(x, ndim):
        x = np.asarray(x)
        return x[0] if x.ndim == ndim + 1 else x

    def put(x):
        return torch.from_numpy(np.array(x, order="C")).to(device)

    return (put(strip(ppool, 2).view(np.int32)),
            put(strip(vpool, 2).astype(np.float32)),
            put(strip(rpool, 2).astype(np.int32)),
            put(strip(ipool, 1).astype(np.float32)),
            put(np.asarray(sp_prow, np.int32)),
            put(np.asarray(sp_ioff, np.int32)),
            put(np.asarray(delw, np.uint32).view(np.int32)),
            put(np.asarray(sid, np.int32)))


class _Part:
    """One mesh position's share of a WandState: the pools, the slot-table
    columns, the deleted words and the block shards of the global blocks
    [b0, b0 + nblk) on `device` (without a mesh, one part holds them all).
    Pool rows are local to the part; the pending lists hold rows built and
    not yet uploaded."""

    def __init__(self, device, b0: int, nblk: int, delw, sid):
        self.device = device
        self.b0 = b0
        self.nblk = nblk
        self.delw_dev = self.put(delw.view(np.int32))
        self.sid_dev = self.put(sid)
        self.reset()

    def put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def reset(self):
        dev = self.device
        self.ppool = torch.zeros((64, NW), dtype=torch.int32, device=dev)
        self.vpool = torch.zeros((64, NW), dtype=torch.float32, device=dev)
        # per presence row the exclusive prefix popcount before each word
        # (bucket -> position in the segment's flat impact run)
        self.rpool = torch.zeros((64, NW), dtype=torch.int32, device=dev)
        self.ipool = torch.zeros(1024, dtype=torch.float32, device=dev)
        self.sp_prow = torch.full((16, self.nblk), -1, dtype=torch.int32,
                                  device=dev)
        self.sp_ioff = torch.full((16, self.nblk), -1, dtype=torch.int32,
                                  device=dev)
        self.n_prows = 0
        self.n_imps = 0
        self.pend_prow: list[np.ndarray] = []
        self.pend_vrow: list[np.ndarray] = []
        self.pend_rrow: list[np.ndarray] = []
        self.pend_imp: list[np.ndarray] = []

    @property
    def pools(self):
        return (self.ppool, self.vpool, self.rpool, self.ipool,
                self.sp_prow, self.sp_ioff, self.delw_dev, self.sid_dev)

    def upload(self, slot_rows, n_slots: int):
        """Write the pending pool rows and impacts, and the part's columns
        of the slots `slot_rows` (prow, ioff: [n, nblk_pad] numpy, the last
        n of n_slots rows)."""
        k = len(self.pend_prow)
        if k:
            # one spare row past the high-water mark, as the reference keeps
            n = self.n_prows + 1
            self.ppool = _grown(self.ppool, n, 16)
            self.vpool = _grown(self.vpool, n, 16)
            self.rpool = _grown(self.rpool, n, 16)
            rows = torch.arange(self.n_prows - k, self.n_prows,
                                device=self.device)
            self.ppool.index_copy_(
                0, rows, self.put(np.stack(self.pend_prow).view(np.int32)))
            self.vpool.index_copy_(0, rows, self.put(np.stack(self.pend_vrow)))
            self.rpool.index_copy_(
                0, rows, self.put(np.stack(self.pend_rrow).astype(np.int32)))
            self.pend_prow.clear()
            self.pend_vrow.clear()
            self.pend_rrow.clear()
        ui = sum(len(x) for x in self.pend_imp)
        if ui:
            # 32-float tail slack: the rescore reads up to 32 positions per
            # bucket (indices clamp, non-present lanes are masked)
            self.ipool = _grown(self.ipool, self.n_imps + ui + 32, 1024)
            start = self.n_imps - ui
            self.ipool[start: start + ui] = self.put(
                np.concatenate(self.pend_imp))
            self.pend_imp.clear()
        if slot_rows is not None:
            prow, ioff = slot_rows
            cols = slice(self.b0, self.b0 + self.nblk)
            rows = torch.arange(n_slots - len(prow), n_slots,
                                device=self.device)
            self.sp_prow = _grown(self.sp_prow, n_slots, 16, -1)
            self.sp_ioff = _grown(self.sp_ioff, n_slots, 16, -1)
            self.sp_prow.index_copy_(0, rows, self.put(prow[:, cols]))
            self.sp_ioff.index_copy_(0, rows, self.put(ioff[:, cols]))


def split_layout(x, nblk: int, ranges):
    """The slices of an array in the global-block layout of nblk blocks for
    the block ranges [(first block, blocks), ...], zeros past nblk: by
    documents when its last axis is nblk*BLOCK_SIZE long (facet codes, a
    sort key), else by blocks along axis 0 (filter words, best keys)."""
    end = max(b0 + n for b0, n in ranges)
    if x.shape[-1] == nblk * BLOCK_SIZE:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1)
                   + [(0, (end - nblk) * BLOCK_SIZE)])
        return [x[..., b0 * BLOCK_SIZE:(b0 + n) * BLOCK_SIZE]
                for b0, n in ranges]
    x = np.pad(x, [(0, end - nblk)] + [(0, 0)] * (x.ndim - 1))
    return [x[b0:b0 + n] for b0, n in ranges]


def _grown(x, n: int, minimum: int, fill=0):
    """x with axis 0 grown (doubling, power of two) to hold n."""
    if x.shape[0] >= n:
        return x
    cap = ceil_pow2(max(n, x.shape[0] * 2), minimum)
    out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[: x.shape[0]] = x
    return out


class WandState:
    """Device pools + host caches for one committed index generation on one
    torch device, or on the positions of a mesh.

    Under a mesh of D positions the global block axis splits contiguously
    (the reference's WandState with a mesh, wand.py:984-1365): position d
    owns blocks [d*nblk_local, (d+1)*nblk_local), nblk_local = ceil(nblk /
    D), the last positions padded with empty blocks to nblk_pad; its part
    holds the pool rows, slot-table columns, deleted words and block shards
    of those blocks on its device.  Slot rows are numbered across the mesh
    (one slotmap serves every position) and pool rows within a part.  The
    host rows (_SlotRows, the blocks' shards, the deleted ids) are global.

    Rows are built on first touch per query term and kept; when the pools
    of any part pass their budgets (POOL_MB and IMP_MB a part) the whole
    cache flushes and rebuilds.  Row appends write in place (index_copy_)
    into rows no earlier dispatch reads, and capacity grows by doubling into
    new tensors, so a batch that holds the previous tensors keeps a
    consistent view."""

    def __init__(self, index, device, mesh=None):
        self.index = index
        self.mesh = mesh
        devices = list(mesh.devices) if mesh is not None \
            else [torch.device(device)]
        self.device = devices[0]            # the lead: merges happen here
        self.D = len(devices)
        self.lock = threading.Lock()
        base = []
        b = 0
        for sh in index.shards:
            base.append(b)
            b += sh.lexical.n_blocks
        self.block_base = base
        # K1 has no block step, so unlike the reference (whose XLA scan
        # steps 8 blocks at a time) a part is not padded to a step multiple
        self.nblk = max(b, 1)
        self.nblk_local = -(-self.nblk // self.D)
        self.nblk_pad = self.nblk_local * self.D

        blk_shard = np.zeros(self.nblk_pad, np.int32)
        for s, sh in enumerate(index.shards):
            blk_shard[base[s]: base[s] + sh.lexical.n_blocks] = s
        self.blk_shard = blk_shard[: self.nblk]

        delw = np.zeros((self.nblk_pad, NW), np.uint32)
        for s, sh in enumerate(index.shards):
            if sh.deleted:
                ids = np.fromiter(sh.deleted, np.int64)
                ids = ids[ids < sh.committed_doc_count]
                if len(ids):
                    g = base[s] + (ids >> 16)
                    local = ids & 0xFFFF
                    np.bitwise_or.at(
                        delw, (g, local >> 5),
                        (np.uint32(1) << (local & 31).astype(np.uint32)))
        nl = self.nblk_local
        self.parts = [_Part(dev, d * nl, nl, delw[d * nl:(d + 1) * nl],
                            blk_shard[d * nl:(d + 1) * nl])
                      for d, dev in enumerate(devices)]
        self.deleted_sorted = [
            np.sort(np.fromiter(sh.deleted, np.int64)) if sh.deleted
            else np.zeros(0, np.int64)
            for sh in index.shards
        ]
        # a part owning blocks of several shards: lane order is not gid
        # order, so a page whose tie class is cut must go to the host (the
        # reference's _dev_multi_shard, one flag for the whole mesh)
        self.multi_shard = any(
            len(np.unique(self.blk_shard[p.b0: p.b0 + p.nblk])) > 1
            for p in self.parts)

        cap_bytes = POOL_MB * 1024 * 1024
        # presence (4 B) + bucket-max (4 B) + rank rows per word
        self.cap_prows = max(cap_bytes * 9 // 10 // (NW * 10), 64)
        self.cap_slots = max(cap_bytes // 10 // (self.nblk_pad * 4), 64)
        self.cap_imps = max(IMP_MB * 1024 * 1024 // 4, 4096)
        self._aux: dict = {}
        self._reset()

    def aux(self, key, make, device: bool = True):
        """(host array, device copy) of an auxiliary array in the global-block
        layout (facet codes i32[NF, nblk*BLOCK_SIZE], filter words [nblk, NW],
        a rank key), built once per key by make(); the device copy is None
        with device=False, else a list of each part's slice on its device
        (its blocks, padded to nblk_local; one part without a mesh).  u32
        words go up as int32 bit patterns.  Dropped with the state, which a
        commit or delete replaces."""
        with self.lock:
            hit = self._aux.get(key)
            if hit is None:
                host = np.ascontiguousarray(make())
                dev = None
                if device:
                    bits = host.view(np.int32) if host.dtype == np.uint32 \
                        else host
                    dev = [p.put(x) for p, x in zip(self.parts, split_layout(
                        bits, self.nblk, [(p.b0, p.nblk)
                                          for p in self.parts]))]
                hit = self._aux[key] = (host, dev)
            return hit

    # the first part's tensors: without a mesh, the state's
    ppool = property(lambda self: self.parts[0].ppool)
    vpool = property(lambda self: self.parts[0].vpool)
    rpool = property(lambda self: self.parts[0].rpool)
    ipool = property(lambda self: self.parts[0].ipool)
    sp_prow = property(lambda self: self.parts[0].sp_prow)
    sp_ioff = property(lambda self: self.parts[0].sp_ioff)
    delw_dev = property(lambda self: self.parts[0].delw_dev)
    sid_dev = property(lambda self: self.parts[0].sid_dev)

    @property
    def pools(self):
        return self.parts[0].pools

    @property
    def n_prows(self) -> list[int]:
        """Pool rows a position (the reference's per-device counts)."""
        return [p.n_prows for p in self.parts]

    def pool_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for p in self.parts
                   for x in (p.ppool, p.vpool, p.rpool, p.ipool))

    def _reset(self):
        for p in self.parts:
            p.reset()
        self.n_slots = 0
        self.slot_cache: dict[int, _SlotRows] = {}
        self._pend_slot: list[np.ndarray] = []
        self._pend_ioff: list[np.ndarray] = []

    def _build_slot(self, h: int) -> _SlotRows:
        sr = _SlotRows()
        prow_vec = np.full(self.nblk_pad, -1, np.int32)
        ioff_vec = np.full(self.nblk_pad, -1, np.int32)
        keys_parts, imp_parts = [], []
        any_seg = False
        for s, sh in enumerate(self.index.shards):
            lex = sh.lexical
            d = lex.directory
            if d is None:
                continue
            ti = d.lookup(h)
            if ti < 0:
                continue
            for e in range(int(d.seg_start[ti]), int(d.seg_start[ti + 1])):
                off = int(d.seg_offset[e])
                ln = int(d.seg_len[e])
                if ln <= 0:
                    continue
                any_seg = True
                g = self.block_base[s] + int(d.seg_block[e])
                ids = lex.pl_docid[off: off + ln].astype(np.int64)
                imp = lex.pl_impact[off: off + ln]
                pw = np.zeros(NW, np.uint32)
                np.bitwise_or.at(
                    pw, ids >> 5,
                    np.uint32(1) << (ids & 31).astype(np.uint32))
                # per-bucket exact max impact (docids sorted -> reduceat)
                buckets = (ids >> 5).astype(np.int64)
                starts = np.flatnonzero(np.r_[True, np.diff(buckets) != 0])
                vrow = np.zeros(NW, np.float32)
                vrow[buckets[starts]] = np.maximum.reduceat(imp, starts)
                # the row lives in the part that owns block g; prow and
                # ioff are that part's own row and impact offset
                part = self.parts[g // self.nblk_local]
                prow_vec[g] = part.n_prows
                part.pend_prow.append(pw)
                part.pend_vrow.append(vrow)
                pc = _popcount_u32(pw)
                rrow = np.zeros(NW, np.uint16)
                # max prefix is 65536 - popcount(last word) <= 65504
                rrow[1:] = np.cumsum(pc[:-1]).astype(np.uint16)
                part.pend_rrow.append(rrow)
                ioff_vec[g] = part.n_imps
                part.pend_imp.append(imp.astype(np.float32))
                part.n_imps += ln
                part.n_prows += 1
                keys_parts.append((np.uint32(g) << np.uint32(16))
                                  | ids.astype(np.uint32))
                imp_parts.append(imp)
                sr.df += ln
        if any_seg:
            sr.row = self.n_slots
            self._pend_slot.append(prow_vec)
            self._pend_ioff.append(ioff_vec)
            self.n_slots += 1
        if keys_parts:
            sr.keys = np.concatenate(keys_parts)
            sr.imps = np.concatenate(imp_parts).astype(np.float32)
            order = np.argsort(sr.keys, kind="stable")
            if not np.all(order[:-1] < order[1:]):
                sr.keys = sr.keys[order]
                sr.imps = sr.imps[order]
        return sr

    def ensure_slots(self, hashes: list[int]) -> None:
        """Build and upload any missing slots' rows (call under self.lock)."""
        missing = [h for h in hashes if h not in self.slot_cache]
        if not missing:
            return
        with METRICS.timer("wand_build"):
            for h in missing:
                self.slot_cache[h] = self._build_slot(h)
            if (max(p.n_prows for p in self.parts) > self.cap_prows
                    or max(p.n_imps for p in self.parts) > self.cap_imps
                    or self.n_slots > self.cap_slots):
                METRICS.inc("wand_resets_total")
                self._reset()
                for h in hashes:
                    self.slot_cache[h] = self._build_slot(h)
            METRICS.inc("wand_rows_built_total", len(missing))
            slot_rows = None
            if self._pend_slot:
                slot_rows = (np.stack(self._pend_slot),
                             np.stack(self._pend_ioff))
                self._pend_slot.clear()
                self._pend_ioff.clear()
            for p in self.parts:
                p.upload(slot_rows, self.n_slots)


class _Signature:
    """What a piece of device state was built from: per shard the committed
    level object, committed doc count, block count and delete count.  The
    level objects are held and compared by identity, so that a later level
    (after a commit, a reload or ``Index.clear``) can never pass for the
    one the state was built from: an address is reused only once its
    object is gone, and these stay alive as long as the cached entry."""

    __slots__ = ("levels", "numbers")
    __hash__ = None

    def __init__(self, index):
        self.levels = [sh.lexical for sh in index.shards]
        self.numbers = [(sh.committed_doc_count, sh.lexical.n_blocks,
                         len(sh.deleted)) for sh in index.shards]

    def __eq__(self, other):
        return (isinstance(other, _Signature)
                and self.numbers == other.numbers
                and all(a is b for a, b in zip(self.levels, other.levels)))


def _signature(index) -> _Signature:
    return _Signature(index)


def index_lock(index, name: str) -> threading.Lock:
    """The lock `name` of `index`, made on first use (dict.setdefault is
    atomic, so concurrent first callers get the same lock)."""
    return index.__dict__.setdefault(name, threading.Lock())


def get_state(index, device) -> WandState:
    """The index's WandState on `device`, or on its mesh when one is
    attached (``Index.attach_mesh``; the mesh's devices then serve and
    `device` is not read), rebuilt after a commit or delete; concurrent
    first callers build it once.  Keyed by the device, or by the mesh."""
    m = getattr(index, "_mesh", None)
    key = m if m is not None else str(torch.device(device))
    sig = _signature(index)
    with index_lock(index, "_torch_wand_lock"):
        states = index.__dict__.setdefault("_torch_wand_states", {})
        hit = states.get(key)
        if hit is None or hit[0] != sig:
            hit = states[key] = (sig, WandState(index, device, mesh=m))
    return hit[1]


# ---------------------------------------------------------------------------
# host rescore + exact evaluation (numpy / native C++)


class RouteStats:
    """The port's adaptive routing counters for one index (the reference
    keeps its own on index._wand_stats / _prune_stats; these are separate,
    so a search of either package never steers the other's routing)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.wand = [0, 0]      # [exact fallbacks, queries], decaying
        self.wand_skips = 0     # batches refused while the gate is closed
        self.prune = [0, 0]     # [escalated, attempted] pruned plans

    def prune_ok(self) -> bool:
        """Pruned plans stay on until half of at least 8 escalated."""
        with self.lock:
            return self.prune[1] < 8 or self.prune[0] * 2 < self.prune[1]

    def record_prune(self, escalated: bool) -> None:
        with self.lock:
            self.prune[1] += 1
            self.prune[0] += int(escalated)

    def record_wand(self, fallbacks: int, queries: int) -> None:
        """The fallback-rate sample, halved past 2048 queries so a bad
        warm sample does not latch (reference wand.py:2305-2320)."""
        with self.lock:
            self.wand[0] += fallbacks
            self.wand[1] += queries
            if self.wand[1] > 2048:
                self.wand[0] //= 2
                self.wand[1] //= 2


def route_stats(index) -> RouteStats:
    return index.__dict__.setdefault("_torch_route_stats", RouteStats())


def wand_auto(index) -> bool:
    """Whether a batch on `index` rides WAND (reference wand.py:93-121,
    without its TPU-backend test).  Once more than half of a warm sample
    of at least 256 queries fell back to exact evaluation (flat impact
    maxima: the UBs cannot prune), the gate closes and lets every 64th
    batch through as a probe."""
    if os.environ.get("SEEKSTORM_TPU_NO_WAND"):
        return False
    if os.environ.get("SEEKSTORM_TPU_WAND"):
        return True
    if max(sh.lexical.n_blocks for sh in index.shards) < WAND_MIN_BLOCKS:
        return False
    st = route_stats(index)
    with st.lock:
        if st.wand[1] >= 256 and st.wand[0] * 2 > st.wand[1]:
            st.wand_skips += 1
            if st.wand_skips % 64 != 0:
                return False
    return True


def query_ok(spec) -> bool:
    """Eligibility: 1..T_MAX slots.  Phrase specs are eligible; their
    positional verification runs downstream in _finalize_lexical."""
    return 0 < len(spec.slots) <= T_MAX


def _flags(spec, t) -> int:
    fl = 0
    if spec.negated.get(t, False):
        fl |= 1
    if spec.required.get(t, False):
        fl |= 2
    if t in spec.weights:
        fl |= 4
    return fl


def _deleted_flat(state, S):
    dels = state.deleted_sorted
    del_off = np.zeros(S + 1, np.int64)
    for s_, d in enumerate(dels):
        del_off[s_ + 1] = del_off[s_] + len(d)
    del_flat = np.ascontiguousarray(
        np.concatenate(dels) if any(len(d) for d in dels)
        else np.zeros(1, np.int64), np.int64)
    return del_flat, del_off


def _rescore_many(state: WandState, slot_rows, specs_sel, idf_per_shard,
                  buckets_list, S: int, need: int = 0, filt_host=None,
                  rank_key=None):
    """Exact host rescore of many queries' candidate buckets: the native
    st_rescore when the library loads, else the numpy formulation.
    filt_host u32[NBLK, NW]: a facet filter's disallowed words, so pages
    never hold a filtered doc.  rank_key f32[NBLK*BLOCK_SIZE] (sorted
    results): matched candidates rank by their key, not their score."""
    out = _rescore_many_native(state, slot_rows, specs_sel, idf_per_shard,
                               buckets_list, S, need, filt_host, rank_key)
    if out is not None:
        return out
    return _rescore_many_np(state, slot_rows, specs_sel, idf_per_shard,
                            buckets_list, S, filt_host, rank_key)


def _opt_ptr(a, np_type, c_type):
    """(array kept alive, C pointer) of an optional array: null for None."""
    import ctypes as C

    if a is None:
        return None, C.POINTER(c_type)()
    a = np.ascontiguousarray(a, np_type)
    return a, a.ctypes.data_as(C.POINTER(c_type))


def _rescore_many_native(state: WandState, slot_rows, specs_sel,
                         idf_per_shard, buckets_list, S: int, need: int,
                         filt_host=None, rank_key=None):
    """st_rescore (C++, GIL released): one call per batch rung.  Output is
    cut to kmax = max(need*4, 64) entries per query; the length of the
    returned arrays still reports the true matched count (-inf / -1
    sentinels past kmax).  None when the native library is absent."""
    import ctypes as C

    lib = native.load()
    if lib is None or not hasattr(lib, "st_rescore"):
        return None
    nq = len(specs_sel)
    empty = (np.zeros(0, np.float32), np.zeros(0, np.int64))
    if nq == 0:
        return []
    used = sorted({t for sp in specs_sel for t in sp.slots})
    uidx = {t: i for i, t in enumerate(used)}
    n_used = len(used)
    key_ptrs = np.zeros(n_used, np.uint64)
    imp_ptrs = np.zeros(n_used, np.uint64)
    slot_len = np.zeros(n_used, np.int64)
    keep = []  # keeps the numpy buffers alive across the call
    zu32 = np.zeros(1, np.uint32)
    zf32 = np.zeros(1, np.float32)
    for i, t in enumerate(used):
        sr = slot_rows.get(t)
        k = sr.keys if sr is not None and len(sr.keys) else zu32
        im = sr.imps if sr is not None and len(sr.imps) else zf32
        keep.append((k, im))
        key_ptrs[i] = k.ctypes.data
        imp_ptrs[i] = im.ctypes.data
        slot_len[i] = 0 if sr is None else len(sr.keys)
    w_slot_shard = np.ascontiguousarray(idf_per_shard[:, used].T, np.float32)

    q_slots, q_flags, qs_off = [], [], [0]
    for sp in specs_sel:
        for t in sorted(sp.slots):
            q_slots.append(uidx[t])
            q_flags.append(_flags(sp, t))
        qs_off.append(len(q_slots))
    q_slots = np.asarray(q_slots, np.int32)
    q_flags = np.asarray(q_flags, np.uint8)
    qs_off = np.asarray(qs_off, np.int64)

    nbs = np.array([len(b) for b in buckets_list], dtype=np.int64)
    qoff = np.zeros(nq + 1, np.int64)
    np.cumsum(nbs, out=qoff[1:])
    if int(qoff[-1]) == 0:
        return [empty] * nq
    buckets = np.ascontiguousarray(
        np.concatenate([np.sort(b) for b in buckets_list]), np.int64)
    blk_shard = np.ascontiguousarray(state.blk_shard, np.int32)
    base = np.asarray(state.block_base, np.int64)
    del_flat, del_off = _deleted_flat(state, S)

    kmax = max(need * 4, 64)
    out_s = np.zeros(nq * kmax, np.float32)
    out_g = np.zeros(nq * kmax, np.int64)
    out_m = np.zeros(nq, np.int64)
    out_f = np.zeros(nq, np.int64)

    def p(a, ct):
        return a.ctypes.data_as(C.POINTER(ct))

    filt_c, filt_p = _opt_ptr(filt_host, np.uint32, C.c_uint32)
    rank_c, rank_p = _opt_ptr(rank_key, np.float32, C.c_float)
    lib.st_rescore(
        n_used, p(key_ptrs, C.c_uint64), p(imp_ptrs, C.c_uint64),
        p(slot_len, C.c_int64), p(w_slot_shard, C.c_float),
        nq, p(q_slots, C.c_int32), p(q_flags, C.c_uint8),
        p(qs_off, C.c_int64), p(buckets, C.c_int64), p(qoff, C.c_int64),
        p(blk_shard, C.c_int32), p(base, C.c_int64), S, NW,
        p(del_flat, C.c_int64), p(del_off, C.c_int64), filt_p, rank_p,
        kmax, p(out_s, C.c_float), p(out_g, C.c_int64),
        p(out_m, C.c_int64), p(out_f, C.c_int64))
    del keep, filt_c, rank_c
    out = []
    for qi in range(nq):
        m = int(out_m[qi])
        found = int(out_f[qi])
        sc = out_s[qi * kmax: qi * kmax + m].copy()
        gid = out_g[qi * kmax: qi * kmax + m].copy()
        if found > m:
            sc = np.concatenate([sc, np.full(found - m, -np.inf, np.float32)])
            gid = np.concatenate([gid, np.full(found - m, -1, np.int64)])
        out.append((sc, gid))
    return out


def _rescore_many_np(state: WandState, slot_rows, specs_sel, idf_per_shard,
                     buckets_list, S: int, filt_host=None, rank_key=None):
    """numpy host rescore: per query (scores f32[n], gids i64[n]) sorted by
    (score desc, gid asc).  Scoring slots add in ascending slot id, the
    order of the device UB chain."""
    nq = len(specs_sel)
    empty = (np.zeros(0, np.float32), np.zeros(0, np.int64))
    nbs = np.array([len(b) for b in buckets_list], dtype=np.int64)
    qoff = np.zeros(nq + 1, np.int64)
    np.cumsum(nbs, out=qoff[1:])
    NB = int(qoff[-1])
    if NB == 0:
        return [empty] * nq
    buckets = np.concatenate([np.sort(b) for b in buckets_list])
    qmap = np.repeat(np.arange(nq, dtype=np.int64), nbs)
    blk = (buckets // NW).astype(np.int64)
    word = (buckets % NW).astype(np.int64)
    lo_key = ((blk.astype(np.uint32)) << np.uint32(16)) \
        | (word * 32).astype(np.uint32)
    hi_key = lo_key + np.uint32(32)

    scores = np.zeros((NB, BUCKET), np.float32)
    reqc = np.zeros((NB, BUCKET), np.int16)
    anyh = np.zeros((NB, BUCKET), bool)
    negh = np.zeros((NB, BUCKET), bool)
    nreq = np.array(
        [sum(1 for t in sp.slots
             if sp.required.get(t, False) and not sp.negated.get(t, False))
         for sp in specs_sel], dtype=np.int16)

    slot_q: dict[int, list[int]] = {}
    for qi, sp in enumerate(specs_sel):
        for t in sp.slots:
            slot_q.setdefault(t, []).append(qi)

    for t in sorted(slot_q):
        sr = slot_rows.get(t)
        if sr is None or not len(sr.keys):
            continue
        rows_sel = np.concatenate(
            [np.arange(qoff[qi], qoff[qi + 1]) for qi in slot_q[t]])
        lo = np.searchsorted(sr.keys, lo_key[rows_sel])
        hi = np.searchsorted(sr.keys, hi_key[rows_sel])
        cnts = hi - lo
        tot = int(cnts.sum())
        if tot == 0:
            continue
        rows = np.repeat(rows_sel, cnts)
        idxs = (np.repeat(lo, cnts) + np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(cnts) - cnts, cnts))
        local = (sr.keys[idxs] & 31).astype(np.int64)
        q_of = qmap[rows]
        negf = np.array([specs_sel[qi].negated.get(t, False)
                         for qi in range(nq)], dtype=bool)
        reqf = np.array([specs_sel[qi].required.get(t, False)
                         for qi in range(nq)], dtype=bool) & ~negf
        scf = np.array([t in specs_sel[qi].weights
                        for qi in range(nq)], dtype=bool) & ~negf
        m = negf[q_of]
        if m.any():
            negh[rows[m], local[m]] = True
        m = ~negf[q_of]
        if m.any():
            anyh[rows[m], local[m]] = True
        m = reqf[q_of]
        if m.any():
            reqc[rows[m], local[m]] += 1
        m = scf[q_of]
        if m.any():
            rm, lm, im = rows[m], local[m], idxs[m]
            w = idf_per_shard[state.blk_shard[blk[rm]], t]
            # (row, local) pairs are unique within one slot
            scores[rm, lm] += w.astype(np.float32) * sr.imps[im]

    matched = anyh & ~negh & (reqc >= nreq[qmap][:, None])
    if filt_host is not None:
        fw = filt_host[blk, word]
        fbits = (fw[:, None] >> np.arange(32, dtype=np.uint32)) \
            & np.uint32(1)
        matched &= fbits == 0
    shard_of = state.blk_shard[blk]
    base_arr = np.asarray(state.block_base, np.int64)
    lvl_local0 = ((blk - base_arr[shard_of]) * BLOCK_SIZE + word * 32)
    for s_ in np.unique(shard_of):
        dels = state.deleted_sorted[s_]
        if not len(dels):
            continue
        m = shard_of == s_
        cand_ids = (lvl_local0[m][:, None]
                    + np.arange(BUCKET, dtype=np.int64)[None, :])
        isdel = np.clip(np.searchsorted(dels, cand_ids.reshape(-1)), 0,
                        len(dels) - 1)
        hit = dels[isdel] == cand_ids.reshape(-1)
        mm = matched[m]
        mm &= ~hit.reshape(mm.shape)
        matched[m] = mm

    rows, local = np.nonzero(matched)
    if not len(rows):
        return [empty] * nq
    if rank_key is not None:
        sc = rank_key[blk[rows] * BLOCK_SIZE + word[rows] * 32 + local]
        sc = sc.astype(np.float32)
    else:
        sc = scores[rows, local]
    gid = ((lvl_local0[rows] + local) * S + shard_of[rows]).astype(np.int64)
    qi_of = qmap[rows]
    order = np.lexsort((gid, -sc, qi_of))
    sc, gid, qi_of = sc[order], gid[order], qi_of[order]
    ends = np.cumsum(np.bincount(qi_of, minlength=nq))
    out = []
    a = 0
    for qi in range(nq):
        b = int(ends[qi])
        out.append((sc[a:b].astype(np.float32), gid[a:b]))
        a = b
    return out


def _exact_eval_native(state, slot_rows, spec, idf_per_shard, S, N, need,
                       filt_host=None, rank_key=None):
    """st_exact_eval (C++) version of the exact evaluation: GIL released,
    bit-identical accumulation.  None when the native library is absent."""
    import ctypes as C

    lib = native.load()
    if lib is None or not hasattr(lib, "st_exact_eval"):
        return None
    order = sorted(spec.slots)
    keys_parts, imps_parts, offs, flags, ws = [], [], [0], [], []
    for t in order:
        sr = slot_rows.get(t)
        k = sr.keys if sr is not None else np.zeros(0, np.uint32)
        im = sr.imps if sr is not None else np.zeros(0, np.float32)
        keys_parts.append(k)
        imps_parts.append(im)
        offs.append(offs[-1] + len(k))
        flags.append(_flags(spec, t))
        ws.append(idf_per_shard[:, t])
    keys = np.ascontiguousarray(
        np.concatenate(keys_parts) if keys_parts else np.zeros(0), np.uint32)
    imps = np.ascontiguousarray(
        np.concatenate(imps_parts) if imps_parts else np.zeros(0), np.float32)
    offs = np.asarray(offs, np.int64)
    flags = np.asarray(flags, np.uint8)
    wss = np.ascontiguousarray(np.stack(ws), np.float32) if ws \
        else np.zeros((0, S), np.float32)
    blk_shard = np.ascontiguousarray(state.blk_shard, np.int32)
    base = np.asarray(state.block_base, np.int64)
    del_flat, del_off = _deleted_flat(state, S)
    k = max(need * 4, 64)
    out_s = np.zeros(k, np.float32)
    out_g = np.zeros(k, np.int64)
    out_c = np.zeros(1, np.int64)

    def p(a, ct):
        return a.ctypes.data_as(C.POINTER(ct))

    filt_c, filt_p = _opt_ptr(filt_host, np.uint32, C.c_uint32)
    rank_c, rank_p = _opt_ptr(rank_key, np.float32, C.c_float)
    m = lib.st_exact_eval(
        len(order), p(keys, C.c_uint32), p(imps, C.c_float),
        p(offs, C.c_int64), p(wss, C.c_float), p(flags, C.c_uint8),
        p(blk_shard, C.c_int32), p(base, C.c_int64), S, N,
        p(del_flat, C.c_int64), p(del_off, C.c_int64), filt_p, rank_p, k,
        p(out_s, C.c_float), p(out_g, C.c_int64), p(out_c, C.c_int64))
    del filt_c, rank_c
    m = int(m)
    return out_s[:m], out_g[:m], int(out_c[0])


def _exact_fallback(state: WandState, slot_rows, spec, idf_per_shard,
                    S: int, need: int, filt_host=None, rank_key=None):
    """Exact full evaluation of one query on the host CSR, for queries
    whose UBs saturate every rung.  Accumulation matches the rescores
    (ascending slot id, f32), so scores are bit-identical to WAND pages.
    filt_host / rank_key as in _rescore_many.  Returns (scores, gids,
    count)."""
    N = 0
    for s_, sh in enumerate(state.index.shards):
        N = max(N, int(sh.committed_doc_count) * S + s_ + 1)
    N = max(N, 1)
    native = _exact_eval_native(state, slot_rows, spec, idf_per_shard, S, N,
                                need, filt_host, rank_key)
    if native is not None:
        return native
    score = np.zeros(N, np.float32)
    any_cnt = np.zeros(N, np.int16)
    req_cnt = np.zeros(N, np.int16)
    neg_cnt = np.zeros(N, np.int16)
    base_arr = np.asarray(state.block_base, np.int64)
    nreq = 0
    for t in sorted(spec.slots):
        sr = slot_rows.get(t)
        neg = spec.negated.get(t, False)
        req = spec.required.get(t, False) and not neg
        if req:
            nreq += 1
        if sr is None or not len(sr.keys):
            continue
        blk = (sr.keys >> np.uint32(16)).astype(np.int64)
        docid = (sr.keys & np.uint32(0xFFFF)).astype(np.int64)
        imps_t = sr.imps
        if filt_host is not None:
            fw = filt_host[blk, docid >> 5]
            keep = ((fw >> (docid & 31).astype(np.uint32))
                    & np.uint32(1)) == 0
            blk, docid, imps_t = blk[keep], docid[keep], imps_t[keep]
            if not len(blk):
                continue
        shard_of = state.blk_shard[blk]
        gid = ((blk - base_arr[shard_of]) * BLOCK_SIZE + docid) * S + shard_of
        if neg:
            neg_cnt += np.bincount(gid, minlength=N).astype(np.int16)
            continue
        any_cnt += np.bincount(gid, minlength=N).astype(np.int16)
        if req:
            req_cnt += np.bincount(gid, minlength=N).astype(np.int16)
        if t in spec.weights:
            w = idf_per_shard[shard_of, t].astype(np.float32)
            score += np.bincount(
                gid, weights=(w * imps_t).astype(np.float64),
                minlength=N).astype(np.float32)
    matched = (any_cnt > 0) & (neg_cnt == 0) & (req_cnt >= nreq)
    for s_, dels in enumerate(state.deleted_sorted):
        if len(dels):
            g = dels * S + s_
            matched[g[g < N]] = False
    count = int(matched.sum())
    if count == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int64), 0
    k = min(max(need * 4, 64), count)
    if rank_key is not None:
        gidx = np.flatnonzero(matched)
        score = np.zeros(N, np.float32)
        score[gidx] = rank_key[gidx // S + base_arr[gidx % S] * BLOCK_SIZE]
    sc_m = np.where(matched, score, -np.inf)
    # everything strictly above the kth value, then the smallest gids of
    # the kth tie class
    neg_s = -sc_m
    kthv = np.partition(neg_s, k - 1)[k - 1]
    above = np.flatnonzero(neg_s < kthv)
    ties = np.flatnonzero(neg_s == kthv)
    sel = np.concatenate([above, ties[: k - len(above)]])
    order = np.lexsort((sel, -sc_m[sel]))
    gids = sel[order].astype(np.int64)
    return sc_m[gids].astype(np.float32), gids, count


def _apply_slim(state: WandState, buf, specs, S: int,
                out_scores, out_gids, counts) -> list[int]:
    """Consume the slim device-ladder buffer: fill the outputs of every
    query the device terminated (code 0/1) and return the pending query
    indices for the host ladder.  One shard on one device: the device page
    is already (score desc, lane asc) = oracle order; several shards, or a
    mesh (whose page lays the D positions' pages side by side, D*P_PAGE
    entries): one global (query, -score, gid) sort restores it."""
    B = len(specs)
    DP = state.D * P_PAGE
    buf_f = buf.view(np.float32)
    cnt = buf[:B, 0].astype(np.int64)
    code = buf[:B, 1]
    found = buf[:B, 2].astype(np.int64)
    psc = buf_f[:B, 4: 4 + DP]
    plane = buf[:B, 4 + DP: 4 + 2 * DP].astype(np.int64)

    blk = plane >> 16
    doc = plane & 0xFFFF
    shard_of = state.blk_shard[np.minimum(blk, state.nblk - 1)]
    base_arr = np.asarray(state.block_base, np.int64)
    gid = ((blk - base_arr[shard_of]) * BLOCK_SIZE + doc) * S + shard_of
    valid = psc > -np.inf

    qi_of, ci = np.nonzero(valid)
    sc_v = psc[qi_of, ci].astype(np.float32)
    gid_v = gid[qi_of, ci]
    if S > 1 or state.D > 1:
        order = np.lexsort((gid_v, -sc_v, qi_of))
        sc_v, gid_v, qi_of = sc_v[order], gid_v[order], qi_of[order]
    ends = np.cumsum(np.bincount(qi_of, minlength=B))

    still: list[int] = []
    a = 0
    for qi in range(B):
        b = int(ends[qi])
        sc, gd = sc_v[a:b], gid_v[a:b]
        a = b
        if code[qi] > 1:
            still.append(qi)
            continue
        nf = int(found[qi])
        if nf > len(sc):
            # the length reports the true matched count (the
            # `n_found >= need` tests downstream)
            sc = np.concatenate([sc, np.full(nf - len(sc), -np.inf,
                                             np.float32)])
            gd = np.concatenate([gd, np.full(nf - len(gd), -1, np.int64)])
        out_scores[qi] = sc
        out_gids[qi] = gd
        counts[qi] = cnt[qi]
    return still


def _run_dev_exact(state: WandState, pending, slotmap, tslot, treq, tneg,
                   wsh, pools, filtw_dev, cnt, S: int, out_scores, out_gids,
                   counts) -> list[int]:
    """Dispatch wand_exact_scan for the batch's stragglers, in groups of 1,
    2 or 4 queries (the reference's padded shape ladder, wand.py:859), and
    fill their outputs: the page, padded to the matched count with -inf /
    -1 as the host evaluation reports it, and phase 1's count.  Returns the
    queries still left for the host (none)."""
    base_arr = np.asarray(state.block_base, np.int64)
    todo = list(pending)
    dev = state.device
    while todo:
        n = len(todo)
        Bq = 1 if n == 1 else (2 if n == 2 else 4)
        group, todo = todo[:Bq], todo[Bq:]
        rows = group + [group[-1]] * (Bq - len(group))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (slotmap, tslot[rows], treq[rows], tneg[rows],
                          wsh[:, rows])]
        METRICS.inc("device_dispatch_total")
        METRICS.inc("wand_dev_exact_total")
        with METRICS.timer("wand_dev_exact"), METRICS.timer("lex_device"):
            psc, plane, found = [
                x.cpu().numpy() for x in wand_exact_scan(
                    *pools, *args, filtw=filtw_dev)]
        plane = plane.astype(np.int64)
        for r, qi in enumerate(group):
            valid = psc[r] > -np.inf
            sc = psc[r][valid].astype(np.float32)
            blk = plane[r][valid] >> 16
            doc = plane[r][valid] & 0xFFFF
            shard_of = state.blk_shard[np.minimum(blk, state.nblk - 1)]
            gd = ((blk - base_arr[shard_of]) * BLOCK_SIZE + doc) * S \
                + shard_of
            nf = int(found[r])
            if nf > len(sc):
                sc = np.concatenate(
                    [sc, np.full(nf - len(sc), -np.inf, np.float32)])
                gd = np.concatenate(
                    [gd, np.full(nf - len(gd), -1, np.int64)])
            out_scores[qi] = sc
            out_gids[qi] = gd
            counts[qi] = cnt[qi]
    return []


def plan_batch(state: WandState, slots, specs, idf_per_shard):
    """Build the batch's term rows and its per-query tables (call under
    state.lock): slotmap i32[V] (batch slot -> slot row), tslot i32[Bq, T],
    treq / tneg bool[Bq, T], wsh f32[S, Bq, T], and the _SlotRows the host
    rescores read, pinned against a concurrent reset.  Positive slots come
    first in ascending slot id: the UB chain and the rescores add terms in
    this same order."""
    used = sorted({s for spec in specs for s in spec.slots})
    state.ensure_slots([slots[s].hash for s in used])
    V = ceil_pow2(max(len(slots), 1), 16)
    slotmap = np.full(V, -1, np.int32)
    for s in used:
        slotmap[s] = state.slot_cache[slots[s].hash].row
    slot_rows = {s: state.slot_cache[slots[s].hash] for s in used}
    Bq = ceil_pow2(len(specs), 16)
    t_need = max(len(sp.slots) for sp in specs)
    T = 2 if t_need <= 2 else (4 if t_need <= 4 else T_MAX)
    S = idf_per_shard.shape[0]
    tslot = np.full((Bq, T), -1, np.int32)
    treq = np.zeros((Bq, T), bool)
    tneg = np.zeros((Bq, T), bool)
    wsh = np.zeros((S, Bq, T), np.float32)
    for qi, spec in enumerate(specs):
        ordered = (sorted(s for s in spec.slots
                          if not spec.negated.get(s, False))
                   + [s for s in spec.slots if spec.negated.get(s, False)])
        for j, s in enumerate(ordered):
            tslot[qi, j] = s
            treq[qi, j] = spec.required.get(s, False)
            tneg[qi, j] = spec.negated.get(s, False)
            if s in spec.weights:
                wsh[:, qi, j] = idf_per_shard[:, s]
    return slotmap, tslot, treq, tneg, wsh, slot_rows


def run_batch(index, slots, specs, idf_per_shard: np.ndarray, need: int,
              with_counts: bool, device, count_only: bool = False,
              fcod_dev=None, n_facets: int = 0, fcm: int = 1,
              filtw_dev=None, filt_host=None, skeyb_dev=None,
              rank_key_host=None):
    """Execute a batch of eligible (query_ok) queries on the WAND path.

    idf_per_shard: f32[S, V] per-shard idf per slot (realtime aware).
    Pages of need <= 16 finish on the device ladder; deeper pages and
    device stragglers go through the host rung ladder.  Queries whose UBs
    saturate every rung take the device exact scan on one shard under
    SEEKSTORM_TPU_WAND_DEV_EXACT; else they come back unhandled at batch >=
    DEFER_MIN_BATCH (SEEKSTORM_TPU_WAND_DEFER_DENSE=1/0 overrides) for the
    join or dense path, and go through the host exact evaluation otherwise.
    SEEKSTORM_TPU_WAND_FORCE_FALLBACK / _FORCE_DEV_EXACT send every query to
    the host / device exact evaluation.  count_only
    (ResultType.Count) returns phase 1's popcounts and no pages.

    fcod_dev (i32[NF, NBLK*BLOCK_SIZE], global-block layout) with
    n_facets / fcm: exact facet counts over every matched doc.  filtw_dev /
    filt_host (disallowed words [NBLK, NW], tensor and u32 array): a facet
    filter shared by the batch, applied to matching, counts, facet counts
    and every rescore.  skeyb_dev (f32[NBLK, NW] best rank key a bucket)
    with rank_key_host (f32[NBLK*BLOCK_SIZE]): pages order by the rank key
    (sorted results), through the host ladder over all three rungs.  The
    batch runs on the state's parts (wand_scan_mesh: the positions of an
    attached mesh, else the one device) and fcod_dev, filtw_dev and
    skeyb_dev are lists of the parts' slices (WandState.aux); the device
    exact scan stays off under a mesh.
    Returns (scores list, gids list, counts i64[B], fc i64[NF, B, fcm] or
    None, handled bool[B])."""
    state = get_state(index, device)
    dev = state.device
    B = len(specs)
    S = index.shard_count
    out_scores: list = [np.zeros(0, np.float32)] * B
    out_gids: list = [np.zeros(0, np.int64)] * B
    counts = np.zeros(B, np.int64)

    with state.lock:
        slotmap, tslot, treq, tneg, wsh, slot_rows = plan_batch(
            state, slots, specs, idf_per_shard)
        pools = [p.pools for p in state.parts]

    rank_mode = rank_key_host is not None
    # rank mode keeps the host ladder: it ranks by gathered sort keys, not
    # by scores
    dev_rescore = (not rank_mode and not count_only
                   and max(need * 4, 64) <= P_PAGE)
    qargs = (slotmap, tslot, treq, tneg, wsh)
    aux = dict(filtw=filtw_dev, fcod=fcod_dev if n_facets else None,
               fcm=fcm, skeyb=skeyb_dev if rank_mode else None)

    def dispatch(**kw):
        return wand_scan_mesh(state, pools, qargs, **kw, **aux)
    METRICS.inc("device_dispatch_total")
    KP = K_SEL + 1
    with METRICS.timer("lex_device"):
        if dev_rescore:
            out, fc_d = dispatch(with_counts=with_counts, with_rescore=True,
                                 need=need, multi=state.multi_shard)
            packed = out.cpu().numpy()
        else:
            (cnt_d, rungs_d), fc_d = dispatch(with_counts=with_counts,
                                              with_rescore=False)
            cnt = cnt_d.cpu().numpy().astype(np.int64)
            rungs = [(v.cpu().numpy(), i.cpu().numpy()) for v, i in rungs_d]
        fc = None if fc_d is None else \
            fc_d[:n_facets, :B].cpu().numpy().astype(np.int64)

    # parity modes (the reference's, wand.py:2158-2188): every query to the
    # host exact evaluation, or to the device exact scan
    force_fb = bool(os.environ.get("SEEKSTORM_TPU_WAND_FORCE_FALLBACK"))
    force_dx = bool(os.environ.get("SEEKSTORM_TPU_WAND_FORCE_DEV_EXACT"))
    if dev_rescore:
        A = 4 + 2 * state.D * P_PAGE
        buf_f = packed.view(np.float32)
        cnt = packed[:B, 0].astype(np.int64)
        host_rungs = []
        if force_fb or force_dx:
            pending = list(range(B))
        else:
            pending = _apply_slim(state, packed, specs, S, out_scores,
                                  out_gids, counts)
            METRICS.inc("wand_dev_pages_total", B - len(pending))
            if S > 1:
                host_rungs.append((packed[:B, A + KP: A + KP + K_SEL],
                                   buf_f[:B, A + 2 * KP - 1], 1))
            host_rungs.append((packed[:B, A: A + K_SEL],
                               buf_f[:B, A + K_SEL], F_LADDER[2]))
    elif count_only:
        # the phase-1 popcount is the answer: no pages, no ladder
        counts[:] = cnt[:B]
        return out_scores, out_gids, counts, fc, np.ones(B, bool)
    else:
        pending = list(range(B))
        host_rungs = [] if force_fb else [
            (ids.astype(np.int64), vals[:, K_SEL], F)
            for (vals, ids), F in zip(rungs, F_LADDER)]

    # host ladder: rescore each pending query's selected regions exactly
    # and terminate on the strict WAND test (kth > next_ub, 3e-7 margin;
    # rank mode compares gathered f32 keys on both sides, which may be
    # negative, so it takes no margin)
    for ids_arr, nub_arr, F in host_rungs:
        if not pending:
            break
        buckets_list = [
            np.unique(ids_arr[qi].astype(np.int64)[:, None] * F
                      + np.arange(F, dtype=np.int64)[None, :])
            for qi in pending
        ]
        with METRICS.timer("wand_rescore"):
            rescored = _rescore_many(state, slot_rows,
                                     [specs[qi] for qi in pending],
                                     idf_per_shard, buckets_list, S, need,
                                     filt_host, rank_key_host)
        still = []
        for (sc, gid), qi in zip(rescored, pending):
            next_ub = float(nub_arr[qi])
            n_found = len(gid)
            kth = float(sc[need - 1]) if n_found >= need else -np.inf
            bound = next_ub if rank_mode else next_ub * (1.0 + 3e-7)
            if (next_ub == -np.inf) or (n_found >= need and kth > bound):
                out_scores[qi] = sc[: max(need * 4, 64)]
                out_gids[qi] = gid[: max(need * 4, 64)]
                counts[qi] = cnt[qi]
            else:
                still.append(qi)
        pending = still
        if pending:
            METRICS.inc("wand_escalations_total")
    METRICS.inc("wand_fallbacks_total", len(pending))
    if (pending and not force_fb and not rank_mode and S == 1
            and state.mesh is None
            and (os.environ.get("SEEKSTORM_TPU_WAND_DEV_EXACT")
                 or force_dx)):
        # opt-in (SEEKSTORM_TPU_WAND_DEV_EXACT) single-shard stragglers:
        # the full-coverage exact scan on the device over the resident
        # pools; several shards keep the host path (a tie class cut at a
        # lane boundary needs gid-order arbitration there)
        pending = _run_dev_exact(state, pending, slotmap, tslot, treq, tneg,
                                 wsh, pools[0],
                                 None if filtw_dev is None else filtw_dev[0],
                                 cnt, S, out_scores, out_gids, counts)
    if not rank_mode:
        # the opt-in sort path has its own fallback geometry and must not
        # close the gate for score-mode batches
        route_stats(index).record_wand(len(pending), B)
    handled = np.ones(B, bool)
    denv = os.environ.get("SEEKSTORM_TPU_WAND_DEFER_DENSE")
    defer = denv not in ("", "0") if denv is not None \
        else B >= DEFER_MIN_BATCH
    if defer and not force_fb:
        handled[pending] = False
        return out_scores, out_gids, counts, fc, handled
    for qi in pending:
        with METRICS.timer("wand_exact_fallback"):
            sc, gid, count = _exact_fallback(state, slot_rows, specs[qi],
                                             idf_per_shard, S, need,
                                             filt_host, rank_key_host)
        out_scores[qi] = sc
        out_gids[qi] = gid
        counts[qi] = count
    return out_scores, out_gids, counts, fc, handled
