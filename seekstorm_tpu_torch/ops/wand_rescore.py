"""Phases 3-4 of the WAND route: kernel K5 (csrc/wand_rescore.cu) and its
plain PyTorch version, the exact rescore of selected buckets and the
device page, with the device exact scan as K5's fold mode.

Replaces the XLA programs ``seekstorm_tpu/ops/wand.py::_rescore_regions``
(589) and ``_page_topk`` (700), composed by ``_ladder_device`` (722) and by
``wand_exact_scan`` (811).

``rescore_page`` has the contract of ``_page_topk(*_rescore_regions(...)
[:2])`` with the matched count: for each query the top-P_PAGE of its
selected buckets' docs by (score desc, candidate asc), where the candidates
are the selected buckets in ascending id order (unselected ones last,
clamped to the last bucket) times their 32 bits, so an entry past the
matched docs is the next unmatched candidate with score -inf.
``exact_fold`` is the device exact scan: every bucket of the pools,
folded into a running page that starts from a carried page and keeps
carried entries first on ties; ``exact_scan_ref`` is the plain loop over
blocks it must equal bit for bit.

K5 takes one CTA a query (page mode) or a (query, bucket range) (fold
mode), scores the matched docs of its buckets into a list in candidate
order, and pages from that list: sorted whole by one warp when it holds
at most SORTED docs, else through the select of csrc/topk_select.cuh.
``page_select_ref`` and ``exact_fold_ref`` restate its pages in numpy (on
top of ``ops/wand_rungs.radix_topk_ref``), so the CPU tests hold the
kernel's algorithm against ``_page_topk`` and ``exact_scan_ref``; the
kernel itself meets its plain version on the card (chip_smoke.py).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..metrics import METRICS
from ..schema import BLOCK_SIZE
from .wand_rungs import _sort_desc, desc_keys, radix_topk_ref
from .wand_scan import _check, popcount32

NW = BLOCK_SIZE // 32          # packed words per block == buckets per block
P_PAGE = 64                    # device page entries per query
T_MAX = 8                      # columns a query
K_MAX = 256                    # selected buckets a query in page mode
SORTED = 256                   # matched docs a page sorts whole (one warp)
CHUNK = 256                    # buckets a chunk of the fold mode
MAX_SPLITS = 128               # bucket ranges a query in the fold mode

# launches of K5 since the last reset (the count a run reads to show that
# its main path went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K5 launch: in LAUNCHES and in METRICS' k5_launches_total."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k5_launches_total")


# ---------------------------------------------------------------------------
# plain version


_BIT = torch.arange(32, dtype=torch.int32)
# (1 << bit) - 1 per bit, as int32 bit patterns
_BELOW = torch.tensor([(1 << b) - 1 for b in range(32)], dtype=torch.int32)


def _rescore_regions(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                     slotmap, tslot, treq, tneg, wshard, ids, vals,
                     filtw=None, bucket_off: int = 0):
    """Phase 3: exact rescore of the selected buckets.

    ids / vals [Bq, K]: bucket ids and their UBs (-inf = unselected).  For
    term t and bucket w of block b, the doc at bit j reads the flat impact
    pool at ioff + rank[w] + popcount(word & (2^j - 1)) — a direct gather
    (the reference's one-hot MXU select is not needed here).  Scores add
    one term at a time in column order with a separate mul and add, the
    host rescore's two-rounding chain, so UB >= score stays bitwise.
    filtw i32[NBLK, NW]: a facet filter's disallowed words, or None.
    bucket_off: the global id of the pools' first bucket (a mesh part's),
    added to the lanes.

    Returns (score f32[Bq, K*32] with -inf for unmatched lanes, lane
    i32[Bq, K*32] doc lanes = global bucket*32 + bit, found i32[Bq])."""
    dev = ppool.device
    Bq, K = ids.shape
    T = tslot.shape[1]
    NBLK = sp_prow.shape[1]
    big = NBLK * NW
    valid = vals > float("-inf")
    ids_s = torch.where(valid, ids.long(), big).sort(dim=1)[0]
    valid_s = ids_s < big
    ids_c = ids_s.clamp(max=big - 1)
    blk = ids_c // NW                                   # [Bq, K]
    w = ids_c % NW

    ts_ok = tslot >= 0
    srow = torch.where(ts_ok, slotmap.long()[tslot.clamp(min=0).long()],
                       torch.full_like(tslot, -1, dtype=torch.long))
    rows3 = srow[:, :, None].expand(Bq, T, K)
    blk3 = blk[:, None, :].expand(Bq, T, K)
    w3 = w[:, None, :].expand(Bq, T, K)
    rows3c = rows3.clamp(min=0)
    prow = sp_prow[rows3c, blk3]
    ioff = sp_ioff[rows3c, blk3]
    ok3 = (rows3 >= 0) & (prow >= 0) & valid_s[:, None, :]
    prow_c = prow.clamp(min=0).long()
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    pres = torch.where(ok3, ppool[prow_c, w3], zero_i)  # [Bq, T, K]
    rank = rpool[prow_c, w3]

    bit = _BIT.to(dev)
    pres4 = pres[..., None]                              # [Bq, T, K, 1]
    rank_b = popcount32(pres4 & _BELOW.to(dev))          # [Bq, T, K, 32]
    pos = (ioff.clamp(min=0) + rank)[..., None].long() + rank_b
    val_b = ipool[pos.clamp(0, ipool.shape[0] - 1)]
    present = ((pres4 >> bit) & 1) != 0
    imp_b = torch.where(present & ok3[..., None], val_b,
                        torch.zeros((), device=dev))

    andw = torch.full((Bq, K), -1, dtype=torch.int32, device=dev)
    posw = torch.zeros((Bq, K), dtype=torch.int32, device=dev)
    negw = torch.zeros((Bq, K), dtype=torch.int32, device=dev)
    for t in range(T):
        req_t = (treq[:, t] & ~tneg[:, t] & ts_ok[:, t])[:, None]
        andw = torch.where(req_t, andw & pres[:, t], andw)
        posw = posw | torch.where((~tneg[:, t] & ts_ok[:, t])[:, None],
                                  pres[:, t], zero_i)
        negw = negw | torch.where((tneg[:, t] & ts_ok[:, t])[:, None],
                                  pres[:, t], zero_i)
    matched_w = andw & posw & ~negw & ~delw[blk, w]
    if filtw is not None:
        matched_w = matched_w & ~filtw[blk, w]
    matched = ((matched_w[..., None] >> bit) & 1) != 0
    matched = matched & valid_s[..., None]               # [Bq, K, 32]

    sid3 = sid.long()[blk][:, None, :].expand(Bq, T, K)
    wt = torch.gather(wshard.permute(1, 2, 0), 2, sid3)  # [Bq, T, K]
    score = torch.zeros((Bq, K, 32), dtype=torch.float32, device=dev)
    for t in range(T):
        score = score + wt[:, t, :, None] * imp_b[:, t]
    score = torch.where(matched, score,
                        torch.full((), float("-inf"), device=dev))
    found = matched.sum(dim=(1, 2), dtype=torch.int32)
    lane = ((ids_c[:, :, None] + bucket_off) * 32
            + bit.long()).reshape(Bq, K * 32).to(torch.int32)
    return score.reshape(Bq, K * 32), lane, found


def _page_topk(score, lane):
    """Device page: top-P_PAGE candidates by (score desc, lane asc — the
    candidate lanes ascend and the sort is stable), plus the count of
    candidates tying or beating the page's last entry."""
    vals, sel = _sort_desc(score)
    psc = vals[:, :P_PAGE].contiguous()
    plane = torch.gather(lane, 1, sel[:, :P_PAGE])
    last = psc[:, P_PAGE - 1]
    n_ge = ((score >= last[:, None]) & (score > float("-inf"))).sum(
        dim=1, dtype=torch.int32)
    return psc, plane, n_ge


def rescore_page_ref(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                     slotmap, tslot, treq, tneg, wshard, ids, vals,
                     filtw=None, bucket_off: int = 0):
    """The plain composition K5 replaces: (psc f32[Bq, P_PAGE], plane
    i32[Bq, P_PAGE], n_ge i32[Bq], found i32[Bq])."""
    sc, lane, found = _rescore_regions(
        ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap, tslot,
        treq, tneg, wshard, ids, vals, filtw, bucket_off)
    return _page_topk(sc, lane) + (found,)


def initial_carry(Bq: int, device):
    """The page the exact scan starts from: -inf scores, lane 0."""
    return (torch.full((Bq, P_PAGE), float("-inf"), device=device),
            torch.zeros((Bq, P_PAGE), dtype=torch.int32, device=device))


def exact_scan_ref(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                   slotmap, tslot, treq, tneg, wshard, filtw=None,
                   carry=None):
    """The plain device exact scan: a loop over blocks rescores every
    bucket of the block (``_rescore_regions``, the same f32 chains as the
    host evaluation) and folds a running top-P_PAGE page, carried lanes
    before new ones on ties (a stable sort of carried | new), so a page is
    (score desc, lane asc).  carry: the page it starts from
    (initial_carry's when None).  Returns (page scores f32[Bq, P_PAGE],
    page lanes i32[Bq, P_PAGE] = bucket*32 + bit, matched count i32[Bq])."""
    dev = ppool.device
    Bq = tslot.shape[0]
    NBLK = sp_prow.shape[1]
    words = torch.arange(NW, dtype=torch.int32, device=dev)
    sel_all = torch.full((Bq, NW), float("inf"), device=dev)
    bs, bl = initial_carry(Bq, dev) if carry is None else carry
    fnd = torch.zeros(Bq, dtype=torch.int32, device=dev)
    for b in range(NBLK):
        ids = (words + b * NW).expand(Bq, NW)
        sc, lane, found = _rescore_regions(
            ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
            tslot, treq, tneg, wshard, ids, sel_all, filtw)
        psc, plane, _ = _page_topk(sc, lane)
        v, sel = _sort_desc(torch.cat([bs, psc], dim=1))
        bs = v[:, :P_PAGE]
        bl = torch.gather(torch.cat([bl, plane], dim=1), 1, sel[:, :P_PAGE])
        fnd = fnd + found
    return bs, bl, fnd


# ---------------------------------------------------------------------------
# K5's selections, restated in numpy


def page_select_ref(score, lane, trace: list | None = None):
    """K5's page in numpy over score f32[Bq, n] / lane i32[Bq, n] in
    candidate order (-inf: unmatched).  The matched candidates are listed
    in candidate order (their slots); with found <= SORTED the page is the
    list sorted by (score desc, slot asc), then, with found < P_PAGE, the
    first P_PAGE - found unmatched candidates in candidate order; else the
    select of the top-P_PAGE of the list (radix_topk_ref); n_ge is found
    where found <= P_PAGE, else the list's count of scores tying or
    beating the page's last entry.  Returns (psc, plane, n_ge) as
    _page_topk does.  `trace`, a list, receives a dict a query: found, and
    radix_topk_ref's trace where a select ran."""
    score = np.asarray(score, np.float32)
    lane = np.asarray(lane, np.int32)
    Bq = score.shape[0]
    psc = np.empty((Bq, P_PAGE), np.float32)
    plane = np.empty((Bq, P_PAGE), np.int32)
    n_ge = np.empty(Bq, np.int32)
    for q in range(Bq):
        matched = np.flatnonzero(score[q] > -np.inf)
        keys = desc_keys(score[q][matched])
        t = {"found": len(matched)}
        if len(matched) <= SORTED:
            order = matched[np.lexsort((np.arange(len(matched)), keys))]
            rest = np.flatnonzero(~(score[q] > -np.inf))
            sel = np.concatenate([order, rest])[:P_PAGE]
        else:
            sel = matched[radix_topk_ref(keys, P_PAGE, trace=t)]
        if len(matched) <= P_PAGE:
            n_ge[q] = len(matched)
        else:
            last = desc_keys(score[q][sel[-1:]])[0]
            n_ge[q] = int((keys <= last).sum())
        if trace is not None:
            trace.append(t)
        psc[q], plane[q] = score[q][sel], lane[q][sel]
    return psc, plane, n_ge


def split_count(n_buckets: int, Bq: int, sms: int) -> int:
    """Bucket ranges a query in the fold mode: about two CTAs an SM, at
    most one range a chunk and MAX_SPLITS in all."""
    chunks = -(-n_buckets // CHUNK)
    return max(1, min(MAX_SPLITS, chunks, (2 * sms) // max(Bq, 1)))


def exact_fold_ref(score, lane, carry, nsplit: int, chunk: int = CHUNK):
    """K5's fold mode in numpy over every bucket's rescored docs (score
    f32[Bq, nb*32] / lane i32[Bq, nb*32] in bucket order, -inf:
    unmatched): nsplit contiguous bucket ranges, each walked in chunks of
    `chunk` buckets with a running page; a chunk none of whose matched
    docs beats the running page's last entry is skipped, else the page
    becomes the top-P_PAGE (radix_topk_ref, cut at the last entry's key)
    of the page followed by the chunk's matched docs in candidate order;
    split 0 starts from carry (psc, plane), the others from -inf / lane 0;
    the ranges' pages are merged by one more selection in range order.
    Returns (psc, plane, found)."""
    score = np.asarray(score, np.float32)
    lane = np.asarray(lane, np.int32)
    c_psc, c_plane = [np.asarray(x) for x in carry]
    Bq, n = score.shape
    nb = n // 32
    per = -(-nb // nsplit)
    psc = np.empty((Bq, P_PAGE), np.float32)
    plane = np.empty((Bq, P_PAGE), np.int32)
    for q in range(Bq):
        parts_s, parts_l = [], []
        for s in range(nsplit):
            b0, b1 = min(s * per, nb), min(s * per + per, nb)
            ps = c_psc[q].astype(np.float32) if s == 0 else \
                np.full(P_PAGE, -np.inf, np.float32)
            pl = c_plane[q].astype(np.int32) if s == 0 else \
                np.zeros(P_PAGE, np.int32)
            for cb in range(b0, b1, chunk):
                ce = min(cb + chunk, b1)
                cs = score[q, cb * 32:ce * 32]
                hit = cs > -np.inf
                if not (cs[hit] > ps[-1]).any():
                    continue
                allv = np.concatenate([ps, cs[hit]])
                alll = np.concatenate([pl, lane[q, cb * 32:ce * 32][hit]])
                sel = radix_topk_ref(desc_keys(allv), P_PAGE,
                                     int(desc_keys(ps[-1:])[0]))
                ps, pl = allv[sel], alll[sel]
            parts_s.append(ps)
            parts_l.append(pl)
        allv = np.concatenate(parts_s)
        sel = radix_topk_ref(desc_keys(allv), P_PAGE)
        psc[q], plane[q] = allv[sel], np.concatenate(parts_l)[sel]
    found = (score > -np.inf).sum(axis=1).astype(np.int32)
    return psc, plane, found


# ---------------------------------------------------------------------------
# K5


def _pool_args(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
               tslot, treq, tneg, wshard, filtw):
    """Checks the pools and the batch tables K5 reads; returns their
    pointers in the C entry points' order and (NBLK, Bq, T)."""
    dev = ppool.device
    R = ppool.shape[0]
    V, NBLK = sp_prow.shape
    Bq, T = tslot.shape
    if not 1 <= T <= T_MAX:
        raise ValueError(f"K5 takes 1 to {T_MAX} columns, got {T}")
    if ipool.shape[0] < 1:
        raise ValueError("K5 needs a non-empty impact pool")
    _check("ppool", ppool, torch.int32, (R, NW), dev)
    _check("rpool", rpool, torch.int32, (R, NW), dev)
    _check("ipool", ipool, torch.float32, (ipool.shape[0],), dev)
    _check("sp_prow", sp_prow, torch.int32, (V, NBLK), dev)
    _check("sp_ioff", sp_ioff, torch.int32, (V, NBLK), dev)
    _check("delw", delw, torch.int32, (NBLK, NW), dev)
    _check("sid", sid, torch.int32, (NBLK,), dev)
    if filtw is not None:
        _check("filtw", filtw, torch.int32, (NBLK, NW), dev)
    _check("slotmap", slotmap, torch.int32, (slotmap.shape[0],), dev)
    _check("tslot", tslot, torch.int32, (Bq, T), dev)
    _check("treq", treq, torch.bool, (Bq, T), dev)
    _check("tneg", tneg, torch.bool, (Bq, T), dev)
    _check("wshard", wshard, torch.float32, (wshard.shape[0], Bq, T), dev)
    ptrs = (ppool.data_ptr(), rpool.data_ptr(), ipool.data_ptr(),
            ipool.shape[0], sp_prow.data_ptr(), sp_ioff.data_ptr(),
            delw.data_ptr(), sid.data_ptr(),
            None if filtw is None else filtw.data_ptr(), slotmap.data_ptr(),
            tslot.data_ptr(), treq.data_ptr(), tneg.data_ptr(),
            wshard.data_ptr())
    return ptrs, (NBLK, Bq, T)


def page_launcher(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                  slotmap, tslot, treq, tneg, wshard, ids, vals, filtw=None,
                  bucket_off: int = 0, lib=None):
    """K5's page mode on CUDA tensors, prepared: checks the inputs, makes
    the outputs and returns a function that launches K5 (from `lib`, by
    default the library built from csrc/wand_rescore.cu) into them and
    returns (psc, plane, n_ge, found) as rescore_page_ref does.  Each call
    of that function is one launch."""
    from .. import _build

    dev = ppool.device
    ptrs, (NBLK, Bq, T) = _pool_args(ppool, rpool, ipool, sp_prow, sp_ioff,
                                     delw, sid, slotmap, tslot, treq, tneg,
                                     wshard, filtw)
    K = ids.shape[1]
    if not 2 <= K <= K_MAX:
        raise ValueError(f"K5 takes 2 to {K_MAX} buckets a query, got {K}")
    ids = ids.to(torch.int32).contiguous()
    vals = vals.contiguous()
    _check("ids", ids, torch.int32, (Bq, K), dev)
    _check("vals", vals, torch.float32, (Bq, K), dev)
    out = (torch.empty((Bq, P_PAGE), dtype=torch.float32, device=dev),
           torch.empty((Bq, P_PAGE), dtype=torch.int32, device=dev),
           torch.empty(Bq, dtype=torch.int32, device=dev),
           torch.empty(Bq, dtype=torch.int32, device=dev))
    if lib is None:
        lib = _build.load("wand_rescore")
    args = (*ptrs, ids.data_ptr(), vals.data_ptr(), NBLK, Bq, T, K,
            int(bucket_off), *[x.data_ptr() for x in out],
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        _count_launch()
        with torch.cuda.device(dev):
            err = lib.rescore_page_launch(*args)
        if err != 0:
            raise RuntimeError(
                f"rescore_page_cuda launch failed (error {err})")
        return out
    return launch


def rescore_page_cuda(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                      slotmap, tslot, treq, tneg, wshard, ids, vals,
                      filtw=None, bucket_off: int = 0):
    """K5's page mode on CUDA tensors: the contract of rescore_page_ref."""
    return page_launcher(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                         slotmap, tslot, treq, tneg, wshard, ids, vals,
                         filtw, bucket_off)()


_SMS: dict = {}


def fold_launcher(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                  slotmap, tslot, treq, tneg, wshard, filtw=None, carry=None,
                  nsplit: int | None = None, lib=None):
    """K5's fold mode on CUDA tensors, prepared: checks the inputs, makes
    the outputs and returns a function that launches the fold (from `lib`,
    by default the library built from csrc/wand_rescore.cu) into them and
    returns (psc, plane, found) as exact_scan_ref does.  nsplit: bucket
    ranges a query (split_count's by default).  Each call of that function
    is one launch."""
    from .. import _build

    dev = ppool.device
    ptrs, (NBLK, Bq, T) = _pool_args(ppool, rpool, ipool, sp_prow, sp_ioff,
                                     delw, sid, slotmap, tslot, treq, tneg,
                                     wshard, filtw)
    if carry is not None:
        c_psc, c_plane = (x.contiguous() for x in carry)
        _check("carry scores", c_psc, torch.float32, (Bq, P_PAGE), dev)
        _check("carry lanes", c_plane, torch.int32, (Bq, P_PAGE), dev)
    if nsplit is None:
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        nsplit = split_count(NBLK * NW, Bq, _SMS[dev])
    if not 1 <= nsplit <= MAX_SPLITS:
        raise ValueError(f"K5 takes 1 to {MAX_SPLITS} splits, got {nsplit}")
    part = (torch.empty((Bq, nsplit, P_PAGE), dtype=torch.float32,
                        device=dev),
            torch.empty((Bq, nsplit, P_PAGE), dtype=torch.int32, device=dev),
            torch.empty((Bq, nsplit), dtype=torch.int32, device=dev))
    out = (torch.empty((Bq, P_PAGE), dtype=torch.float32, device=dev),
           torch.empty((Bq, P_PAGE), dtype=torch.int32, device=dev),
           torch.empty(Bq, dtype=torch.int32, device=dev))
    if lib is None:
        lib = _build.load("wand_rescore")
    args = (*ptrs, NBLK, Bq, T, nsplit,
            None if carry is None else c_psc.data_ptr(),
            None if carry is None else c_plane.data_ptr(),
            *[x.data_ptr() for x in part + out],
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        _count_launch()
        with torch.cuda.device(dev):
            err = lib.exact_fold_launch(*args)
        if err != 0:
            raise RuntimeError(f"exact_fold_cuda launch failed (error {err})")
        return out
    return launch


def exact_fold_cuda(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                    slotmap, tslot, treq, tneg, wshard, filtw=None,
                    carry=None, nsplit: int | None = None):
    """K5's fold mode on CUDA tensors: the contract of exact_scan_ref.
    nsplit: bucket ranges a query (split_count's by default)."""
    return fold_launcher(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid,
                         slotmap, tslot, treq, tneg, wshard, filtw, carry,
                         nsplit)()


def rescore_page(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
                 tslot, treq, tneg, wshard, ids, vals, filtw=None,
                 bucket_off: int = 0):
    """Phases 3-4 of one rung on one device: the plain version for tensors
    on the CPU, K5 for CUDA tensors (a CUDA failure raises; there is no
    fallback).  Returns (psc, plane, n_ge, found)."""
    fn = _route(ppool, rescore_page_ref, rescore_page_cuda)
    return fn(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
              tslot, treq, tneg, wshard, ids, vals, filtw, bucket_off)


def exact_fold(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
               tslot, treq, tneg, wshard, filtw=None, carry=None):
    """The device exact scan on one device: the plain loop for tensors on
    the CPU, K5's fold mode for CUDA tensors.  carry: a page (psc, plane)
    in page order to fold into, or None for initial_carry's.  Returns
    (psc, plane, found)."""
    fn = _route(ppool, exact_scan_ref, exact_fold_cuda)
    return fn(ppool, rpool, ipool, sp_prow, sp_ioff, delw, sid, slotmap,
              tslot, treq, tneg, wshard, filtw, carry)


def _route(x, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"no WAND rescore for device {x.device}")
