"""Phase 2 of the WAND route: kernel K6 (csrc/wand_rungs.cu) and its plain
PyTorch version, the rung selection.

Replaces the XLA programs ``seekstorm_tpu/ops/wand.py::_rung_topks`` (368)
and ``_topk_lanes`` (556).  For each query it selects the exact top-(K_SEL
+1) regions of the three rungs of the ladder: 32-doc buckets ranked by
their UB (allub), and 128- and 512-doc regions ranked by the UB maxima over
4 and 16 buckets (ub4, ub16).  ``_topk_lanes`` ranks in two stages over
128-lane groups, and its order is part of the contract: values desc, then
the group's rank in the stable descending sort of the group maxima, then
the lane within the group.

K6 takes one CTA a (query, rung): it orders the groups by their maxima,
takes a cut that at least K_SEL+1 lanes reach, keeps the lanes under the
cut in order and sorts them in one warp, reading a rung's lanes straight
from allub / ub4 / ub16; where the cut leaves too many lanes it runs the
select of csrc/topk_select.cuh (a histogram pass over the keys' leading 11
bits, then a compaction pass in candidate order).  ``radix_topk_ref`` and
``rung_select_ref`` restate that procedure in numpy, pass for pass, so the
CPU tests can hold the kernel's algorithm against ``_topk_lanes``; the
kernel itself meets its plain version on the card (chip_smoke.py).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..metrics import METRICS
from .wand_scan import _check

K_SEL = 64                     # selected regions per query per rung
KP = K_SEL + 1                 # entries a rung returns
GROUP = 128                    # lanes of a stage-1 group
# the most stage-1 groups of a rung (L1 / 128), which K6 may reduce into
# shared memory
MAX_CAND = KP * GROUP

# launches of K6 since the last reset (the count a run reads to show that
# its main path went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K6 launch: in LAUNCHES and in METRICS' k6_launches_total."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k6_launches_total")


# ---------------------------------------------------------------------------
# plain version


def _sort_desc(x):
    """Descending sort that keeps the lower index first on ties."""
    return torch.sort(x, dim=1, descending=True, stable=True)


def _topk_lanes(x, K: int, gmax=None):
    """Exact top-K (values desc, -inf padded, ties to the lower index
    within the candidate order) over x[Bq, L] by a two-stage 128-lane
    group reduction; region ids returned alongside as int32."""
    Bq, L = x.shape
    K_eff = min(K, L)
    G = min(GROUP, L)
    ng = L // G
    if gmax is None:
        gmax = x.reshape(Bq, ng, G).amax(dim=2)
    kg = min(K_eff, ng)
    gi = _sort_desc(gmax)[1][:, :kg]                        # [Bq, kg]
    cand = torch.gather(x.reshape(Bq, ng, G), 1,
                        gi[:, :, None].expand(Bq, kg, G))
    vals, ti = _sort_desc(cand.reshape(Bq, kg * G))
    vals, ti = vals[:, :K_eff], ti[:, :K_eff]
    gsel = torch.gather(gi, 1, ti // G)
    ids = (gsel * G + ti % G).to(torch.int32)
    if K_eff < K:
        pad = K - K_eff
        vals = torch.cat([vals, torch.full((Bq, pad), float("-inf"),
                                           device=x.device)], dim=1)
        ids = torch.cat([ids, torch.zeros((Bq, pad), dtype=torch.int32,
                                          device=x.device)], dim=1)
    return vals, ids


def _pool(x, f: int):
    Bq, L = x.shape
    return x.reshape(Bq, L // f, f).amax(dim=2)


def _rung_topks(allub, NBLK: int, maxima=None):
    """Phase 2: per coarsening factor F (1, 4, 16), the exact top-(K_SEL+1)
    regions (ub f32[Bq, K_SEL+1] desc with -inf padding, region id i32).
    The coarse rungs rank the maxima (ub4, ub16, g1) phase 1 returns with
    allub (L1 = NBLK * NW); without them they are reduced from allub here
    (any L1 a multiple of 16; below 128 a group is the whole row).  Rung 1
    reads allub only in its K_SEL+1 selected 128-bucket groups."""
    if maxima is None:
        ub4 = _pool(allub, 4)
        ub16 = _pool(ub4, 4)
        g1 = None
    else:
        ub4, ub16, g1 = maxima
    return [_topk_lanes(allub, KP, gmax=g1),
            _topk_lanes(ub4, KP),
            _topk_lanes(ub16, KP)]


# ---------------------------------------------------------------------------
# K6's selection, restated in numpy


def desc_keys(x) -> np.ndarray:
    """csrc/topk_select.cuh's desc_key: a u32 key that is smaller for a
    larger float, -0 with +0's key."""
    b = np.array(x, np.float32).view(np.uint32)
    b[b == 0x80000000] = 0
    order = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return ~order


# the select's digit levels (shift, mask): 11, 11 and 10 bits of the key
LEVELS = ((21, 0x7FF), (10, 0x7FF), (0, 0x3FF))
BINS = 2048                    # bins of a histogram pass
KMAX = 72                      # most entries a selection returns
KEPT = 128                     # most candidates a selection sorts


def _pick_bin(hist, rem: int):
    """The digit whose bin holds the rem-th candidate (1-based), the rank
    within it and the bin's count."""
    cum = np.cumsum(hist)
    d = int(np.searchsorted(cum, rem))
    return d, rem - int(cum[d] - hist[d]), int(hist[d])


def radix_topk_ref(keys, k: int, cut: int = 0xFFFFFFFF,
                   trace: dict | None = None) -> np.ndarray:
    """select_topk of csrc/topk_select.cuh over one row: the indices of the
    k smallest (key, index) pairs in that order.  Pass for pass: a
    histogram of the live keys' leading 11 bits finds the bin of the k-th
    candidate and the rank r it needs there; a compaction pass keeps, in
    candidate order, the candidates below that bin and the bin's first
    KEPT, and the bin's least and largest key; a bin that keeps at most
    KEPT candidates with those below it, or of one key (then its first r
    in candidate order win), ends the search, else the next 11 bits (then
    the last 10) of the bin's keys refine it; the kept candidates are
    sorted by (key, index).  Keys above `cut` are skipped (at least k must
    not be).  `trace`, a dict, receives the level that ended the search,
    whether it ended on a bin of one key that overflowed, and how many
    candidates were sorted."""
    keys = np.asarray(keys, np.uint32)
    assert 1 <= k <= KMAX
    idx = np.arange(len(keys), dtype=np.int64)
    live = keys <= np.uint32(cut)
    prefix = mask = 0
    rem = k
    for level, (shift, dmask) in enumerate(LEVELS):
        m = live & ((keys & np.uint32(mask)) == np.uint32(prefix))
        hist = np.bincount((keys[m] >> np.uint32(shift)) & dmask,
                           minlength=BINS)
        d, rem, eq = _pick_bin(hist, rem)
        prefix |= d << shift
        mask |= dmask << shift
        lo, hi = np.uint32(prefix), np.uint32(prefix | (~mask & 0xFFFFFFFF))
        below = idx[live & (keys < lo)]
        inbin = idx[live & (keys >= lo) & (keys <= hi)]
        assert len(below) == k - rem < KMAX and len(inbin) == eq
        single = keys[inbin].min() == keys[inbin].max()
        whole = len(below) + eq <= KEPT
        if whole or single:
            take = eq if whole else rem
            kept = np.concatenate([below, inbin[:take]])
            if trace is not None:
                trace.update(level=level, tie_overflow=not whole,
                             sorted=len(kept))
            return kept[np.lexsort((kept, keys[kept]))][:k]
    raise AssertionError("a bin of the last level holds one key")


KEY_NEG_INF = 0xFF800000       # desc_keys(-inf)
SUB = 16                       # lanes of a sub-group
LIST = 512                     # lanes under a cut K6 keeps in order


def bin_cut_ref(keys, k: int) -> int:
    """topk_select.cuh's bin_cut: the largest key of the bin of the keys'
    first 22 bits that holds the k-th smallest key (a histogram of the
    first 11 bits, then of the next 11 of that bin's keys)."""
    keys = np.asarray(keys, np.uint32)
    d, rem, _ = _pick_bin(np.bincount(keys >> 21, minlength=BINS), k)
    mine = keys[(keys >> 21) == d]
    d2, _, _ = _pick_bin(np.bincount((mine >> 10) & 0x7FF, minlength=BINS),
                         rem)
    return (d << 21) | (d2 << 10) | 0x3FF


def rung_select_ref(allub, maxima=None, trace: list | None = None):
    """K6's two stages in numpy over allub f32[Bq, L1] (and phase 1's
    maxima (ub4, ub16, g1), or None): [(vals f32[Bq, 65], ids
    i32[Bq, 65])] x 3, as _rung_topks returns them.  Stage 1 orders every
    group by one sort where all are selected (kg = ng), else selects kg of
    them (radix_topk_ref).  The cut is the kg-th group maximum where kg =
    65, else the top of the 22-bit bin that holds the 65th largest
    maximum of the rung's 16-lane sub-groups (bin_cut_ref) where K6
    reduces the rung's group maxima itself (rungs 2 and 3; rung 1 without
    phase 1's maxima) and it has 65 sub-groups or more, else none.
    Stage 2 reads the groups whose maximum is not below the cut, less
    those of -inf lanes only, but enough for 65 lanes.  Under a finite cut
    it keeps their lanes under the cut in order: at most KEPT are sorted,
    at most LIST selected (radix_topk_ref); else, and without a finite
    cut, it selects from all their lanes.  `trace`, a list, receives a
    dict a (rung, query) stage 2: the path ("sort", "list" or "select",
    with radix_topk_ref's trace), the rung, whether it had a cut and
    whether that was finite, the lanes under it, and the groups it read of
    kg."""
    x = np.asarray(allub, np.float32)
    Bq, L1 = x.shape
    if maxima is None:
        ub4 = x.reshape(Bq, L1 // 4, 4).max(axis=2)
        rows = [(x, None), (ub4, None),
                (ub4.reshape(Bq, L1 // 16, 4).max(axis=2), None)]
    else:
        ub4, ub16, g1 = [np.asarray(m, np.float32) for m in maxima]
        rows = [(x, g1), (ub4, None), (ub16, None)]
    out = []
    for r, (xr, gm) in enumerate(rows):
        L = xr.shape[1]
        G = min(GROUP, L)
        ng = L // G
        keff = min(KP, L)
        kg = min(keff, ng)
        # K6 reads sub-group maxima where it reduces a rung's own lanes
        # (phase 1's maxima given, or rung 1) with 16-byte loads, which it
        # always takes there (its rows start on 16 bytes: rungs_launcher)
        subs = (gm is None and kg < keff and G == GROUP
                and L // SUB >= keff and (maxima is not None or r == 0))
        if gm is None:
            gm = xr.reshape(Bq, ng, G).max(axis=2)
        vals = np.full((Bq, KP), -np.inf, np.float32)
        ids = np.zeros((Bq, KP), np.int32)
        for q in range(Bq):
            gk = desc_keys(gm[q])
            if kg == ng:
                gsel = np.lexsort((np.arange(ng), gk))
            else:
                gsel = radix_topk_ref(gk, kg)
            gkey = gk[gsel]
            cut = 0xFFFFFFFF
            if kg == keff:
                cut = int(gkey[kg - 1])
            elif subs:
                cut = bin_cut_ref(
                    desc_keys(xr[q].reshape(-1, SUB).max(axis=1)), keff)
            ngk = int(((gkey <= cut) & (gkey < KEY_NEG_INF)).sum())
            ngk = min(max(ngk, -(-keff // G)), kg)
            cand = xr[q].reshape(ng, G)[gsel[:ngk]].reshape(-1)
            ck = desc_keys(cand)
            t = {}
            kept = np.flatnonzero(ck <= cut)
            if cut < KEY_NEG_INF and len(kept) <= KEPT:
                t["path"] = "sort"
                sel = kept[np.lexsort((kept, ck[kept]))][:keff]
            elif cut < KEY_NEG_INF and len(kept) <= LIST:
                t["path"] = "list"
                sel = kept[radix_topk_ref(ck[kept], keff, trace=t)]
            else:
                t["path"] = "select"
                sel = radix_topk_ref(ck, keff, cut, t)
            if trace is not None:
                trace.append(dict(t, rung=r, cut=cut != 0xFFFFFFFF,
                                  finite=cut < KEY_NEG_INF, kept=len(kept),
                                  groups=ngk, kg=kg))
            vals[q, :keff] = cand[sel]
            ids[q, :keff] = gsel[sel // G] * G + sel % G
        out.append((vals, ids))
    return out


# ---------------------------------------------------------------------------
# K6


def _aligned(x):
    """x, or a copy of it where its data does not start on 16 bytes (K6
    reads a rung's rows as float4s)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def rungs_launcher(allub, maxima=None, lib=None):
    """K6 on CUDA tensors, prepared: checks the inputs, makes the outputs
    and returns a function that launches K6 (from `lib`, by default the
    library built from csrc/wand_rungs.cu) into them and returns the
    contract of _rung_topks.  Each call of that function is one launch."""
    from .. import _build

    dev = allub.device
    Bq, L1 = allub.shape
    if L1 < 16 or L1 % 16 or L1 // GROUP > MAX_CAND or any(
            (L1 >> (2 * r)) % min(GROUP, L1 >> (2 * r)) for r in range(3)):
        raise ValueError(f"K6 takes no allub of {L1} buckets")
    _check("allub", allub, torch.float32, (Bq, L1), dev)
    if maxima is not None:
        if L1 % GROUP:
            raise ValueError("phase 1's maxima need L1 a multiple of 128")
        ub4, ub16, g1 = maxima
        _check("ub4", ub4, torch.float32, (Bq, L1 // 4), dev)
        _check("ub16", ub16, torch.float32, (Bq, L1 // 16), dev)
        _check("g1", g1, torch.float32, (Bq, L1 // GROUP), dev)
        ub4, ub16 = _aligned(ub4), _aligned(ub16)
    allub = _aligned(allub)
    vals = torch.empty((3, Bq, KP), dtype=torch.float32, device=dev)
    ids = torch.empty((3, Bq, KP), dtype=torch.int32, device=dev)
    if lib is None:
        lib = _build.load("wand_rungs")
    args = (allub.data_ptr(),
            *((None, None, None) if maxima is None else
              (g1.data_ptr(), ub4.data_ptr(), ub16.data_ptr())),
            L1, Bq, vals.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        _count_launch()
        with torch.cuda.device(dev):
            err = lib.wand_rungs_launch(*args)
        if err != 0:
            raise RuntimeError(f"wand_rungs_cuda launch failed (error {err})")
        return [(vals[r], ids[r]) for r in range(3)]
    return launch


def wand_rungs_cuda(allub, maxima=None):
    """K6 on CUDA tensors: the same contract as _rung_topks."""
    return rungs_launcher(allub, maxima)()


def rung_topks(allub, NBLK: int, maxima=None):
    """Phase 2: the plain version for tensors on the CPU, K6 for CUDA
    tensors (a CUDA failure raises; there is no fallback)."""
    if allub.device.type == "cpu":
        return _rung_topks(allub, NBLK, maxima)
    if allub.device.type == "cuda":
        return wand_rungs_cuda(allub, maxima)
    raise ValueError(f"no rung selection for device {allub.device}")
