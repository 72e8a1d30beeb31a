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

K6 takes one CTA a (query, rung) and selects both stages in shared memory
with a radix select (csrc/topk_select.cuh).  ``radix_topk_ref`` and
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
# stage 2's most candidates (K6 keeps them in shared memory), which also
# caps the stage-1 groups of a rung: L1 / 128 <= 8,320
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


def _pick_bin(hist, rem: int):
    """The digit whose bin holds the rem-th candidate (1-based), the rank
    within it and the bin's count."""
    cum = np.cumsum(hist)
    d = int(np.searchsorted(cum, rem))
    return d, rem - int(cum[d] - hist[d]), int(hist[d])


def radix_topk_ref(keys, k: int, cut: int = 0xFFFFFFFF) -> np.ndarray:
    """select_topk of csrc/topk_select.cuh over one row: the indices of the
    k smallest (key, index) pairs in that order, found by four byte passes
    over the keys and, where the k-th key's class is cut, two over the
    indices.  Keys above `cut` are skipped (at least k must not be)."""
    keys = np.asarray(keys, np.uint32)
    idx = np.arange(len(keys), dtype=np.int64)
    live = keys <= np.uint32(cut)
    prefix = mask = 0
    rem, eq = k, 0
    for shift in (24, 16, 8, 0):
        m = live & ((keys & np.uint32(mask)) == np.uint32(prefix))
        hist = np.bincount((keys[m] >> np.uint32(shift)) & 0xFF,
                           minlength=256)
        d, rem, eq = _pick_bin(hist, rem)
        prefix |= d << shift
        mask |= 0xFF << shift
    ilim = len(keys)
    if rem < eq:
        ipre = imask = 0
        for shift in (8, 0):
            m = (keys == np.uint32(prefix)) & ((idx & imask) == ipre)
            hist = np.bincount((idx[m] >> shift) & 0xFF, minlength=256)
            d, rem, _ = _pick_bin(hist, rem)
            ipre |= d << shift
            imask |= 0xFF << shift
        ilim = ipre
    win = idx[(keys < np.uint32(prefix))
              | ((keys == np.uint32(prefix)) & (idx <= ilim))]
    assert len(win) == k
    return win[np.lexsort((win, keys[win]))]


def rung_select_ref(allub, maxima=None):
    """K6's two stages in numpy over allub f32[Bq, L1] (and phase 1's
    maxima (ub4, ub16, g1), or None): [(vals f32[Bq, 65], ids
    i32[Bq, 65])] x 3, as _rung_topks returns them."""
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
    for xr, gm in rows:
        L = xr.shape[1]
        G = min(GROUP, L)
        ng = L // G
        keff = min(KP, L)
        kg = min(keff, ng)
        if gm is None:
            gm = xr.reshape(Bq, ng, G).max(axis=2)
        vals = np.full((Bq, KP), -np.inf, np.float32)
        ids = np.zeros((Bq, KP), np.int32)
        for q in range(Bq):
            gsel = radix_topk_ref(desc_keys(gm[q]), kg)
            cut = int(desc_keys(gm[q][gsel[kg - 1:kg]])[0]) \
                if kg == keff else 0xFFFFFFFF
            cand = xr[q].reshape(ng, G)[gsel].reshape(-1)
            sel = radix_topk_ref(desc_keys(cand), keff, cut)
            vals[q, :keff] = cand[sel]
            ids[q, :keff] = gsel[sel // G] * G + sel % G
        out.append((vals, ids))
    return out


# ---------------------------------------------------------------------------
# K6


def wand_rungs_cuda(allub, maxima=None):
    """K6 on CUDA tensors: the same contract as _rung_topks."""
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
    vals = torch.empty((3, Bq, KP), dtype=torch.float32, device=dev)
    ids = torch.empty((3, Bq, KP), dtype=torch.int32, device=dev)
    lib = _build.load("wand_rungs")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    with torch.cuda.device(dev):
        err = lib.wand_rungs_launch(
            allub.data_ptr(),
            *((None, None, None) if maxima is None else
              (g1.data_ptr(), ub4.data_ptr(), ub16.data_ptr())),
            L1, Bq, vals.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wand_rungs_cuda launch failed (error {err})")
    return [(vals[r], ids[r]) for r in range(3)]


def rung_topks(allub, NBLK: int, maxima=None):
    """Phase 2: the plain version for tensors on the CPU, K6 for CUDA
    tensors (a CUDA failure raises; there is no fallback)."""
    if allub.device.type == "cpu":
        return _rung_topks(allub, NBLK, maxima)
    if allub.device.type == "cuda":
        return wand_rungs_cuda(allub, maxima)
    raise ValueError(f"no rung selection for device {allub.device}")
