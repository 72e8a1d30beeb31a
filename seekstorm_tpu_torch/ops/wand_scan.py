"""Phase-1 bucket-WAND scan: kernel K1 (csrc/wand_scan.cu) and its plain
PyTorch version, with phase 2's rung maxima in the epilogue.

Replaces the TPU kernel ``seekstorm_tpu/ops/wand_pallas.py::scan_blocks``
(body ``_kernel``, the ``pl.pallas_call`` at wand_pallas.py:247) and the XLA
step of ``seekstorm_tpu/ops/wand.py::_scan_local`` for score-mode batches.

For each query and each u32 word (32-doc bucket) of every block it computes
the matched words ``AND(req) & OR(pos) & ~OR(neg) & ~deleted & ~filter``,
the exact match count by popcount, and the bucket upper bound: the max over
presence classes of the first ``min(T, 3)`` positive columns plus the
residual ``sum w_t * bucketmax_t`` of the later columns, accumulated in
ascending column order; ``-inf`` where nothing matched.  Beside the UBs it
returns the maxima phase 2 ranks regions by (``rung_maxima``): over 4, 16
and 128 consecutive buckets.

What bounds it on the card is bytes: each (query, block, word) reads T
presence and up to T bucket-max words and writes one f32 UB and its share
of the maxima.  K1 gives each thread 4 consecutive words (16-byte loads and
stores), stages a query tile's pool rows in shared memory with cp.async
while the previous query computes, keeps every per-word intermediate in
registers, reads pool rows by index inside the kernel (no ``[NBLK, V, NW]``
pre-gather), and reduces the maxima with warp shuffles.  Its UB chains
round twice per term (``__fmul_rn``/``__fadd_rn``), exactly as the separate
torch mul and add below, and a max is exact, so K1 is bit-exact against
``scan_blocks_ref`` in all five outputs.  With ``with_matched`` both return
the matched words themselves as a sixth output, i32[Bq, NBLK*NW]: the facet
histogram (``ops/facet_hist.py``, kernel K3) counts from them, and
rank-by-key batches mask their sort-key bounds with them.

u32 words are carried as int32 bit patterns: ``torch.uint32`` has no
``>>``, ``~`` or comparisons on the CPU.  ``int32 >>`` is arithmetic, so
every shift is masked.
"""

from __future__ import annotations

import threading

import torch

from ..metrics import METRICS
from ..schema import BLOCK_SIZE

NW = BLOCK_SIZE // 32          # words (32-doc buckets) per 64K-doc block
T_TIERS = (2, 4, 8)            # slot-column counts K1 is compiled for

# launches of K1 since the last reset (the count a run reads to show that
# its main path went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K1 launch: in LAUNCHES and in METRICS' k1_launches_total
    (a server's /metrics shows which kernels its requests ran)."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k1_launches_total")


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR bit trick in int64,
    so no step overflows).  Returns int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def tcodes(tslot, treq, tneg) -> torch.Tensor:
    """Packed per-(query, column) code: slot*4 | required*2 | negated, and
    -4 for an unused column (slot -1, both flags 0)."""
    code = tslot * 4 + 2 * treq.to(torch.int32) + tneg.to(torch.int32)
    return torch.where(tslot >= 0, code, torch.full_like(tslot, -4))


def rung_maxima(allub):
    """Phase 2's rung maxima of allub f32[Bq, L1] (L1 a multiple of 128):
    ub4 f32[Bq, L1/4] and ub16 f32[Bq, L1/16], the maxima over 4 and 16
    consecutive buckets, and g1 f32[Bq, L1/128], over 128 (the rung-1 lane
    groups of ops/wand._topk_lanes)."""
    Bq, L1 = allub.shape
    ub4 = allub.reshape(Bq, L1 // 4, 4).amax(dim=2)
    ub16 = ub4.reshape(Bq, L1 // 16, 4).amax(dim=2)
    g1 = ub4.reshape(Bq, L1 // 128, 32).amax(dim=2)
    return ub4, ub16, g1


def scan_blocks_ref(ppool, vpool, prow, delw, filtw, tslot, treq, tneg,
                    wshard, sid, *, with_counts: bool = True,
                    with_matched: bool = False):
    """Plain PyTorch phase-1 scan.

    ppool i32[PR, NW] presence words / vpool f32[PR, NW] bucket maxima;
    prow i32[NBLK, V] pool row per (block, batch slot), -1 when absent;
    delw / filtw i32[NBLK, NW] deleted / disallowed words (filtw None for
    no filter); tslot i32[Bq, T], treq / tneg bool[Bq, T]; wshard
    f32[S, Bq, T] per-shard weights and sid i32[NBLK] the shard of each
    block.  Returns (allub f32[Bq, NBLK*NW], cnt i32[Bq] (zeros unless
    with_counts), ub4, ub16, g1) with the maxima of rung_maxima(allub), and
    with_matched the matched words i32[Bq, NBLK*NW] as a sixth."""
    NBLK = prow.shape[0]
    Bq, T = tslot.shape
    NC = min(T, 3)
    dev = ppool.device
    ninf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    notdel = ~delw
    if filtw is not None:
        notdel = notdel & ~filtw
    used = tslot >= 0
    req_pos = treq & ~tneg & used
    pos = used & ~tneg
    neg = used & tneg
    w_blk = wshard[sid.long()]                     # [NBLK, Bq, T]

    pres, bval = [], []
    andw = torch.full((Bq, NBLK, NW), -1, dtype=torch.int32, device=dev)
    posw = torch.zeros((Bq, NBLK, NW), dtype=torch.int32, device=dev)
    negw = torch.zeros((Bq, NBLK, NW), dtype=torch.int32, device=dev)
    for t in range(T):
        s_c = tslot[:, t].clamp(min=0).long()
        rowid = prow[:, s_c].T                     # [Bq, NBLK]
        okp = (used[:, t, None] & (rowid >= 0))[:, :, None]
        rows = rowid.clamp(min=0).long()
        p = torch.where(okp, ppool[rows], zero_i)  # [Bq, NBLK, NW]
        score_ok = okp & ~tneg[:, t, None, None]
        w_t = torch.where(score_ok, w_blk[:, :, t].T[:, :, None], zero_f)
        v = torch.where(score_ok, vpool[rows], zero_f)
        pres.append(p)
        bval.append(w_t * v)
        andw = torch.where(req_pos[:, t, None, None], andw & p, andw)
        posw = posw | torch.where(pos[:, t, None, None], p, zero_i)
        negw = negw | torch.where(neg[:, t, None, None], p, zero_i)
    matched = andw & posw & ~negw & notdel[None]
    if with_counts:
        cnt = popcount32(matched).sum(dim=(1, 2), dtype=torch.int32)
    else:
        cnt = torch.zeros(Bq, dtype=torch.int32, device=dev)

    best = torch.full((Bq, NBLK, NW), float("-inf"), device=dev)
    for c in range(1, 1 << NC):
        mm = okc = sc = None
        for t in range(NC):
            if (c >> t) & 1:
                mm = pres[t] if mm is None else mm & pres[t]
                sc = bval[t] if sc is None else sc + bval[t]
            else:
                mm = ~pres[t] if mm is None else mm & ~pres[t]
                nr = ~req_pos[:, t]
                okc = nr if okc is None else okc & nr
        for t in range(NC, T):
            sc = sc + bval[t]
        live = mm != 0
        if okc is not None:
            live = live & okc[:, None, None]
        best = torch.maximum(best, torch.where(live, sc, ninf))
    allub = torch.where(matched != 0, best, ninf).reshape(Bq, NBLK * NW)
    out = (allub, cnt, *rung_maxima(allub))
    if with_matched:
        out += (matched.reshape(Bq, NBLK * NW),)
    return out


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                         f"{x.dtype}{list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wand_scan_cuda(ppool, vpool, prow, delw, filtw, tslot, treq, tneg,
                   wshard, sid, *, with_counts: bool = True,
                   with_matched: bool = False):
    """K1 on CUDA tensors: same contract as scan_blocks_ref."""
    from .. import _build

    dev = ppool.device
    NBLK, V = prow.shape
    Bq, T = tslot.shape
    if T not in T_TIERS:
        raise ValueError(f"K1 takes T in {T_TIERS}, got {T}")
    PR = ppool.shape[0]
    S = wshard.shape[0]
    _check("ppool", ppool, torch.int32, (PR, NW), dev)
    _check("vpool", vpool, torch.float32, (PR, NW), dev)
    _check("prow", prow, torch.int32, (NBLK, V), dev)
    _check("delw", delw, torch.int32, (NBLK, NW), dev)
    if filtw is not None:
        _check("filtw", filtw, torch.int32, (NBLK, NW), dev)
    _check("wshard", wshard, torch.float32, (S, Bq, T), dev)
    _check("sid", sid, torch.int32, (NBLK,), dev)
    tcode = tcodes(tslot, treq, tneg).to(torch.int32).contiguous()
    _check("tcode", tcode, torch.int32, (Bq, T), dev)
    # K1 reads these 16 bytes at a time
    for name, x in (("ppool", ppool), ("vpool", vpool), ("delw", delw),
                    ("filtw", filtw)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")

    L1 = NBLK * NW
    allub = torch.empty((Bq, L1), dtype=torch.float32, device=dev)
    ub4 = torch.empty((Bq, L1 // 4), dtype=torch.float32, device=dev)
    ub16 = torch.empty((Bq, L1 // 16), dtype=torch.float32, device=dev)
    g1 = torch.empty((Bq, L1 // 128), dtype=torch.float32, device=dev)
    cnt = torch.zeros(Bq, dtype=torch.int32, device=dev)
    mwords = torch.empty((Bq, L1), dtype=torch.int32, device=dev) \
        if with_matched else None
    lib = _build.load("wand_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    with torch.cuda.device(dev):
        err = lib.wand_scan_launch(
            ppool.data_ptr(), vpool.data_ptr(), prow.data_ptr(), V,
            delw.data_ptr(), filtw.data_ptr() if filtw is not None else None,
            tcode.data_ptr(), wshard.data_ptr(), sid.data_ptr(), Bq, NBLK,
            T, int(with_counts), allub.data_ptr(), ub4.data_ptr(),
            ub16.data_ptr(), g1.data_ptr(), cnt.data_ptr(),
            mwords.data_ptr() if with_matched else None, stream)
    if err != 0:
        raise RuntimeError(f"wand_scan_cuda launch failed (error {err})")
    if with_matched:
        return allub, cnt, ub4, ub16, g1, mwords
    return allub, cnt, ub4, ub16, g1


def scan_blocks(ppool, vpool, prow, delw, filtw, tslot, treq, tneg, wshard,
                sid, *, with_counts: bool = True, with_matched: bool = False):
    """Phase 1: the plain version for tensors on the CPU, K1 for CUDA
    tensors (a CUDA failure raises; there is no fallback)."""
    if ppool.device.type == "cpu":
        return scan_blocks_ref(ppool, vpool, prow, delw, filtw, tslot, treq,
                               tneg, wshard, sid, with_counts=with_counts,
                               with_matched=with_matched)
    if ppool.device.type == "cuda":
        return wand_scan_cuda(ppool, vpool, prow, delw, filtw, tslot, treq,
                              tneg, wshard, sid, with_counts=with_counts,
                              with_matched=with_matched)
    raise ValueError(f"no phase-1 scan for device {ppool.device}")
