"""Dense impact-path block scan: kernel K2 (csrc/dense_scan.cu) and its
plain PyTorch versions.

Replaces the XLA program ``seekstorm_tpu/ops/lexical.py::_block_step_imp``
(363-476), as ``lexical_scan_imp`` (486-565) and ``lexical_scan_qt``
(592-667) run it, the per-block match count of ``lexical_scan_imp``
(530-531) and the per-block top-k ``_topk_block`` (327-360).

It scores a (block, query) pair list (``plan.DensePlan``): for each pair and
each of the block's 65,536 docs,

    S = fma(wb, sat1, c),  c = fma chain of w_t * imp_t over the
        CSR-remainder postings in ascending slot id, wb = the sum of w_t
        over the bitmap slots with the doc's bit set

which is how the reference's ``W @ D + (W_b @ E) * sat1`` rounds on the CPU
(its matmul is a fused multiply-add chain over the slots, and the bitmap
term fuses too).  Required slots count hits, negated slots flag them, and

    matched = S > 0 & hits >= nreq & ~negated & ~deleted

gives ``cnt[q] += popcount(matched)`` and, by mode:

  * fused (``dense_topk``, kk <= KMAX): each pair's exact top-kk matched
    docs by (score desc, doc asc), -inf with doc -1 past the last match;
    no per-doc score leaves the kernel;
  * unfused (``dense_scan``): the masked score of every doc (-inf where
    unmatched), whose top-k the caller takes (``topk_block``); for kk >
    KMAX, deep pages, and for sorted results, which rank a matched doc by
    its sort key (``topk_tiles`` with ``rank``) and not by its score.

Both modes are one kernel source; K2 and the plain versions are bitwise
equal.  With ``with_matched`` either mode also returns the packed matched
words i32[P, NWORDS], which the facet histogram (``ops/facet_hist.py``,
kernel K3) counts from.

Device layout: docids are u16 bit patterns in int16, bitmap and delete
words u32 bit patterns in int32 (torch has no u32 shifts on the CPU).
"""

from __future__ import annotations

import threading

import torch

from ..metrics import METRICS
from ..plan import FLAG_NEG, FLAG_REQ
from ..schema import BLOCK_SIZE
from .wand_scan import _check

NWORDS = BLOCK_SIZE // 32      # u32 words per block bitmap
MAX_SLOTS = 127                # K2 counts required hits in 7 bits
KMAX = 128                     # the fused mode's largest kk
SPLITS = (1, 2, 4, 8)          # CTAs (one cluster) a pair, fused mode
# a launch of fewer pairs than SPLIT_BELOW_SMS times the card's SMs gives
# each pair a cluster of SMALL_SPLIT CTAs; a larger one, one CTA a pair
SPLIT_BELOW_SMS = 2
SMALL_SPLIT = 4
# pairs a tile of masked scores: 256 MB (256 KB a pair)
TILE_PAIRS = 1024
CHUNK = 128                    # docs per bucket of the two-stage top-k
TOPK_BUCKETS = BLOCK_SIZE // CHUNK

# launches of K2, in either mode, since the last reset (the count a run
# reads to show that its dense path went through the kernel)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more K2 launch: in LAUNCHES and in METRICS' k2_launches_total
    (a server's /metrics shows which kernels its requests ran)."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    METRICS.inc("k2_launches_total")

_BIT = torch.arange(32, dtype=torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern words [..., n] -> bool [..., n*32] (bit j of word i
    is doc i*32 + j)."""
    bits = (words[..., None] >> _BIT.to(words.device)) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32) != 0


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n*32] -> int32 bit-pattern words [..., n], the inverse of
    unpack_words."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32)
    w = (b.to(torch.int64) << _BIT.to(bits.device).long()).sum(dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add a*b + c (what __fmaf_rn
    computes).  The product is exact in f64; the f64 sum is rounded to odd
    (TwoSum gives its exact error), and a round-to-odd result at 53 bits
    rounds to the nearest f32 as the exact sum would."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    bits = s.view(torch.int64)
    # inexact with an even last bit: step one ulp toward the exact value
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def segment_positions(s_off, s_len):
    """The postings of P ranges laid end to end: s_off i64[P] / s_len
    i32[P] -> (pid i64[n] the range of each posting, pos i64[n] its place
    in the posting arrays), or None when every range is empty."""
    ln = s_len.long()
    tot = int(ln.sum())
    if not tot:
        return None
    pid = torch.repeat_interleave(torch.arange(len(ln), device=ln.device), ln)
    first = torch.cumsum(ln, 0) - ln
    return pid, s_off[pid] + torch.arange(tot, device=ln.device) - first[pid]


def dense_scan_ref(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                   s_off, s_len, s_bm, s_w, s_flag, n_queries: int,
                   with_matched: bool = False):
    """Plain PyTorch block scan over P pairs.

    docid i16[Pc] (u16 bits) / imp f32[Pc] the CSR remainder; bitmaps
    i32[NBM, NWORDS]; sat1 f32[NBLK*BLOCK_SIZE]; delw i32[NBLK, NWORDS]
    deleted-doc words; p_blk / p_q / p_nreq i32[P] global block, batch row
    and required-slot count of each pair; s_off i64 / s_len i32 / s_bm i32
    / s_w f32 / s_flag i32 [P, T] per (pair, slot).  Returns (scores
    f32[P, BLOCK_SIZE] with -inf where unmatched, cnt i32[n_queries]), and
    with_matched the matched words i32[P, NWORDS] as a third."""
    dev = imp.device
    P, T = s_len.shape
    score = torch.zeros((P, BLOCK_SIZE), dtype=torch.float32, device=dev)
    req = torch.zeros((P, BLOCK_SIZE), dtype=torch.int32, device=dev)
    neg = torch.zeros((P, BLOCK_SIZE), dtype=torch.bool, device=dev)
    wsum = None               # bitmap weights, allocated on first use
    blk = p_blk.long()
    zero = torch.zeros((), device=dev)
    for t in range(T):
        w = s_w[:, t]
        is_req = (s_flag[:, t] & FLAG_REQ) != 0
        is_neg = (s_flag[:, t] & FLAG_NEG) != 0
        seg = segment_positions(s_off[:, t], s_len[:, t])
        if seg is not None:
            pid, pos = seg
            doc = docid[pos].long() & 0xFFFF
            # (pair, doc) is unique within one slot's segment
            score[pid, doc] = fma32(w[pid], imp[pos], score[pid, doc])
            req[pid, doc] += is_req[pid].to(torch.int32)
            neg[pid, doc] |= is_neg[pid]
        rb = torch.nonzero(s_bm[:, t] >= 0).flatten()
        if len(rb):
            bits = unpack_words(bitmaps[s_bm[rb, t].long()])   # [Pb, BLOCK]
            if wsum is None:
                wsum = torch.zeros((P, BLOCK_SIZE), dtype=torch.float32,
                                   device=dev)
            wsum[rb] = wsum[rb] + torch.where(bits, w[rb, None], zero)
            req[rb] += (bits & is_req[rb, None]).to(torch.int32)
            neg[rb] |= bits & is_neg[rb, None]
    if wsum is not None:
        # fma(0, sat1, c) = c: only docs with a bitmap hit change
        pi, di = torch.nonzero(wsum, as_tuple=True)
        score[pi, di] = fma32(wsum[pi, di], sat1[blk[pi] * BLOCK_SIZE + di],
                              score[pi, di])
    deleted = unpack_words(delw[blk])
    matched = (score > 0) & (req >= p_nreq[:, None]) & ~neg & ~deleted
    out = torch.where(matched, score,
                      torch.full((), float("-inf"), device=dev))
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    cnt.index_add_(0, p_q.long(), matched.sum(dim=1, dtype=torch.int32))
    if with_matched:
        return out, cnt, pack_words(matched)
    return out, cnt


def _check_inputs(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                  s_off, s_len, s_bm, s_w, s_flag):
    """Raises ValueError unless the inputs are what K2 takes: CUDA tensors
    of one device, of K2's dtypes and shapes, contiguous, T <= MAX_SLOTS."""
    dev = imp.device
    P, T = s_len.shape
    if T > MAX_SLOTS:
        raise ValueError(f"K2 takes at most {MAX_SLOTS} slots, got {T}")
    _check("docid", docid, torch.int16, docid.shape, dev)
    _check("imp", imp, torch.float32, docid.shape, dev)
    _check("bitmaps", bitmaps, torch.int32, (bitmaps.shape[0], NWORDS), dev)
    NBLK = delw.shape[0]
    _check("sat1", sat1, torch.float32, (NBLK * BLOCK_SIZE,), dev)
    _check("delw", delw, torch.int32, (NBLK, NWORDS), dev)
    for name, x in (("p_blk", p_blk), ("p_q", p_q), ("p_nreq", p_nreq)):
        _check(name, x, torch.int32, (P,), dev)
    _check("s_off", s_off, torch.int64, (P, T), dev)
    for name, x in (("s_len", s_len), ("s_bm", s_bm), ("s_flag", s_flag)):
        _check(name, x, torch.int32, (P, T), dev)
    _check("s_w", s_w, torch.float32, (P, T), dev)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {dev}")
    return dev, P, T


def _pointers(*xs):
    return [x.data_ptr() for x in xs]


def dense_scan_cuda(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                    s_off, s_len, s_bm, s_w, s_flag, n_queries: int,
                    with_matched: bool = False):
    """K2's unfused mode on CUDA tensors: same contract as
    dense_scan_ref."""
    from .. import _build

    ins = (docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
           s_len, s_bm, s_w, s_flag)
    dev, P, T = _check_inputs(*ins)
    out = torch.empty((P, BLOCK_SIZE), dtype=torch.float32, device=dev)
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    mwords = torch.empty((P, NWORDS), dtype=torch.int32, device=dev) \
        if with_matched else None
    lib = _build.load("dense_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    err = lib.dense_scan_launch(*_pointers(*ins), P, T, out.data_ptr(),
                                cnt.data_ptr(),
                                mwords.data_ptr() if with_matched else None,
                                stream)
    if err != 0:
        raise RuntimeError(f"dense_scan_cuda launch failed (error {err})")
    if with_matched:
        return out, cnt, mwords
    return out, cnt


def dense_scan(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
               s_len, s_bm, s_w, s_flag, n_queries: int,
               with_matched: bool = False):
    """Unfused mode: the plain version for tensors on the CPU, K2 for CUDA
    tensors (a CUDA failure raises; there is no fallback)."""
    args = (docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
            s_len, s_bm, s_w, s_flag, n_queries, with_matched)
    if imp.device.type == "cpu":
        return dense_scan_ref(*args)
    if imp.device.type == "cuda":
        return dense_scan_cuda(*args)
    raise ValueError(f"no dense scan for device {imp.device}")


def _sort_desc(x):
    return torch.sort(x, dim=1, descending=True, stable=True)


def topk_block(rank: torch.Tensor, k: int):
    """Exact top-k of each row of rank f32[P, BLOCK_SIZE] by (score desc,
    doc asc): (values f32[P, k], docs i64[P, k]), k <= BLOCK_SIZE.

    For k <= 128, the reference's two stages: the top-k 128-doc buckets by
    (bucket max desc, bucket asc), then the top-k of their docs in
    ascending doc order.  It is exact because a doc outside those buckets
    is beaten or tied-and-preceded by each selected bucket's best doc.
    Every sort is stable: ``torch.topk`` does not keep the lower index on
    ties."""
    P = rank.shape[0]
    if k > CHUNK:
        vals, docs = _sort_desc(rank)
        return vals[:, :k], docs[:, :k]
    xb = rank.view(P, TOPK_BUCKETS, CHUNK)
    bti = _sort_desc(xb.amax(dim=2))[1][:, :k]
    bti = bti.sort(dim=1)[0]                          # doc-ordered buckets
    cand = torch.gather(xb, 1, bti[:, :, None].expand(P, k, CHUNK))
    vals, ci = _sort_desc(cand.reshape(P, k * CHUNK))
    vals, ci = vals[:, :k], ci[:, :k]
    docs = torch.gather(bti, 1, ci // CHUNK) * CHUNK + ci % CHUNK
    return vals, docs


def _check_kk(kk: int):
    if not 1 <= kk <= KMAX:
        raise ValueError(f"K2's fused mode takes 1 <= kk <= {KMAX}, got {kk}")


def topk_tiles(scan, docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
               s_off, s_len, s_bm, s_w, s_flag, n_queries: int, kk: int,
               rank=None, with_matched: bool = False):
    """Each pair's top-kk by (score desc, doc asc) from the masked scores of
    `scan` (dense_scan or dense_scan_ref), TILE_PAIRS pairs at a time, each
    tile reduced by topk_block.  With rank f32[NBLK*BLOCK_SIZE] (sorted
    results) a matched doc ranks by rank[block*BLOCK_SIZE + doc] in place of
    its score: the top-kk by (rank desc, doc asc), as the reference's
    sort-key scan orders a block (lexical.py:535-544).  Returns (vals
    f32[P, kk], docs i64[P, kk], cnt i32[n_queries]), and with_matched the
    matched words i32[P, NWORDS] as a fourth; an entry past a pair's last
    match is -inf with doc -1."""
    dev = imp.device
    P = p_blk.shape[0]
    pairs = (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag)
    vals = torch.empty((P, kk), dtype=torch.float32, device=dev)
    docs = torch.empty((P, kk), dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    mwords = torch.empty((P, NWORDS), dtype=torch.int32, device=dev) \
        if with_matched else None
    ninf = torch.full((), float("-inf"), device=dev)
    for a in range(0, P, TILE_PAIRS):
        b = a + TILE_PAIRS
        args = (docid, imp, bitmaps, sat1, delw, *[x[a:b] for x in pairs],
                n_queries)
        if with_matched:
            scores, c, mwords[a:b] = scan(*args, True)
        else:
            scores, c = scan(*args)
        cnt += c
        if rank is not None:
            scores = torch.where(
                scores > ninf, rank.view(-1, BLOCK_SIZE)[p_blk[a:b].long()],
                ninf)
        v, d = topk_block(scores, kk)
        vals[a:b] = v
        docs[a:b] = torch.where(torch.isfinite(v), d, -1)
        del scores
    if with_matched:
        return vals, docs, cnt, mwords
    return vals, docs, cnt


def dense_topk_ref(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                   s_off, s_len, s_bm, s_w, s_flag, n_queries: int, kk: int,
                   with_matched: bool = False):
    """Plain PyTorch version of K2's fused mode: topk_tiles of
    dense_scan_ref, kk <= KMAX."""
    _check_kk(kk)
    return topk_tiles(dense_scan_ref, docid, imp, bitmaps, sat1, delw, p_blk,
                      p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag,
                      n_queries, kk, with_matched=with_matched)


def dense_topk_cuda(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                    s_off, s_len, s_bm, s_w, s_flag, n_queries: int, kk: int,
                    split: int | None = None, with_matched: bool = False):
    """K2's fused mode on CUDA tensors, one launch for all pairs: same
    contract as dense_topk_ref.  split: CTAs a pair (a cluster), one of
    SPLITS; by default SMALL_SPLIT below SPLIT_BELOW_SMS pairs an SM,
    else 1."""
    from .. import _build

    _check_kk(kk)
    if split is not None and split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split}")
    ins = (docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
           s_len, s_bm, s_w, s_flag)
    dev, P, T = _check_inputs(*ins)
    if split is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        split = SMALL_SPLIT if P < SPLIT_BELOW_SMS * sms else 1
    vals = torch.empty((P, kk), dtype=torch.float32, device=dev)
    docs = torch.empty((P, kk), dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_queries, dtype=torch.int32, device=dev)
    mwords = torch.empty((P, NWORDS), dtype=torch.int32, device=dev) \
        if with_matched else None
    lib = _build.load("dense_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count_launch()
    err = lib.dense_topk_launch(*_pointers(*ins), P, T, kk, split,
                                vals.data_ptr(), docs.data_ptr(),
                                cnt.data_ptr(),
                                mwords.data_ptr() if with_matched else None,
                                stream)
    if err != 0:
        raise RuntimeError(f"dense_topk_cuda launch failed (error {err})")
    if with_matched:
        return vals, docs, cnt, mwords
    return vals, docs, cnt


def dense_topk(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
               s_len, s_bm, s_w, s_flag, n_queries: int, kk: int,
               with_matched: bool = False):
    """Fused mode: the plain version for tensors on the CPU, K2 for CUDA
    tensors (a CUDA failure raises; there is no fallback)."""
    args = (docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq, s_off,
            s_len, s_bm, s_w, s_flag, n_queries, kk)
    if imp.device.type == "cpu":
        return dense_topk_ref(*args, with_matched=with_matched)
    if imp.device.type == "cuda":
        return dense_topk_cuda(*args, with_matched=with_matched)
    raise ValueError(f"no dense scan for device {imp.device}")
