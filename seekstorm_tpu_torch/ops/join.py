"""Posting-space join: per-query posting windows and batched sorted-list
joins, torch ops on the tensors' device (no hand kernel).

Port of ``seekstorm_tpu/ops/join.py``: ``_lower_bound`` (49), ``_topk_flat``
(80) and ``join_scan`` (98).  Work per query follows its terms' posting
counts instead of the corpus size:

  1. every (query, slot) gathers its term's posting window: the storage
     rows that span the term's compacted-CSR range ``[a0, a0+la)`` and its
     bitmap stash range ``[b0, b0+lb)``, each sorted by global doc id;
  2. the candidates are every slot's postings; each is joined against every
     other slot's window by a batched binary search (``_lower_bound``,
     log2(PW)+1 gather steps; the reference's ``lax.fori_loop`` is a Python
     loop of the same steps);
  3. a bitmap slot (the last slot) tests membership by a bitmap word gather
     and scores the shared ``sat1`` impact; its own candidates are its stash
     (the STASH_K best plain postings of each bitmap block) and its CSR
     residual, exact for pages of up to STASH_K;
  4. scores, required-presence counts and negation hits accumulate per
     candidate in slot order; a doc that is a candidate in several slots
     counts under the lowest slot that holds it;
  5. one top-k over the candidate axis ``v * PW + lane`` ends the query.

Ties follow the reference's index order exactly: every top-k is a stable
descending sort (``torch.topk`` does not keep the lower index on ties),
and ``_topk_flat``'s two-stage path above ``V*PW > 16384`` is restated as
it is, because its buckets decide which docs of a tie class fill a page.

The port's device arrays lie end to end over shards (``parallel/mesh.py``):
``join_scan`` reads a shard's compacted CSR at ``post_base + row*128 +
lane`` of the flat arrays and its ``sat1`` at ``sat1_base + doc``, and takes
bitmap rows already offset to the shard's first bitmap.  A window's last
storage row may run past the shard's postings into the next shard's (where
the reference reads zero padding); those lanes lie outside the window's
ranges, so they are never candidates and never read.
"""

from __future__ import annotations

import torch

from ..schema import BLOCK_SIZE
from .dense_scan import NWORDS, _sort_desc

ROW = 128                      # lanes a storage row of the compacted CSR


def _steps(lengths) -> int:
    """Binary-search steps that cover ranges of up to max(lengths) lanes:
    sizes 2^(s-1) .. 1 add up to 2^s - 1 >= the longest range."""
    return max(int(lengths.max()).bit_length(), 1)


def _lower_bound(tw, base, lo, hi, cand, PW: int, steps: int | None = None):
    """Batched lower_bound of each cand in its sorted range [lo, hi) of the
    window tw[base : base + PW] (tw flat i32; base, lo, hi and cand of one
    shape), with the reference's steps: sizes 2^(steps-1) .. 1, each a
    gather at the clipped position and a compare, then one gather to test
    equality.  The reference takes steps = bit_length(PW); any steps whose
    sizes add up to the longest range finds the same lower bound, the one
    position of a sorted range, so the caller may pass fewer (``_steps``).

    Returns (pos i64, found bool) of cand's shape."""
    pos = lo.long()
    hi = hi.long()
    if steps is None:
        steps = max(PW.bit_length(), 1)
    sz = 1 << (steps - 1)
    for _ in range(steps):
        npos = pos + sz
        g = tw[base + (npos - 1).clamp(0, PW - 1)]
        pos = torch.where((npos <= hi) & (g < cand), npos, pos)
        sz >>= 1
    g = tw[base + pos.clamp(0, PW - 1)]
    return pos, (pos < hi) & (g == cand)


def _topk_flat(rank, k: int):
    """Exact top-k over rank f32[B, N] in XLA's tie order: one stable sort
    where N <= 16384 or k > 512; above, the reference's two stages (the
    top-k of 1,024 bucket maxima, bucket j holding indices i*1024 + j, then
    the top-k of their entries flattened as i*k + rank of the bucket).
    Returns (values f32[B, min(k, N)], indices i64)."""
    B, N = rank.shape
    if N <= 16384 or k > 512:
        vals, idx = _sort_desc(rank)
        kk = min(k, N)
        return vals[:, :kk], idx[:, :kk]
    nb = 1024
    sub = N // nb
    xb = rank.view(B, sub, nb)
    bti = _sort_desc(xb.amax(dim=1))[1][:, :k]            # [B, k]
    cand = torch.gather(xb, 2, bti[:, None, :].expand(B, sub, k))
    ts, tf = _sort_desc(cand.reshape(B, sub * k))
    ts, tf = ts[:, :k], tf[:, :k]
    return ts, (tf // k) * nb + torch.gather(bti, 1, tf % k)


def join_scan(docid, imp, sat1, bitmaps, rows, packA, packB, segp, rowtab,
              W, isreq, isneg, nreq, *, k: int, PW: int, has_bm: bool,
              post_base: int = 0, sat1_base: int = 0):
    """The join over B queries of one shard.

    docid i16[P] (u16 bits) / imp f32[P]: the compacted CSR postings (and
    stash rows) of all shards, flat; sat1 f32[N] the shared plain-posting
    impact per doc; bitmaps i32[NBM, NWORDS] (u32 bits) the presence
    bitmaps; post_base / sat1_base this shard's offsets into docid/imp and
    sat1.  Per query and slot (V slots): rows i32[B, V, NR] the shard's
    storage rows of the window (-1 pad), packA i32[B, V] first_lane<<24 |
    len of the sorted CSR range, packB first_lane<<13 | len of the sorted
    stash range, segp i32[B, V, NS] lane<<12 | block of each segment start
    (-1 pad), rowtab i32[B, NBp] the bitmap row (in `bitmaps`) of each
    block for the bitmap slot (-1), W f32[B, V] idf (0 = not scoring),
    isreq / isneg bool[B, V], nreq i32[B].  PW = NR * 128 lanes a slot;
    has_bm: slot V-1 may be a bitmap slot.

    The reference computes every lane of [B, V, PW]; a lane outside both
    ranges is never a candidate and is never read as a target (a search
    reads only inside [lo, hi)).  So the slot loop here runs on the window
    lanes alone, in (query, slot, lane) order, with the reference's ops in
    its order on each: the same values on every lane that can rank.  The
    block ids, the doc ids a search reads and the rank stay on the full
    grid, which fixes the candidate index v * PW + lane of the top-k.

    Returns (scores f32[B, k] -inf padded, ids i64[B, k] local doc ids
    block*BLOCK_SIZE + docid)."""
    dev = imp.device
    B, V, NR = rows.shape
    VP = V * PW
    lane = torch.arange(PW, dtype=torch.int32, device=dev)
    a0 = packA >> 24
    la = packA & 0xFFFFFF
    b0 = packB >> 13
    lb = packB & 0x1FFF
    valid = (((lane >= a0[..., None]) & (lane < (a0 + la)[..., None]))
             | ((lane >= b0[..., None]) & (lane < (b0 + lb)[..., None])))
    cand = torch.nonzero(valid.view(-1)).squeeze(1)     # ascending
    cq = cand // VP                                     # query
    cv = (cand // PW) % V                               # slot
    cl = cand % PW                                      # lane
    at = (post_base + rows[cq, cv, cl // ROW].long().clamp(min=0) * ROW
          + cl % ROW).clamp(0, imp.shape[0] - 1)
    d16 = docid[at].to(torch.int32) & 0xFFFF
    cimp = imp[at]

    # per-lane block id: (block+1) at segment-start lanes, running max; the
    # reference's pads go to lane PW and are dropped, here masked out
    seg = segp >= 0
    where = torch.arange(B * V, device=dev).view(B, V, 1) * PW + (segp >> 12)
    marks = torch.zeros(B * VP, dtype=torch.int32, device=dev)
    marks.scatter_reduce_(0, where[seg].long(), (segp & 0xFFF)[seg] + 1,
                          reduce="amax")
    blk = torch.cummax(marks.view(B * V, PW), dim=1)[0].view(-1)[cand] - 1
    blkc = blk.clamp(min=0)
    cdoc = blkc * BLOCK_SIZE + d16                  # i32, sorted within inA
    gdoc = torch.zeros(B * VP, dtype=torch.int32, device=dev)
    gdoc[cand] = cdoc
    gimp = torch.zeros(B * VP, dtype=torch.float32, device=dev)
    gimp[cand] = cimp

    C = cand.shape[0]
    score = torch.zeros(C, dtype=torch.float32, device=dev)
    reqcnt = torch.zeros(C, dtype=torch.int32, device=dev)
    neghit = torch.zeros(C, dtype=torch.bool, device=dev)
    owned = torch.ones(C, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if has_bm:
        NBp = rowtab.shape[1]
        s1c = sat1[(sat1_base + cdoc.long()).clamp(0, sat1.shape[0] - 1)]
        bmflat = bitmaps.reshape(-1)

    for u in range(V):
        # a candidate whose query has no range in slot u (nor, in the
        # bitmap slot, a bitmap row) gains nothing from it: the reference
        # adds +0.0 to a score that is >= +0.0 and ORs in false, so only
        # the others run
        act = la[:, u] > 0
        bm_u = has_bm and u == V - 1
        if bm_u:
            act = act | (lb[:, u] > 0) | (rowtab >= 0).any(dim=1)
        sub = torch.nonzero(act[cq]).squeeze(1)
        if not sub.numel():
            continue
        q = cq[sub]
        x = cdoc[sub]
        base = q * VP + u * PW
        posu, fnd = _lower_bound(gdoc, base, a0[q, u], a0[q, u] + la[q, u],
                                 x, PW, _steps(la[:, u]))
        fimp = gimp[base + posu.clamp(0, PW - 1)]
        present = fnd
        imp_u = torch.where(fnd, fimp, zero)
        gen_u = fnd
        if bm_u:
            # bitmap membership (plain postings) and the stash range
            brow = rowtab[q, blkc[sub].long().clamp(max=NBp - 1)]
            wat = (brow.long().clamp(min=0) * NWORDS
                   + ((x & 0xFFFF) >> 5)).clamp(0, bmflat.shape[0] - 1)
            bit = ((bmflat[wat] >> (x & 31)) & 1) > 0
            bmpres = (brow >= 0) & bit
            present = present | bmpres
            imp_u = torch.where(fnd, fimp,
                                torch.where(bmpres, s1c[sub], zero))
            _, fndB = _lower_bound(gdoc, base, b0[q, u], b0[q, u]
                                   + lb[q, u], x, PW, _steps(lb[:, u]))
            gen_u = fnd | fndB
        score[sub] = score[sub] + (W[q, u] * imp_u) * present
        reqcnt[sub] = reqcnt[sub] + (isreq[q, u] & present)
        neghit[sub] = neghit[sub] | (isneg[q, u] & present)
        owned[sub] = owned[sub] & ~(gen_u & (u < cv[sub]))

    ok = (owned & ~isneg[cq, cv] & (reqcnt >= nreq[cq]) & ~neghit
          & (score > 0))
    ninf = torch.full((), float("-inf"), device=dev)
    rank = torch.full((B * VP,), float("-inf"), device=dev)
    rank[cand] = torch.where(ok, score, ninf)
    ts, sel = _topk_flat(rank.view(B, VP), k)
    ids = torch.gather(gdoc.view(B, VP), 1, sel).long()
    if ts.shape[1] < k:
        pad = k - ts.shape[1]
        ts = torch.cat([ts, torch.full((B, pad), float("-inf"), device=dev)],
                       dim=1)
        ids = torch.cat([ids, torch.zeros((B, pad), dtype=torch.int64,
                                          device=dev)], dim=1)
    return ts, ids
