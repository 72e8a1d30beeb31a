"""Dense-path block selection on the host (numpy, no jax).

Port of the block-selection part of ``seekstorm_tpu/search.py::_plan_shard``
(468-719): the vectorised segment lookup, the candidate-block and
upper-bound matrices, ``full`` with its limit, per-query pruning to
``PRUNE_BLOCKS`` blocks, ``ub_unscored`` and ``W``/``nreq``, with required
and negated slots as flags where the reference has ``Mreq``.  The
reference function imports ``ops.lexical`` (jax) for its TPU chunk table,
so the selection is restated here; its numpy calls are the reference's, so
both select the same blocks, set the same ``full`` and compute the same
bounds.

In place of the TPU chunk table and query tiles the plan carries a
(block, query) pair list: one pair per block a query selected, ordered by
block then query, and per pair the query's slots in ascending slot id with
each slot's segment in that block: its CSR-remainder range in
``lex.dev_docid``/``dev_imp`` and its presence-bitmap row (-1 if none).
Kernel K2 (``ops/dense_scan.py``) scores each pair over the block's docs.

mode="tf" (the reference's tf branch, search.py:659-662, 668-670: batches
whose boost profile differs from the commit-time one) emits the same pair
list over the full postings instead: a slot's range in ``lex.pl_docid``/
``pl_tf`` where its segment is sparse, its row of ``lex.dense_tf`` where it
is a dense term; ``ops/lexical.tf_scan_pairs`` scores it.  The reference's
``P_max`` and its 4096*2^i ladder size an XLA window and have no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the reference's plan limits (seekstorm_tpu/search.py:32-42): blocks under
# which plans cover every candidate block, the per-query pruned budget, and
# the shard size from which Topk batches plan like its query-tiled kernel
FULL_PLAN_BLOCKS = 96
PRUNE_BLOCKS = 16
QT_MIN_BLOCKS = 32

# per-(pair, slot) flags
FLAG_REQ = 1                   # required positive slot: counts a hit
FLAG_NEG = 2                   # negated slot: a hit unmatches the doc

__all__ = ["DensePlan", "plan_shard", "FULL_PLAN_BLOCKS", "PRUNE_BLOCKS",
           "QT_MIN_BLOCKS", "FLAG_REQ", "FLAG_NEG"]


@dataclass
class DensePlan:
    block_ids: np.ndarray      # i32[NB] selected shard-local blocks, ascending
    qsel: np.ndarray           # bool[NB, B] query selected block
    W: np.ndarray              # f32[B, V] idf of each scoring slot
    req: np.ndarray            # bool[B, V] required, not negated
    neg: np.ndarray            # bool[B, V] negated
    nreq: np.ndarray           # i32[B]
    full: bool                 # covers every candidate block (counts valid)
    ub_unscored: np.ndarray    # f32[B] max UB over the blocks not selected
    # the (block, query) pair list, block ascending then query ascending
    p_block: np.ndarray        # i32[P] shard-local block
    p_query: np.ndarray        # i32[P] batch row
    # per (pair, slot), the query's slots in ascending slot id (T padded)
    s_off: np.ndarray          # i64[P, T] CSR-remainder offset (dev_docid)
    s_len: np.ndarray          # i32[P, T] CSR-remainder length (0 if none)
    s_bm: np.ndarray           # i32[P, T] bitmap row, -1 if none
    s_w: np.ndarray            # f32[P, T] W[q, slot]
    s_flag: np.ndarray         # i32[P, T] FLAG_REQ | FLAG_NEG
    # "imp", or "tf": s_off / s_len then range over the full postings
    # (pl_docid, pl_tf; length 0 for a dense term) and s_bm holds the
    # slot's dense_tf row, -1 if none
    mode: str = "imp"


def plan_shard(index, shard, slots, specs, realtime: bool, need_full: bool,
               prune_budget: int, mode: str = "imp",
               tails=None) -> DensePlan | None:
    """Select the blocks `specs` are scored on in `shard` and emit the
    pair list.  mode="qt" takes the reference's query-tiled limit
    (PRUNE_BLOCKS) for full coverage, "imp" and "tf" FULL_PLAN_BLOCKS;
    "tf" emits the segments of the full postings and the dense-term rows.
    `tails`: the batch's realtime tails (tail.BatchTails) for the idf.
    None when no block is selected."""
    lex = shard.lexical
    d = lex.directory
    B = len(specs)
    V = len(slots)
    if V == 0 or lex.doc_count == 0:
        return None

    # per-slot segment ranges (search.py:486-516)
    hs = np.array([sl.hash for sl in slots], dtype=np.uint64)
    T = len(d.hash)
    ti_all = np.searchsorted(d.hash, hs)
    found = (ti_all < T)
    ti_c = np.minimum(ti_all, max(T - 1, 0))
    found &= (d.hash[ti_c] == hs) if T else False
    seg_a = np.where(found, d.seg_start[ti_c], 0).astype(np.int64)
    seg_b = np.where(found, d.seg_start[np.minimum(ti_c + 1, T)], 0).astype(
        np.int64)
    seg_n = seg_b - seg_a

    total_segs = int(seg_n.sum())
    rows = np.repeat(np.arange(V, dtype=np.int32), seg_n)       # slot per seg
    shift = np.repeat(np.cumsum(seg_n) - seg_n - seg_a, seg_n)
    flat = np.arange(total_segs, dtype=np.int64) - shift        # dir indices
    fb = d.seg_block[flat]
    fm = d.seg_max_impact[flat]
    if mode == "tf":
        # sparse segments come from the full postings, dense terms from
        # their dense_tf rows (search.py:660-662, 669-670)
        fd = (d.seg_dense[flat] if d.seg_dense is not None
              else np.full(total_segs, -1, np.int32))
        sparse = (fd < 0) & (d.seg_len[flat] > 0)
        fdo = d.seg_offset[flat]
        fdl = np.where(sparse, d.seg_len[flat], 0)
        fbm = fd
    else:
        fbm = d.seg_bitmap[flat]
        fdo = d.seg_dev_offset[flat]
        fdl = d.seg_dev_len[flat]

    from .search import _shard_idf

    idf = _shard_idf(shard, slots, realtime, hs=hs, found=found, ti_c=ti_c,
                     tails=tails)

    # per-query slot masks (search.py:518-529)
    n_blocks = lex.n_blocks
    POS = np.zeros((B, V), dtype=np.float32)
    REQ = np.zeros((B, V), dtype=np.float32)
    NEG = np.zeros((B, V), dtype=bool)
    for qi, spec in enumerate(specs):
        ws = list(spec.weights)
        POS[qi, ws] = 1.0
        REQ[qi, [s for s in ws if spec.required.get(s)]] = 1.0
        NEG[qi, [s for s, n_ in spec.negated.items() if n_]] = True

    # candidate blocks and their upper bounds (search.py:531-547)
    present = np.zeros((V, n_blocks), dtype=np.float32)
    slot_ub = np.zeros((V, n_blocks), dtype=np.float32)
    present[rows, fb] = 1.0
    slot_ub[rows, fb] = fm * idf[rows]
    has_req = REQ.sum(axis=1) > 0
    miss_req = REQ @ (1.0 - present)
    any_pos = (POS @ present) > 0
    cand = np.where(has_req[:, None], miss_req == 0, any_pos)
    cand &= POS.sum(axis=1)[:, None] > 0
    ub = POS @ slot_ub
    ub = np.where(cand, ub, 0.0)

    # full coverage or per-query pruning (search.py:549-569)
    total_cand_blocks = int(np.any(cand, axis=0).sum())
    full_limit = PRUNE_BLOCKS if mode == "qt" else FULL_PLAN_BLOCKS
    full = need_full or total_cand_blocks <= full_limit
    if full:
        selq = cand
    else:
        selq = np.zeros((B, n_blocks), dtype=bool)
        budget = min(prune_budget, n_blocks)
        for qi in range(B):
            order = np.argsort(-ub[qi])[:budget]
            take = order[cand[qi][order]]
            selq[qi, take] = True
    selected = np.any(selq, axis=0)
    block_list = np.flatnonzero(selected).astype(np.int32)
    if len(block_list) == 0:
        return None
    ub_unscored = np.where(selq, 0.0, ub).max(axis=1).astype(np.float32)

    W = POS * idf[None, :]
    req = (REQ > 0) & ~NEG
    nreq = req.sum(axis=1).astype(np.int32)
    qsel = np.ascontiguousarray(selq[:, block_list].T)           # [NB, B]

    # the pair list: block ascending, then query ascending
    pb, p_query = np.nonzero(qsel)
    p_block = block_list[pb]
    # each query's slots in ascending slot id: spec.slots, the weighted
    # and negated slots (the reference's USE mask, search.py:592)
    n_use = np.array([len(spec.slots) for spec in specs], np.int64)
    Tq = max(int(n_use.max()), 1)
    qslot = np.full((B, Tq), -1, np.int64)
    qslot[np.repeat(np.arange(B), n_use),
          np.arange(int(n_use.sum())) - np.repeat(np.cumsum(n_use) - n_use,
                                                  n_use)] = \
        np.concatenate([spec.slots for spec in specs])
    seg_of = np.full((V, n_blocks), -1, np.int64)
    seg_of[rows, fb] = np.arange(total_segs)
    ps = qslot[p_query]                                         # [P, Tq]
    psc = np.maximum(ps, 0)
    e = np.where(ps >= 0, seg_of[psc, p_block[:, None]], -1)
    ok = e >= 0
    ec = np.maximum(e, 0)
    pq = p_query[:, None]
    flag = (np.where(req[pq, psc], FLAG_REQ, 0)
            | np.where(NEG[pq, psc], FLAG_NEG, 0))
    return DensePlan(
        block_ids=block_list,
        qsel=qsel,
        W=W,
        req=req,
        neg=NEG,
        nreq=nreq,
        full=full,
        ub_unscored=ub_unscored,
        p_block=p_block.astype(np.int32),
        p_query=p_query.astype(np.int32),
        s_off=np.where(ok, fdo[ec], 0).astype(np.int64),
        s_len=np.where(ok, fdl[ec], 0).astype(np.int32),
        s_bm=np.where(ok, fbm[ec], -1).astype(np.int32),
        s_w=np.where(ps >= 0, W[pq, psc], 0.0).astype(np.float32),
        s_flag=np.where(ps >= 0, flag, 0).astype(np.int32),
        mode="tf" if mode == "tf" else "imp",
    )
