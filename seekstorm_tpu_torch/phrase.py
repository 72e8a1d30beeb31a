"""Exact phrase matching over committed levels.

The reference verifies phrases during scoring via per-term position
streams (reference add_result.rs:38-92 get_next_position, decode_positions
:1485+), giving exact phrase counts at any scale.  In this engine the
device kernel produces AND-candidates and ranking; positions stay
host-side (SURVEY §7 layout).  This module supplies the exact-count half:
per (phrase, level) it intersects the terms' posting lists (sorted docid
arrays -> O(sum df)) and verifies positional adjacency VECTORIZED over
all intersection docs at once, so counts are exact with no candidate
cliff (the former PHRASE_EXACT_LIMIT estimation path).

Positions are padded to a fixed width per posting; rare postings with
tf > PAD fall back to the per-doc python join.
"""

from __future__ import annotations

import numpy as np

from .schema import BLOCK_SIZE

PAD = 16  # positions considered per (posting, field); tf > PAD -> slow path


def _seg_lookup(level, hash_: int) -> tuple[int, int]:
    """Posting range [a, b) of a term hash in one level (or (0, 0))."""
    t = int(np.searchsorted(level.term_hash, np.uint64(hash_)))
    if t >= len(level.term_hash) or level.term_hash[t] != np.uint64(hash_):
        return 0, 0
    return int(level.term_offset[t]), int(level.term_offset[t + 1])


def _padded_positions(level, rows: np.ndarray, field: int) -> np.ndarray:
    """Positions of posting `rows` in `field`, padded to [n, PAD] with -1.

    Rows whose tf exceeds PAD get only the first PAD positions here; the
    caller re-checks them on the slow path."""
    n = len(rows)
    out = np.full((n, PAD), -1, np.int32)
    if n == 0:
        return out
    tf = np.asarray(level.tf[rows], dtype=np.int64)        # [n, F]
    start = np.asarray(level.pos_offset[rows], dtype=np.int64)
    start = start + tf[:, :field].sum(axis=1)
    cnt = np.minimum(tf[:, field], PAD)
    # flat gather: row i takes positions start[i] .. start[i]+cnt[i]
    total = int(cnt.sum())
    if total == 0:
        return out
    ridx = np.repeat(np.arange(n), cnt)
    cidx = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    flat = np.repeat(start, cnt) + cidx
    out[ridx, cidx] = np.asarray(level.pos[flat], dtype=np.int32)
    return out


def phrase_match_level(
    level, hashes: list[int], offsets: list[int]
) -> np.ndarray:
    """Block-local doc ids (sorted) where the phrase occurs in some field."""
    segs = [_seg_lookup(level, h) for h in hashes]
    if any(b <= a for a, b in segs):
        return np.zeros(0, np.int64)
    # intersect sorted docid lists, tracking each term's posting row
    ids = np.asarray(level.docid[segs[0][0]:segs[0][1]], np.int64)
    rows = [np.arange(segs[0][0], segs[0][1], dtype=np.int64)]
    for (a, b) in segs[1:]:
        d2 = np.asarray(level.docid[a:b], np.int64)
        common, i1, i2 = np.intersect1d(ids, d2, assume_unique=True,
                                        return_indices=True)
        rows = [r[i1] for r in rows]
        rows.append(a + i2)
        ids = common
    if len(ids) == 0:
        return ids

    F = level.tf.shape[1]
    tf_all = [np.asarray(level.tf[r], np.int64) for r in rows]
    matched = np.zeros(len(ids), bool)
    slow = np.zeros(len(ids), bool)
    for f in range(F):
        pos = [_padded_positions(level, r, f) for r in rows]
        # normalize by phrase offsets; pads become impossible values
        norm = [np.where(p >= 0, p - o, -10_000_000 - i)
                for i, (p, o) in enumerate(zip(pos, offsets))]
        cand = norm[0]                                # [n, PAD]
        for nxt in norm[1:]:
            hit = (cand[:, :, None] == nxt[:, None, :]).any(axis=2)
            cand = np.where(hit, cand, -1)
        matched |= (cand >= 0).any(axis=1)
        for t, r in enumerate(rows):
            slow |= tf_all[t][:, f] > PAD
    # rare high-tf postings: exact per-doc join
    for i in np.flatnonzero(slow & ~matched):
        from .oracle import verify_phrase

        per_term = [level.positions_for(int(r[i])) for r in rows]
        if verify_phrase(per_term, offsets):
            matched[i] = True
    return ids[matched]


def phrase_match_shard(index, shard, hashes, offsets) -> np.ndarray:
    """Shard-local doc ids matching the phrase over all committed levels."""
    out = []
    for li, level in enumerate(shard.lexical.levels):
        ids = phrase_match_level(level, hashes, offsets)
        if len(ids):
            out.append(ids + li * BLOCK_SIZE)
    return (np.concatenate(out) if out
            else np.zeros(0, np.int64))


def phrase_docs_global(index, slots, spec) -> np.ndarray | None:
    """Global doc ids matching ALL phrase groups of a query spec (committed
    docs only; the realtime tail is verified separately).  None if the
    query has no phrase groups."""
    if not spec.phrases:
        return None
    per_group = []
    for ph in spec.phrases:
        hashes = [slots[s].hash for s, _ in ph]
        offsets = [off for _, off in ph]
        gids = []
        for shard in index.shards:
            ids = phrase_match_shard(index, shard, hashes, offsets)
            if len(ids):
                gids.append(ids * index.shard_count + shard.shard_id)
        per_group.append(
            np.concatenate(gids) if gids else np.zeros(0, np.int64))
    out = per_group[0]
    for g in per_group[1:]:
        out = np.intersect1d(out, g, assume_unique=True)
    return out
