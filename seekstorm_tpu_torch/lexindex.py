"""Committed lexical index: per-level packed arrays, merged term directory,
and HBM-resident device tensors.

TPU-first layout (replaces the reference's roaring-compressed linked posting
lists + mmap strips, reference index.rs:1555-1694, compress_postinglist.rs):

* Postings are flat CSR tensors per shard, concatenated over levels:
    pl_docid : u16[P]     block-local doc id per posting
    pl_tf    : u16[P, F]  per-indexed-field term frequency
  A "block" == a committed level == up to 65,536 docs (reference
  ROARING_BLOCK_SIZE index.rs:115), so doc ids fit u16 and the dense
  scoring domain per block is a fixed 64K lane-friendly axis.
* Per-(doc, field) BM25 length components are materialized as
    comp : f32[n_blocks * 65536, F]
  (recomputed whenever the shard-average doc length moves, mirroring the
  reference's bm25_component_cache recompute at commit, commit.rs:321).
* The term directory stays host-side (numpy, hash-sorted) and maps
  term-hash -> posting segments (block, offset, length, max_impact).
  max_impact per (term, block) drives block-max pruning, the analog of the
  reference's max_block_score (index.rs:781-789, intersection.rs:2224).
* Positions stay host-side for phrase verification / highlighting; the
  flat positions tensor is addressable from (tf cumsum) without an offsets
  file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .oracle import bm25_components, term_impacts
from .schema import BLOCK_SIZE, BM25_K

# (term, block) segments at or above this length use the dense tf-column
# representation (u16[BLOCK_SIZE, F] per entry); below it, CSR windows.
# Breakeven vs CSR memory (2+2F bytes/posting vs 2F*65536 bytes) sits at
# ~32-43K postings; the kernel win applies to any length.  (tf-fallback
# path only — the impact path uses presence bitmaps below.)
DENSE_MIN = 32768

# Impact fast path: a (term, block) segment whose "plain" postings (tf == 1
# in the primary field, 0 elsewhere) number at least BITMAP_MIN stores them
# as a 64K-bit presence BITMAP (u32[2048], 8 KB) instead of CSR entries —
# the analog of the reference's roaring block form switch
# (compress_postinglist.rs:240-330: >= 4096 postings -> 8 KB bitmap).
# The threshold sits at the CSR memory breakeven (8 KB / 6 B-per-posting
# ~= 1365), below the reference's 4096: on TPU the bitmap rank-1 matmul
# is much cheaper per posting than chunk decode, so every memory-neutral
# segment should take it.  Plain postings all share the same per-doc impact
#   sat1(d) = boost_primary * (K+1) / (1 + comp_primary(d))
# so the kernel scores a bitmap slot with ONE slot-level matmul row times
# the per-doc sat1 vector — no per-posting decode at all.  The segment's
# irregular remainder (secondary-field hits, tf >= 2) stays in the CSR
# with exact precomputed impacts.
BITMAP_MIN = 1344

# per-bitmap-segment candidate stash (posting-space join path, ops/join.py):
# the STASH_K highest-impact plain postings of every bitmap segment are
# appended to the compacted device CSR (sorted by docid) so the join kernel
# can source candidates for bitmap slots without enumerating the bitmap —
# exact for top-k <= STASH_K because a bitmap-only doc outside the stash is
# impact-dominated by >= STASH_K stash docs of its own block.
STASH_K = 64


@dataclass
class CommittedLevel:
    """One immutable 64K-doc level, loaded from disk."""

    doc_count: int
    positions_sum_normalized: int
    term_hash: np.ndarray    # u64[T] sorted
    term_offset: np.ndarray  # i64[T+1]
    docid: np.ndarray        # u16[P]
    tf: np.ndarray           # u16[P, F]
    pos: np.ndarray          # u16[sum(tf)] flat positions, field-major per posting
    pos_offset: np.ndarray   # i64[P+1] derived at load (cumsum of per-posting tf)
    doclen: np.ndarray       # u8[doc_count, F]
    term_names: list | None = None  # hash-sorted term strings (terms.txt)

    @staticmethod
    def load(path: Path, mmap: bool = False) -> "CommittedLevel":
        mm = "r" if mmap else None
        with open(path / "level.json") as f:
            meta = json.load(f)
        doclen = np.load(path / "doclen.npy", mmap_mode=mm)
        term_offset = np.load(path / "term_offset.npy", mmap_mode=mm)
        pb = path / "postings.bin"
        if pb.exists():
            # compact durable form (st_pack_postings varint stream with an
            # 8-byte pos-count header; reference analog varint positions +
            # per-block form choice, compress_postinglist.rs:240-330,949);
            # decoded to the SAME fixed-width in-memory arrays, so only
            # the disk bytes change.  Under AccessType.Mmap these three
            # arrays live in RAM (the doc store, the bulk of a stored
            # corpus, still mmaps).
            from . import native as native_mod

            raw = pb.read_bytes()
            n_pos = int(np.frombuffer(raw[:8], np.int64)[0])
            F = doclen.shape[1] if doclen.ndim == 2 else 1
            dec = native_mod.decode_postings(raw[8:], np.asarray(term_offset),
                                             F, n_pos)
            if dec is None:
                raise RuntimeError(
                    "level uses the compact posting format but the native "
                    "library is unavailable (build native/ or repack)")
            docid, tf, pos = dec
        else:
            docid = np.load(path / "docid.npy", mmap_mode=mm)
            tf = np.load(path / "tf.npy", mmap_mode=mm)
            pos = np.load(path / "pos.npy", mmap_mode=mm)
        per_posting = tf.sum(axis=1, dtype=np.int64)
        pos_offset = np.zeros(len(tf) + 1, dtype=np.int64)
        np.cumsum(per_posting, out=pos_offset[1:])
        names = None
        tpath = path / "terms.txt"
        if tpath.exists():
            blob = tpath.read_bytes()
            names = blob.decode().split("\n")[:-1] if blob else []
        return CommittedLevel(
            doc_count=meta["doc_count"],
            positions_sum_normalized=meta["positions_sum_normalized"],
            term_hash=np.load(path / "term_hash.npy", mmap_mode=mm),
            term_offset=term_offset,
            docid=docid,
            tf=tf,
            pos=pos,
            pos_offset=pos_offset,
            doclen=doclen,
            term_names=names,
        )

    def posting_index(self, hash_: int, local_docid: int) -> int:
        """Posting row for (term, doc) or -1."""
        t = int(np.searchsorted(self.term_hash, np.uint64(hash_)))
        if t >= len(self.term_hash) or self.term_hash[t] != np.uint64(hash_):
            return -1
        a, b = int(self.term_offset[t]), int(self.term_offset[t + 1])
        i = a + int(np.searchsorted(self.docid[a:b], np.uint16(local_docid)))
        if i < b and self.docid[i] == local_docid:
            return i
        return -1

    def positions_for(self, posting_row: int) -> list[np.ndarray]:
        """Per-field position arrays for a posting row."""
        start = int(self.pos_offset[posting_row])
        out = []
        for f in range(self.tf.shape[1]):
            n = int(self.tf[posting_row, f])
            out.append(self.pos[start : start + n].astype(np.int64))
            start += n
        return out


@dataclass
class TermDirectory:
    """Merged hash-sorted term directory over all levels of a shard."""

    hash: np.ndarray        # u64[T] sorted unique
    df: np.ndarray          # i64[T]
    seg_start: np.ndarray   # i64[T+1] range into segment arrays
    seg_block: np.ndarray   # i32[S] level/block id
    seg_offset: np.ndarray  # i64[S] offset into concatenated postings
    seg_len: np.ndarray     # i32[S]
    seg_max_impact: np.ndarray  # f32[S] (default boost profile)
    seg_dense: np.ndarray | None = None  # i32[S] dense-store row or -1 (tf path)
    # impact path: offset/length of the segment's CSR remainder in the
    # compacted device CSR (plain postings of bitmap segments excluded)
    seg_dev_offset: np.ndarray | None = None  # i64[S]
    seg_dev_len: np.ndarray | None = None     # i32[S]
    # presence-bitmap row for the segment's plain postings, or -1
    seg_bitmap: np.ndarray | None = None      # i32[S]
    # join-path candidate stash range in the device CSR (bitmap segs only)
    seg_stash_off: np.ndarray | None = None   # i64[S]
    seg_stash_len: np.ndarray | None = None   # i32[S]

    def lookup(self, h: int) -> int:
        i = int(np.searchsorted(self.hash, np.uint64(h)))
        if i < len(self.hash) and self.hash[i] == np.uint64(h):
            return i
        return -1


@dataclass
class ShardLexical:
    """Committed lexical state of one shard (host + device)."""

    levels: list[CommittedLevel] = field(default_factory=list)
    directory: TermDirectory | None = None
    pl_docid: np.ndarray | None = None   # u16[P] concatenated
    pl_tf: np.ndarray | None = None      # u16[P, F]
    pl_impact: np.ndarray | None = None  # f32[P] default-boost impacts
    comp: np.ndarray | None = None       # f32[n_blocks*BLOCK_SIZE, F]
    avg_len: float = 0.0
    doc_count: int = 0                   # committed docs in this shard
    level_post_base: np.ndarray | None = None  # i64[L+1] posting base per level
    # dense-term store (tf-fallback path): terms with >= DENSE_MIN postings
    # in a block keep a dense u16 tf column instead of a CSR window segment
    dense_tf: np.ndarray | None = None   # u16[ND, BLOCK_SIZE, F]
    # impact-path presence bitmaps (see BITMAP_MIN): one 64K-bit row per
    # (term, block) plain-posting class, plus the shared per-doc sat1
    # impact vector (the analog of the reference's roaring BITMAP posting
    # blocks, compress_postinglist.rs:240-330)
    bitmaps: np.ndarray | None = None    # u32[NBM, BLOCK_SIZE // 32]
    sat1: np.ndarray | None = None       # f32[n_blocks*BLOCK_SIZE]
    # compacted device CSR for the impact fast path (bitmap segments'
    # plain postings excluded), concatenated in directory order
    dev_docid: np.ndarray | None = None  # u16[Pc]
    dev_imp: np.ndarray | None = None    # f32[Pc]

    @property
    def n_blocks(self) -> int:
        return len(self.levels)

    def get_positions(self, hash_: int, shard_docid: int) -> list[np.ndarray] | None:
        lvl_id, local = divmod(shard_docid, BLOCK_SIZE)
        if lvl_id >= len(self.levels):
            return None
        lvl = self.levels[lvl_id]
        row = lvl.posting_index(hash_, local)
        if row < 0:
            return None
        return lvl.positions_for(row)


LEXCACHE_VERSION = 3

# Materialized serve-time arrays — cached ONLY for n-gram-expanded
# shards (expansion appends virtual postings, so the plain level replay
# no longer reproduces them).  Plain shards replay these at load from
# the stored directory via the same fused native passes the build used
# (_replay_from_directory): the cache then holds just the directory,
# ~25 B/doc instead of ~330 (bench_memory.py, VERDICT r4 item 4).
_LEXCACHE_FIELDS = (
    "pl_impact", "dense_tf", "bitmaps", "dev_docid", "dev_imp",
)
# Cheaply derivable from the level files at load time — also cached only
# for n-gram-expanded shards.
_LEXCACHE_DERIVED = (
    "pl_docid", "pl_tf", "comp", "sat1", "level_post_base",
)
_DIR_FIELDS = (
    "hash", "df", "seg_start", "seg_block", "seg_offset", "seg_len",
    "seg_max_impact", "seg_dense", "seg_dev_offset", "seg_dev_len",
    "seg_bitmap", "seg_stash_off", "seg_stash_len",
)


def _reconstruct_derived(sh: "ShardLexical", levels, boosts) -> None:
    """Rebuild the cheaply-derivable serve-time arrays a slim lexcache
    omits — identical float paths to build_shard_lexical, so a cache
    round trip stays bit-exact (test_cache_roundtrip)."""
    F = levels[0].tf.shape[1]
    L = len(levels)
    sh.pl_docid = np.concatenate([l.docid for l in levels])
    sh.pl_tf = np.concatenate([l.tf for l in levels], axis=0)
    base = np.zeros(L + 1, dtype=np.int64)
    np.cumsum([len(l.docid) for l in levels], out=base[1:])
    sh.level_post_base = base
    comp = np.zeros((L * BLOCK_SIZE, F), dtype=np.float32)
    for i, l in enumerate(levels):
        comp[i * BLOCK_SIZE : i * BLOCK_SIZE + l.doc_count] = \
            bm25_components(np.asarray(l.doclen), sh.avg_len)
    comp[comp == 0.0] = 1.0
    sh.comp = comp
    from .utils import DOCUMENT_LENGTH_COMPRESSION

    tot_len = np.zeros(F, np.float64)
    for l in levels:
        tot_len += DOCUMENT_LENGTH_COMPRESSION[np.asarray(l.doclen)].sum(
            axis=0)
    f_star = int(np.argmax(tot_len))
    sh.sat1 = ((np.float32(BM25_K + 1.0)
                / (np.float32(1.0) + comp[:, f_star]))
               * np.float32(boosts[f_star])).astype(np.float32)


def _primary_field(levels, F: int) -> int:
    """Primary field = largest total token count (reference longest-field
    semantics, SchemaField::longest index.rs:1102-1155)."""
    from .utils import DOCUMENT_LENGTH_COMPRESSION

    tot_len = np.zeros(F, np.float64)
    for l in levels:
        tot_len += DOCUMENT_LENGTH_COMPRESSION[np.asarray(l.doclen)].sum(
            axis=0)
    return int(np.argmax(tot_len))


def _impact_loop(sh: "ShardLexical", levels, base, boosts,
                 f_star: int):
    """Per-posting default-boost impacts + per-(level, term) max impact,
    in level order — one fused C++ pass per level (st_build_impacts,
    replacing ~6 numpy full-array passes; float op order is identical —
    sequential field sum — for F < 8, where numpy's pairwise row-sum is
    also sequential, so native/python are bit-identical there, pinned by
    test_native_build_parity).  Returns (pl_impact f32[P],
    all_max f32[n_terms], plain_all u8[P] | None,
    plain_cnt_all i32[n_terms] | None) — the plain flags come only from
    the native pass; callers compute the numpy fallback themselves."""
    from .schema import BM25_K, BM25_SIGMA
    from . import native as native_mod

    comp = sh.comp
    F = sh.pl_tf.shape[1]
    n_terms = sum(len(l.term_hash) for l in levels)
    use_native = (F < 8 and BM25_SIGMA == 0.0
                  and native_mod.available()
                  and hasattr(native_mod.load(), "st_build_impacts"))
    all_max = np.zeros(n_terms, dtype=np.float32)
    pl_impact = np.zeros(len(sh.pl_docid), dtype=np.float32)
    plain_all = np.zeros(len(sh.pl_docid), np.uint8) if use_native else None
    plain_cnt_all = (np.zeros(n_terms, np.int32)
                     if use_native else None)
    t0 = 0
    for i, l in enumerate(levels):
        nt = len(l.term_hash)
        if len(l.docid):
            if use_native:
                imp, mx, pln, pcnt = native_mod.build_impacts(
                    np.asarray(l.docid), np.asarray(l.tf),
                    comp[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE],
                    boosts, np.asarray(l.term_offset), f_star,
                    np.float32(BM25_K + 1.0))
                pl_impact[base[i] : base[i + 1]] = imp
                plain_all[base[i] : base[i + 1]] = pln
                all_max[t0 : t0 + nt] = mx
                plain_cnt_all[t0 : t0 + nt] = pcnt
            else:
                comps_l = comp[i * BLOCK_SIZE + l.docid.astype(np.int64)]
                imp = term_impacts(np.asarray(l.tf), comps_l, boosts)
                pl_impact[base[i] : base[i + 1]] = imp
                starts = np.asarray(l.term_offset[:-1], dtype=np.int64)
                # reduceat over term segments (no empty segments)
                if len(starts):
                    all_max[t0 : t0 + nt] = np.maximum.reduceat(imp, starts)
        t0 += nt
    return pl_impact, all_max, plain_all, plain_cnt_all


def _dense_from_dir(sh: "ShardLexical", seg_dense, seg_off_sorted,
                    seg_len_sorted) -> None:
    """Dense-term tf columns from the (term, block)-segment selection:
    row seg_dense[e] of dense_tf is segment e's postings scattered into a
    [BLOCK_SIZE, F] u16 column."""
    F = sh.pl_tf.shape[1]
    dense_sel = np.flatnonzero(seg_dense >= 0)
    dense_rows: list[np.ndarray | None] = [None] * len(dense_sel)
    for e in dense_sel:
        a = int(seg_off_sorted[e])
        ln = int(seg_len_sorted[e])
        ids = sh.pl_docid[a : a + ln].astype(np.int64)
        col = np.zeros((BLOCK_SIZE, F), np.uint16)
        col[ids] = sh.pl_tf[a : a + ln]
        dense_rows[int(seg_dense[e])] = col
    sh.dense_tf = (
        np.stack(dense_rows) if dense_rows
        else np.zeros((0, BLOCK_SIZE, F), np.uint16)
    )


def _dev_pass(sh: "ShardLexical", seg_off_sorted, seg_len_sorted,
              seg_block_sorted, seg_bitmap, bm_sel, plain, pl_impact,
              sat1, csr_total: int, dev_total: int):
    """Device layout: compacted CSR (bitmap segments drop their plain
    postings) + presence bitmaps + join-path stash, all emitted by ONE
    fused C++ pass in directory order (st_build_dev); the numpy path
    below is the portable fallback with identical output.  Sets
    sh.dev_docid / sh.dev_imp / sh.bitmaps and returns
    (seg_dev_len i32, seg_stash_off i64, seg_stash_len i32)."""
    from . import native as native_mod

    n_seg = len(seg_off_sorted)
    W32 = BLOCK_SIZE // 32
    built = None
    if native_mod.available() and hasattr(native_mod.load(),
                                          "st_build_dev"):
        built = native_mod.build_dev(
            seg_off_sorted, seg_len_sorted, seg_block_sorted, seg_bitmap,
            sh.pl_docid, pl_impact, np.ascontiguousarray(plain, np.uint8),
            sat1, STASH_K, csr_total, dev_total, len(bm_sel))
    if built is not None:
        (sh.dev_docid, sh.dev_imp, seg_dev_len, sh.bitmaps,
         seg_stash_off, seg_stash_len) = built
        return seg_dev_len, seg_stash_off, seg_stash_len

    keep = np.ones(len(sh.pl_docid), bool)
    bm_rows: list[np.ndarray] = []
    stash_seg: list[int] = []
    stash_docid: list[np.ndarray] = []
    stash_imp: list[np.ndarray] = []
    for e in bm_sel:
        a = int(seg_off_sorted[e])
        ln = int(seg_len_sorted[e])
        pm = plain[a : a + ln]
        ids = sh.pl_docid[a : a + ln][pm].astype(np.int64)
        words = np.zeros(W32, np.uint32)
        np.bitwise_or.at(words, ids >> 5,
                         np.uint32(1) << (ids & 31).astype(np.uint32))
        bm_rows.append(words)
        keep[a : a + ln] &= ~pm
        blk = int(seg_block_sorted[e])
        s1seg = sat1[blk * BLOCK_SIZE + ids]
        t = min(STASH_K, len(ids))
        # deterministic top-t by (impact desc, docid asc) — ids ascend,
        # so a stable sort on -impact breaks ties by docid (the C++
        # pass uses the same rule)
        topi = np.argsort(-s1seg, kind="stable")[:t]
        sel = np.sort(ids[topi])
        stash_seg.append(int(e))
        stash_docid.append(sel.astype(np.uint16))
        stash_imp.append(sat1[blk * BLOCK_SIZE + sel])
    sh.bitmaps = (np.stack(bm_rows) if bm_rows
                  else np.zeros((0, W32), np.uint32))

    # compacted device CSR in directory order
    lens_all = seg_len_sorted.astype(np.int64)
    starts_all = np.zeros(n_seg + 1, np.int64)
    np.cumsum(lens_all, out=starts_all[1:])
    Pall = int(starts_all[-1])
    if Pall:
        idx_all = (np.repeat(seg_off_sorted.astype(np.int64), lens_all)
                   + np.arange(Pall, dtype=np.int64)
                   - np.repeat(starts_all[:-1], lens_all))
        keepf = keep[idx_all]
        seg_ids = np.repeat(
            np.arange(n_seg, dtype=np.int64), lens_all)
        idx_src = idx_all[keepf]
        sh.dev_docid = sh.pl_docid[idx_src]
        sh.dev_imp = pl_impact[idx_src]
        seg_dev_len = np.bincount(
            seg_ids[keepf], minlength=n_seg).astype(np.int32)
    else:
        sh.dev_docid = np.zeros(0, np.uint16)
        sh.dev_imp = np.zeros(0, np.float32)
        seg_dev_len = np.zeros(n_seg, np.int32)

    # append the join-path stash postings after the compacted CSR
    seg_stash_off = np.zeros(n_seg, np.int64)
    seg_stash_len = np.zeros(n_seg, np.int32)
    if stash_seg:
        base0 = len(sh.dev_docid)
        lens = np.array([len(x) for x in stash_docid], np.int64)
        offs = base0 + np.concatenate([[0], np.cumsum(lens)[:-1]])
        seg_stash_off[stash_seg] = offs
        seg_stash_len[stash_seg] = lens
        sh.dev_docid = np.concatenate([sh.dev_docid] + stash_docid)
        sh.dev_imp = np.concatenate([sh.dev_imp] + stash_imp).astype(
            np.float32)
    return seg_dev_len, seg_stash_off, seg_stash_len


def _replay_from_directory(sh: "ShardLexical", levels, boosts) -> None:
    """Rebuild the materialized serve-time arrays (pl_impact, dense_tf,
    bitmaps, dev_docid, dev_imp) a slim lexcache omits, replaying the
    build's fused passes against the STORED directory decisions —
    identical float paths to build_shard_lexical, so a cache round trip
    stays bit-exact (test_cache_roundtrip).  Requires _reconstruct_derived
    to have run (pl_docid/pl_tf/comp/sat1 set).  Raises on any layout
    mismatch (the caller falls back to a full rebuild)."""
    d = sh.directory
    F = sh.pl_tf.shape[1]
    f_star = _primary_field(levels, F)
    pl_impact, _, plain_all, _ = _impact_loop(
        sh, levels, sh.level_post_base, boosts, f_star)
    sh.pl_impact = pl_impact
    if plain_all is not None:
        plain = plain_all.view(bool)
    else:
        tf_sum = sh.pl_tf.astype(np.int64).sum(axis=1)
        plain = (sh.pl_tf[:, f_star] == 1) & (tf_sum == 1)
    _dense_from_dir(sh, d.seg_dense, d.seg_offset, d.seg_len)
    bm_sel = np.flatnonzero(d.seg_bitmap >= 0)
    csr_total = int(d.seg_dev_len.astype(np.int64).sum())
    dev_total = csr_total + int(d.seg_stash_len.astype(np.int64).sum())
    seg_dev_len, seg_stash_off, seg_stash_len = _dev_pass(
        sh, d.seg_offset, d.seg_len, d.seg_block, d.seg_bitmap,
        bm_sel, plain, pl_impact, sh.sat1, csr_total, dev_total)
    if not (np.array_equal(seg_dev_len, d.seg_dev_len)
            and np.array_equal(seg_stash_off, d.seg_stash_off)
            and np.array_equal(seg_stash_len, d.seg_stash_len)):
        raise ValueError("lexcache replay does not match the stored layout")


def _lex_fingerprint(levels, boosts, expand_ngrams: bool) -> dict:
    return {
        "v": LEXCACHE_VERSION,
        "docs": [int(l.doc_count) for l in levels],
        "posts": [int(len(l.docid)) for l in levels],
        "possum": [int(l.positions_sum_normalized) for l in levels],
        "boosts": [float(b) for b in boosts],
        "expand": bool(expand_ngrams),
        "dense_min": int(DENSE_MIN),
        "bitmap_min": int(BITMAP_MIN),
        "stash_k": int(STASH_K),
    }


def build_shard_lexical_cached(
    path, levels: list[CommittedLevel], boosts: np.ndarray,
    expand_ngrams: bool = False,
) -> "ShardLexical":
    """build_shard_lexical with an on-disk artifact cache.

    The merged directory + device tensors are a pure function of the
    immutable levels (plus boosts and the layout constants), but the
    build costs minutes at reference scale (impacts, bitmap/stash
    extraction, n-gram expansion: ~456 s for 5M docs, 20+ min for a
    1M-doc n-gram index).  Commit writes `lexcache.npz` next to the
    levels; reopen loads it in seconds when the fingerprint matches,
    otherwise rebuilds (and refreshes the cache, best-effort)."""
    import json as _json
    from pathlib import Path

    path = Path(path)
    fp = _lex_fingerprint(levels, boosts, expand_ngrams)
    cj = path / "lexcache.json"
    cn = path / "lexcache.npz"
    if levels:
        try:
            if cj.exists() and cn.exists() \
                    and _json.loads(cj.read_text()) == fp:
                z = np.load(cn, allow_pickle=False)
                sh = ShardLexical(levels=levels)
                sh.avg_len = float(z["avg_len"])
                sh.doc_count = int(z["doc_count"])
                sh.directory = TermDirectory(
                    **{f: z["d_" + f] for f in _DIR_FIELDS})
                if expand_ngrams:
                    for f in _LEXCACHE_FIELDS + _LEXCACHE_DERIVED:
                        setattr(sh, f, z[f])
                else:
                    _reconstruct_derived(sh, levels, boosts)
                    _replay_from_directory(sh, levels, boosts)
                return sh
        except Exception:
            pass
    sh = build_shard_lexical(levels, boosts, expand_ngrams=expand_ngrams)
    if levels:
        try:
            fields = ((_LEXCACHE_FIELDS + _LEXCACHE_DERIVED)
                      if expand_ngrams else ())
            arrs = {f: getattr(sh, f) for f in fields}
            arrs.update({"d_" + f: getattr(sh.directory, f)
                         for f in _DIR_FIELDS})
            arrs["avg_len"] = np.float64(sh.avg_len)
            arrs["doc_count"] = np.int64(sh.doc_count)
            tmp = cn.with_suffix(".npz.tmp")
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrs)
            tmp.replace(cn)
            cj.write_text(_json.dumps(fp))
        except Exception:
            pass
    return sh


def term_window_splits(lex: "ShardLexical", a: int, b: int, nw: int):
    """Per-(segment, sub-window) posting split table for one term's
    device-CSR segments [a, b) of the directory: returns i64[b-a, nw+1]
    cumulative posting counts per 64K/nw-doc sub-window (the planner's
    windowed chunk construction, ops/lexical._block_step_imp).

    Cached on the shard between commits; built in one vectorized pass
    over the term's contiguous dev-CSR range."""
    caches = getattr(lex, "_wsplit_cache", None)
    if caches is None:
        caches = lex._wsplit_cache = {}
    cache = caches.setdefault(nw, {})
    t = cache.get(a)
    if t is not None:
        return t
    d = lex.directory
    offs = np.asarray(d.seg_dev_offset[a:b], np.int64)
    lens = np.asarray(d.seg_dev_len[a:b], np.int64)
    n = b - a
    t = np.zeros((n, nw + 1), np.int64)
    total = int(lens.sum())
    if total:
        shift = (BLOCK_SIZE // nw - 1).bit_length()
        o0 = int(offs[0])
        win = (lex.dev_docid[o0:o0 + total].astype(np.int32) >> shift)
        segid = np.repeat(np.arange(n, dtype=np.int64), lens)
        cnt = np.bincount(segid * nw + win,
                          minlength=n * nw).reshape(n, nw)
        np.cumsum(cnt, axis=1, out=t[:, 1:])
    cache[a] = t
    return t


def term_chunk_template(lex: "ShardLexical", a: int, b: int, nw: int):
    """Per-term chunk template for the windowed scan planner: the chunk
    rows covering every (segment, sub-window) of the term's device-CSR
    segments [a, b), precomputed once per commit and cached on the shard.

    Returns (blk i32[nc], wid i32[nc], rowi i32[nc], cse i32[nc]) sorted
    by (block, window); cse packs cs<<8 | (ce-1) — the batch planner ORs
    in the slot id (slot<<16) at assembly time."""
    caches = getattr(lex, "_ctpl_cache", None)
    if caches is None:
        caches = lex._ctpl_cache = {}
    cache = caches.setdefault(nw, {})
    t = cache.get(a)
    if t is not None:
        return t
    d = lex.directory
    offs = np.asarray(d.seg_dev_offset[a:b], np.int64)
    lens = np.asarray(d.seg_dev_len[a:b], np.int64)
    blks = np.asarray(d.seg_block[a:b], np.int64)
    if nw > 1:
        wsl = term_window_splits(lex, a, b, nw)
        off = (offs[:, None] + wsl[:, :-1]).reshape(-1)
        ln = np.diff(wsl, axis=1).reshape(-1)
        wid = np.tile(np.arange(nw, dtype=np.int64), b - a)
        blk = np.repeat(blks, nw)
    else:
        off, ln, blk = offs, lens, blks
        wid = np.zeros(b - a, np.int64)
    nz = ln > 0
    off, ln, wid, blk = off[nz], ln[nz], wid[nz], blk[nz]
    CHUNK = 128
    first_row = off // CHUNK
    nrows = (off + ln - 1) // CHUNK - first_row + 1
    total = int(nrows.sum())
    if total:
        eidx = np.repeat(np.arange(len(off), dtype=np.int64), nrows)
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(nrows) - nrows, nrows))
        rowi = first_row[eidx] + within
        row_start = rowi * CHUNK
        cstart = np.clip(off[eidx] - row_start, 0, CHUNK)
        cend = np.clip(off[eidx] + ln[eidx] - row_start, 0, CHUNK)
        t = (blk[eidx].astype(np.int32), wid[eidx].astype(np.int32),
             rowi.astype(np.int32),
             ((cstart << 8) | (cend - 1)).astype(np.int32))
    else:
        z = np.zeros(0, np.int32)
        t = (z, z, z, z)
    cache[a] = t
    return t


def build_shard_lexical(
    levels: list[CommittedLevel], boosts: np.ndarray,
    expand_ngrams: bool = False,
) -> ShardLexical:
    """Merge committed levels into the flat device layout + term directory.

    boosts: f32[F] default per-field boosts (schema boosts).

    expand_ngrams (Bm25f similarity only): n-gram posting lists are scored
    with per-CONSTITUENT tfs and idfs (reference add_result.rs:868-915 reads
    constituent tfs stored inside each n-gram posting).  Here the join runs
    at build time: the n-gram's main segment gets constituent-1 tfs, and
    constituents 2..k become appended virtual posting segments under
    synthetic directory hashes — the scoring kernel is unchanged, n-gram
    slots just decode as k weighted slots.
    """
    sh = ShardLexical(levels=levels)
    if not levels:
        sh.directory = TermDirectory(
            hash=np.zeros(0, np.uint64),
            df=np.zeros(0, np.int64),
            seg_start=np.zeros(1, np.int64),
            seg_block=np.zeros(0, np.int32),
            seg_offset=np.zeros(0, np.int64),
            seg_len=np.zeros(0, np.int32),
            seg_max_impact=np.zeros(0, np.float32),
        )
        F = len(boosts)
        sh.pl_docid = np.zeros(0, np.uint16)
        sh.pl_tf = np.zeros((0, F), np.uint16)
        sh.pl_impact = np.zeros(0, np.float32)
        sh.comp = np.zeros((0, F), np.float32)
        sh.level_post_base = np.zeros(1, np.int64)
        sh.dense_tf = np.zeros((0, BLOCK_SIZE, F), np.uint16)
        sh.bitmaps = np.zeros((0, BLOCK_SIZE // 32), np.uint32)
        sh.sat1 = np.zeros(0, np.float32)
        sh.dev_docid = np.zeros(0, np.uint16)
        sh.dev_imp = np.zeros(0, np.float32)
        sh.directory.seg_dev_offset = np.zeros(0, np.int64)
        sh.directory.seg_dev_len = np.zeros(0, np.int32)
        sh.directory.seg_bitmap = np.zeros(0, np.int32)
        sh.directory.seg_stash_off = np.zeros(0, np.int64)
        sh.directory.seg_stash_len = np.zeros(0, np.int32)
        return sh

    F = levels[0].tf.shape[1]
    L = len(levels)
    sh.doc_count = sum(l.doc_count for l in levels)
    pos_sum = sum(l.positions_sum_normalized for l in levels)
    sh.avg_len = pos_sum / max(sh.doc_count, 1)

    # concatenated postings
    sh.pl_docid = np.concatenate([l.docid for l in levels])
    sh.pl_tf = np.concatenate([l.tf for l in levels], axis=0)
    base = np.zeros(L + 1, dtype=np.int64)
    np.cumsum([len(l.docid) for l in levels], out=base[1:])
    sh.level_post_base = base

    # per-(doc, field) BM25 components, padded to BLOCK_SIZE per level
    comp = np.zeros((L * BLOCK_SIZE, F), dtype=np.float32)
    for i, l in enumerate(levels):
        comp[i * BLOCK_SIZE : i * BLOCK_SIZE + l.doc_count] = bm25_components(
            np.asarray(l.doclen), sh.avg_len
        )
    # padding rows keep comp=K*(1-B) > 0 to avoid div-by-zero on garbage tf=0
    comp[comp == 0.0] = 1.0
    sh.comp = comp

    # directory entries in level order: (hash, level, offset, len, max_impact)
    all_hash = np.concatenate([l.term_hash for l in levels])
    all_level = np.concatenate(
        [np.full(len(l.term_hash), i, dtype=np.int32) for i, l in enumerate(levels)]
    )
    all_off = np.concatenate(
        [base[i] + np.asarray(l.term_offset[:-1], dtype=np.int64)
         for i, l in enumerate(levels)]
    )
    all_len = np.concatenate(
        [np.diff(np.asarray(l.term_offset, dtype=np.int64)).astype(np.int32)
         for l in levels]
    )

    # primary field = largest total token count — needed up front: the
    # plain-posting mask keys on it
    from .schema import BM25_K

    f_star = _primary_field(levels, F)

    # per-posting default-boost impacts (stored for the Pallas decode fast
    # path) + per-(level, term) max impact, in level order
    pl_impact, all_max, plain_all, plain_cnt_all = _impact_loop(
        sh, levels, base, boosts, f_star)

    if expand_ngrams:
        (all_hash, all_level, all_off, all_len, all_max,
         pl_impact) = _expand_ngram_segments(
            sh, levels, base, comp, boosts,
            all_hash, all_level, all_off, all_len, all_max, pl_impact,
        )
    sh.pl_impact = pl_impact

    order = np.argsort(all_hash, kind="stable")
    sh_hash = all_hash[order]
    uniq_hash, first_idx, counts = np.unique(
        sh_hash, return_index=True, return_counts=True
    )
    seg_start = np.zeros(len(uniq_hash) + 1, dtype=np.int64)
    np.cumsum(counts, out=seg_start[1:])
    seg_len_sorted = all_len[order]
    df = np.add.reduceat(seg_len_sorted.astype(np.int64), first_idx)

    seg_block_sorted = all_level[order]
    seg_off_sorted = all_off[order]

    # dense-term store (tf-fallback path): (term, block) segments with
    # >= DENSE_MIN postings become dense u16 tf columns
    seg_dense = np.full(len(order), -1, np.int32)
    dense_sel = np.flatnonzero(seg_len_sorted >= DENSE_MIN)
    seg_dense[dense_sel] = np.arange(len(dense_sel), dtype=np.int32)
    F = sh.pl_tf.shape[1]
    _dense_from_dir(sh, seg_dense, seg_off_sorted, seg_len_sorted)

    # ---- impact path: presence bitmaps + rank-1 sat1 + CSR remainder ----
    # per-doc shared impact of a plain posting (tf == 1 in the primary
    # field only); float op order mirrors oracle.term_impacts exactly
    sat1 = ((np.float32(BM25_K + 1.0) / (np.float32(1.0) + comp[:, f_star]))
            * np.float32(boosts[f_star])).astype(np.float32)
    sh.sat1 = sat1

    # plain-posting mask over the full posting arrays (the native impact
    # pass computed it per level; n-gram expansion appends virtual
    # postings afterwards, so that case recomputes over the final arrays)
    if plain_all is not None and len(plain_all) == len(sh.pl_docid):
        plain = plain_all.view(bool)
    else:
        tf_sum = sh.pl_tf.astype(np.int64).sum(axis=1)
        plain = (sh.pl_tf[:, f_star] == 1) & (tf_sum == 1)
        plain_cnt_all = None

    # bitmap segment selection: >= BITMAP_MIN postings AND >= BITMAP_MIN
    # of them plain (the CSR memory breakeven, see BITMAP_MIN)
    cand = np.flatnonzero(seg_len_sorted >= BITMAP_MIN)
    if plain_cnt_all is not None:
        pcs_cand = plain_cnt_all[order][cand].astype(np.int64)
    else:
        pcs_cand = np.array(
            [int(plain[int(seg_off_sorted[e]):
                       int(seg_off_sorted[e]) + int(seg_len_sorted[e])]
                 .sum()) for e in cand], np.int64)
    qual = pcs_cand >= BITMAP_MIN
    bm_sel = cand[qual]
    seg_bitmap = np.full(len(order), -1, np.int32)
    seg_bitmap[bm_sel] = np.arange(len(bm_sel), dtype=np.int32)
    csr_total = int(seg_len_sorted.astype(np.int64).sum()
                    - pcs_cand[qual].sum())
    stash_lens = np.minimum(STASH_K, pcs_cand[qual])
    dev_total = csr_total + int(stash_lens.sum())

    seg_dev_len, seg_stash_off, seg_stash_len = _dev_pass(
        sh, seg_off_sorted, seg_len_sorted, seg_block_sorted, seg_bitmap,
        bm_sel, plain, pl_impact, sat1, csr_total, dev_total)
    seg_dev_offset = np.zeros(len(order) + 1, np.int64)
    np.cumsum(seg_dev_len, out=seg_dev_offset[1:])
    seg_dev_offset = seg_dev_offset[:-1]

    sh.directory = TermDirectory(
        hash=uniq_hash,
        df=df,
        seg_start=seg_start,
        seg_block=seg_block_sorted,
        seg_offset=seg_off_sorted,
        seg_len=seg_len_sorted,
        seg_max_impact=all_max[order],
        seg_dense=seg_dense,
        seg_dev_offset=seg_dev_offset,
        seg_dev_len=seg_dev_len,
        seg_bitmap=seg_bitmap,
        seg_stash_off=seg_stash_off,
        seg_stash_len=seg_stash_len,
    )
    return sh


def _expand_ngram_segments(
    sh: ShardLexical, levels, base, comp, boosts,
    all_hash, all_level, all_off, all_len, all_max, pl_impact,
):
    """Constituent-tf expansion of n-gram posting lists (Bm25f semantics,
    reference add_result.rs:868-915 / search.rs:3235-3260).

    For each n-gram term (name contains NGRAM_SEP) of each level:
      * the MAIN segment's tfs are replaced with constituent-1's per-field
        tfs in the same docs (joined against constituent-1's own postings);
      * constituents 2..k get appended virtual posting rows + directory
        entries under `ngram_virtual_hash(h, j)`.
    The query planner weights each segment by its constituent's idf.
    """
    from .ngram import NGRAM_SEP
    from .utils import ngram_virtual_hash, term_hash

    v_hash, v_level, v_off, v_len, v_max = [], [], [], [], []
    v_docid, v_tf, v_imp = [], [], []
    vpos = len(sh.pl_docid)

    hash_cache: dict[str, int] = {}

    def _h(part: str) -> int:
        h = hash_cache.get(part)
        if h is None:
            h = hash_cache[part] = term_hash(part)
        return h

    t0_of_level = np.zeros(len(levels) + 1, np.int64)
    np.cumsum([len(x.term_hash) for x in levels], out=t0_of_level[1:])

    for i, l in enumerate(levels):
        if not l.term_names:
            continue
        names = np.asarray(l.term_names, dtype=object)
        ng_idx = np.flatnonzero(
            np.frompyfunc(lambda s: NGRAM_SEP in s, 1, 1)(names)
            .astype(bool))
        if not len(ng_idx):
            continue
        T_l = len(l.term_hash)
        offs = np.asarray(l.term_offset, np.int64)
        counts = np.diff(offs)
        # a level's postings are globally sorted by (term, docid): every
        # constituent join below is ONE vectorized searchsorted over this
        # key array (the per-(ngram, constituent) python joins cost 20+
        # minutes per 1M-doc n-gram build)
        keys = ((np.repeat(np.arange(T_l, dtype=np.int64), counts) << 16)
                | l.docid.astype(np.int64))
        tf_lvl = np.asarray(l.tf)

        split_parts = [names[t].split(NGRAM_SEP) for t in ng_idx]
        max_parts = max(len(p) for p in split_parts)
        parts_by_j: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for j in range(max_parts):
            tlist, hl = [], []
            for t, p in zip(ng_idx, split_parts):
                if len(p) > j and offs[t + 1] > offs[t]:
                    tlist.append(int(t))
                    hl.append(_h(p[j]))
            parts_by_j[j] = (np.asarray(tlist, np.int64),
                            np.asarray(hl, np.uint64))

        for j in range(max_parts):
            tsel, phash = parts_by_j[j]
            if not len(tsel):
                continue
            a_t = offs[tsel]
            n_t = counts[tsel]
            total = int(n_t.sum())
            if total == 0:
                continue
            # flat posting rows of the n-gram segments
            rows_g = (np.repeat(a_t, n_t)
                      + np.arange(total, dtype=np.int64)
                      - np.repeat(np.cumsum(n_t) - n_t, n_t))
            gdoc = l.docid[rows_g].astype(np.int64)
            # constituent term index per n-gram (vectorized hash lookup)
            ci = np.searchsorted(l.term_hash, phash)
            cic = np.minimum(ci, max(T_l - 1, 0))
            cfound = (ci < T_l) & (l.term_hash[cic] == phash)
            # one join: row of (constituent, doc) in the level postings
            qkey = (np.repeat(np.where(cfound, cic, 0), n_t) << 16) | gdoc
            pos = np.searchsorted(keys, qkey)
            posc = np.minimum(pos, len(keys) - 1)
            found = ((pos < len(keys)) & (keys[posc] == qkey)
                     & np.repeat(cfound, n_t))
            tf_c = np.where(found[:, None], tf_lvl[posc],
                            tf_lvl[rows_g])
            comps_g = comp[i * BLOCK_SIZE + gdoc]
            imp_c = term_impacts(tf_c, comps_g, boosts)
            seg_starts = np.cumsum(n_t) - n_t
            seg_max = np.maximum.reduceat(imp_c, seg_starts)
            if j == 0:
                flat_rows = base[i] + rows_g
                sh.pl_tf[flat_rows] = tf_c
                pl_impact[flat_rows] = imp_c
                all_max[t0_of_level[i] + tsel] = seg_max
            else:
                for e in range(len(tsel)):
                    t = int(tsel[e])
                    s, n = int(seg_starts[e]), int(n_t[e])
                    v_hash.append(
                        ngram_virtual_hash(int(l.term_hash[t]), j + 1))
                    v_level.append(i)
                    v_off.append(vpos)
                    v_len.append(n)
                    v_max.append(float(seg_max[e]))
                    v_docid.append(l.docid[rows_g[s : s + n]])
                    v_tf.append(tf_c[s : s + n])
                    v_imp.append(imp_c[s : s + n])
                    vpos += n

    if v_hash:
        sh.pl_docid = np.concatenate([sh.pl_docid] + v_docid)
        sh.pl_tf = np.concatenate([sh.pl_tf] + v_tf, axis=0)
        pl_impact = np.concatenate([pl_impact] + v_imp)
        all_hash = np.concatenate([all_hash, np.array(v_hash, np.uint64)])
        all_level = np.concatenate([all_level, np.array(v_level, np.int32)])
        all_off = np.concatenate([all_off, np.array(v_off, np.int64)])
        all_len = np.concatenate([all_len, np.array(v_len, np.int32)])
        all_max = np.concatenate([all_max, np.array(v_max, np.float32)])
    return all_hash, all_level, all_off, all_len, all_max, pl_impact
