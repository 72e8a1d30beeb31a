"""Search on a torch device.

Port of the entry points of ``seekstorm_tpu/search.py``
(``search``/``search_batch`` and ``_lexical_search_batch``).
``SearchMode.Vector`` and ``SearchMode.Hybrid`` batches go to
``vector_search.py`` (the IVF scan, kernel K4, and RRF fusion), as in the
reference; what follows is the lexical path.
The request/result types and the host functions (parsing, idf, the
realtime tail merge, phrase verification, result assembly and the
empty-query browse, each with its facet, filter and sort branches) are
copies of the reference's; the device dispatch is the port's.

A batch routes as the reference routes it:

  * WAND (``ops/wand.run_batch``) for queries of at most 8 slots when
    ``wand_auto`` holds (indexes of 16 blocks and up, or
    ``SEEKSTORM_TPU_WAND=1``; ``SEEKSTORM_TPU_NO_WAND=1`` turns it off) and
    pages end at 1024 or less;
  * the posting-space join (``ops/join.py`` through
    ``StackedIndex.run_join``; seekstorm_tpu/search.py:1614-1644) for the
    rows WAND left, in Topk batches without counts, phrases, facets,
    filters or sorts whose pages end at STASH_K (64) or less, on indexes
    without deletes, where every slot of a query fits a posting window
    and at most one is a bitmap term.  It is on where the searching
    device is the CPU, as in the reference, and off on CUDA
    (``_join_backend_ok``); ``SEEKSTORM_TPU_JOIN=1``/``0`` overrides;
  * the dense path (``plan.py``, ``parallel/mesh.StackedIndex``, kernel
    K2) for the rest: smaller indexes, longer queries, deeper pages, and
    the WAND stragglers deferred at batch >= 512 that the join did not
    take.  Its plans prune blocks by upper bound unless counts or phrases
    need full coverage, and a pruned batch whose k-th score falls below
    an unscored bound re-runs in full.

Facet counts (``query_facets``), facet filters (``facet_filter``) and sorted
results (``result_sort``) ride both routes as in the reference: the filter
as packed disallowed words beside the deleted words, the counts by kernel K3
(``ops/facet_hist.py``) from the scans' matched words, with full coverage;
a sorted batch takes the dense path (its unfused scan, ranked by the sort
key) unless ``SEEKSTORM_TPU_WAND_SORT`` sends a one-key sort to WAND's
rank-by-key mode.  The auxiliary columns (facet codes, sort key, filter
words) are laid out by global block, shards end to end, as both routes'
device state is, and cached on that state.

``field_filter`` zeroes the boosts of the fields it leaves out.  Where that
changes the boost profile the batch takes the tf path, as in the reference
(search.py:1427-1439): commit-time impacts hold the schema's boosts, so its
plans (``plan_shard(mode="tf")``) range over the full postings and
``ops/lexical.tf_scan_pairs`` recombines the per-field term frequencies at
query time.  Such a batch skips the WAND route and the pruned query-tiled
plan; counts, facets, a facet filter, a sort and deep pages ride it as they
ride the dense path.  A ``field_filter`` naming every indexed field leaves
the profile as it is and takes the routes above.

``ResultType.Count`` takes WAND's phase-1 popcount on the WAND route and
the dense path's counts elsewhere.  The device is explicit:
``device="cuda"`` without CUDA raises.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from . import facets as facets_mod
from . import geo as geo_mod
from . import plan as plan_mod
from .index import Index, Shard
from .lexindex import STASH_K
from .metrics import METRICS
from .ngram import NGRAM_SEP
from .oracle import verify_phrase
from .ops import wand as wand_mod
from .parallel import mesh
from .rewrite import rewrite_query
from .schema import BLOCK_SIZE, FieldType
from .tail import BatchTails, TailView, score_pairs, select, slot_weights
from .tokenizer import ParsedQuery, parse_query
from .utils import ceil_pow2, ngram_virtual_hash, term_hash

MAX_PAGE = 1024    # deepest offset + length the WAND route serves


# ---------------------------------------------------------------------------
# request and result types (seekstorm_tpu/search.py:58-171)


class QueryType(str, enum.Enum):
    """(reference search.rs:59-69)"""

    Union = "Union"
    Intersection = "Intersection"
    Phrase = "Phrase"
    Not = "Not"


class ResultType(str, enum.Enum):
    """(reference search.rs:168-176)"""

    Count = "Count"
    Topk = "Topk"
    TopkCount = "TopkCount"


class SearchMode(str, enum.Enum):
    Lexical = "Lexical"
    Vector = "Vector"
    Hybrid = "Hybrid"


@dataclass
class Ranges:
    """Named numeric/geo ranges for a range facet (reference search.rs:388-420
    Ranges enum + RangeType :220-228)."""

    field: str
    ranges: list                 # [(label, start)] — bucket i is [start_i, start_{i+1})
    range_type: str = "CountWithinRange"  # | CountAboveRange | CountBelowRange
    base: object = None          # Point ranges: (lat, lon) base for distance buckets
    unit: str = "Kilometers"


@dataclass
class QueryFacet:
    field: str
    length: int = 10           # top-N values returned
    ranges: Ranges | None = None


@dataclass
class FacetFilter:
    field: str
    values: list | None = None       # string/equality filter
    range: tuple | None = None       # numeric [min, max] inclusive


@dataclass
class ResultSort:
    field: str
    order: str = "Descending"        # or "Ascending"
    base: object = None              # geo base point for Point fields


@dataclass
class Highlight:
    field: str
    fragment_number: int = 1
    fragment_size: int = 160
    highlight_markup: bool = True


@dataclass
class SearchRequest:
    """(reference SearchRequestObject index.rs:137-211)"""

    query: str = ""
    offset: int = 0
    length: int = 10
    result_type: ResultType = ResultType.TopkCount
    realtime: bool = True
    query_type_default: QueryType = QueryType.Union
    field_filter: list[str] = dfield(default_factory=list)
    fields: list[str] = dfield(default_factory=list)         # doc fields to return
    highlights: list[Highlight] = dfield(default_factory=list)
    query_facets: list[QueryFacet] = dfield(default_factory=list)
    facet_filter: list[FacetFilter] = dfield(default_factory=list)
    result_sort: list[ResultSort] = dfield(default_factory=list)
    search_mode: SearchMode = SearchMode.Lexical
    query_vector: list | None = None
    top_n: int = 10                  # vector candidates per shard
    ann_mode: str = "All"            # All | Nprobe | SimilarityThreshold | NprobeSimilarityThreshold
    nprobe: int = 0                  # clusters to probe (Nprobe modes)
    similarity_threshold: float | None = None
    distance_fields: list = dfield(default_factory=list)
    # 'SearchOnly' | {'SearchSuggest'|'SearchRewrite'|'SuggestOnly': {...}}
    query_rewriting: object = "SearchOnly"


@dataclass
class ResultObject:
    doc_id: int
    score: float
    doc: dict | None = None


@dataclass
class ResultSet:
    results: list[ResultObject] = dfield(default_factory=list)
    result_count: int = 0
    result_count_total: int = 0
    count_exact: bool = True
    facets: dict = dfield(default_factory=dict)
    suggestions: list = dfield(default_factory=list)
    query_terms: list = dfield(default_factory=list)
    time_us: float = 0.0
    # vector-search work counters (reference observed_vector_count /
    # observed_cluster_count, search.rs:200-204): candidate vectors
    # scanned and clusters visited for this query, summed over shards
    observed_vector_count: int = 0
    observed_cluster_count: int = 0


# ---------------------------------------------------------------------------
# per-batch lexical planning (seekstorm_tpu/search.py:177-436)


@dataclass
class _Slot:
    hash: int
    term: str
    dir_idx: list  # per shard: directory index or -1
    # n-gram constituent scoring (Bm25f, reference add_result.rs:868-915):
    # idf_hash redirects this slot's df/idf to a constituent term; tf_hash
    # is set on slots whose tail postings join against a constituent's tfs
    # (committed levels carry the join pre-materialized, lexindex.py).
    idf_hash: int | None = None
    tf_hash: int | None = None
    virtual: bool = False   # weight-only companion slot of an n-gram


@dataclass
class _QuerySpec:
    slots: list[int]            # slot ids used by this query (non-negated + negated)
    weights: dict               # slot -> 1.0 (scoring, non-negated) — idf applied per shard
    required: dict              # slot -> bool
    negated: dict               # slot -> bool
    phrases: list[list]         # phrase groups: [(slot_id, token_offset)], in order
    parsed: ParsedQuery


def _build_specs(
    index: Index, queries: list[str], default_types: list[QueryType]
) -> tuple[list[_Slot], list[_QuerySpec]]:
    with METRICS.timer("search_parse"):
        from .ngram import segment_phrase

        flags = index.meta.ngram_indexing
        frequent = getattr(index, "_frequent_words", frozenset())
        expand = getattr(index, "_expand_ngrams", False)

        slot_of: dict[int, int] = {}
        slots: list[_Slot] = []
        specs: list[_QuerySpec] = []

        def get_slot(term: str) -> int:
            h = term_hash(term)
            if h not in slot_of:
                slot_of[h] = len(slots)
                if expand and NGRAM_SEP in term:
                    parts = term.split(NGRAM_SEP)
                    slots.append(_Slot(h, term, [],
                                       idf_hash=term_hash(parts[0]),
                                       tf_hash=term_hash(parts[0])))
                else:
                    slots.append(_Slot(h, term, []))
            return slot_of[h]

        def get_virtual_slots(term: str, h: int) -> list[int]:
            """Weight-only companion slots for constituents 2..k of an n-gram
            (Bm25f constituent scoring; see
            lexindex._expand_ngram_segments)."""
            parts = term.split(NGRAM_SEP)
            out = []
            for j in range(2, len(parts) + 1):
                vh = ngram_virtual_hash(h, j)
                if vh not in slot_of:
                    slot_of[vh] = len(slots)
                    slots.append(_Slot(vh, term, [],
                                       idf_hash=term_hash(parts[j - 1]),
                                       tf_hash=term_hash(parts[j - 1]),
                                       virtual=True))
                out.append(slot_of[vh])
            return out

        for q, default_type in zip(queries, default_types):
            pq = parse_query(q, index.analyzer)
            weights: dict[int, float] = {}
            required: dict[int, bool] = {}
            negated: dict[int, bool] = {}
            phrase_groups: list[list] = []

            phrase_term_idx = {i for ph in pq.phrases for i in ph}
            implicit_phrase = (
                default_type == QueryType.Phrase
                and not pq.phrases
                and sum(1 for t in pq.terms if not t.negated) > 1
            )

            def add_term(term: str, req: bool, neg: bool):
                s_ = get_slot(term)
                if s_ in negated and negated[s_] and not neg:
                    negated[s_] = False  # positive occurrence wins
                if s_ not in negated:
                    negated[s_] = neg
                required[s_] = required.get(s_, False) or (req and not neg)
                if not negated[s_]:
                    weights[s_] = 1.0
                    if expand and NGRAM_SEP in term:
                        for vs in get_virtual_slots(term, slots[s_].hash):
                            weights[vs] = 1.0
                            negated.setdefault(vs, False)
                return s_

            def add_phrase(tokens: list[str], neg: bool):
                # n-gram segment rewriting (reference NGRAM_SEARCH.md:60-80)
                if flags and frequent:
                    segments = segment_phrase(tokens, frequent, flags)
                else:
                    segments = [(t, i, 1) for i, t in enumerate(tokens)]
                group = []
                for term, off, _ln in segments:
                    s_ = add_term(term, True, neg)
                    group.append((s_, off))
                if len(group) >= 1 and not neg:
                    phrase_groups.append(group)

            for i, t in enumerate(pq.terms):
                if i in phrase_term_idx or implicit_phrase:
                    continue
                neg = t.negated or default_type == QueryType.Not
                req = t.required or default_type in (
                    QueryType.Intersection, QueryType.Phrase
                )
                add_term(t.term, req, neg)

            for ph in pq.phrases:
                tokens = [pq.terms[i].term for i in ph]
                add_phrase(tokens, pq.terms[ph[0]].negated)
            if implicit_phrase:
                tokens = [t.term for t in pq.terms if not t.negated]
                add_phrase(tokens, False)
                for t in pq.terms:
                    if t.negated:
                        add_term(t.term, False, True)

            # single-segment phrases are exact by construction (the n-gram or
            # single term IS the phrase) — no position verification needed
            phrase_groups = [g for g in phrase_groups if len(g) > 1]

            specs.append(
                _QuerySpec(
                    slots=sorted(
                        set(list(weights)
                            + [s for s, n in negated.items() if n])
                    ),
                    weights=weights,
                    required=required,
                    negated=negated,
                    phrases=phrase_groups,
                    parsed=pq,
                )
            )
        return slots, specs


def _wand_facet_codes(index, state, codes_list) -> np.ndarray:
    """Facet code columns [S, nb*BLOCK] -> the global-block layout
    i32[NF, nblk*BLOCK] of `state` (a WandState or a StackedIndex: both lay
    the shards' blocks end to end).  Facet columns are stored per level =
    per block, so this is a copy per shard."""
    out = np.zeros((len(codes_list), state.nblk * BLOCK_SIZE), np.int32)
    for fi, codes in enumerate(codes_list):
        for s, sh in enumerate(index.shards):
            n = sh.lexical.n_blocks * BLOCK_SIZE
            g0 = state.block_base[s] * BLOCK_SIZE
            out[fi, g0: g0 + n] = codes[s, :n]
    return out


def _wand_rank_key(index, state, skey_host, sort_desc: bool) -> np.ndarray:
    """Sort-key column [S, nb*BLOCK] -> the global rank array
    f32[nblk*BLOCK] (larger ranks first: an ascending order negates).
    Positions with no committed doc are -inf, so a bucket's best rank stays
    tight (the column's padding is 0.0, which would beat negative ranks)."""
    out = np.full(state.nblk * BLOCK_SIZE, -np.inf, np.float32)
    for s, sh in enumerate(index.shards):
        g0 = state.block_base[s] * BLOCK_SIZE
        for li, lvl in enumerate(sh.lexical.levels):
            n = lvl.doc_count
            seg = skey_host[s, li * BLOCK_SIZE: li * BLOCK_SIZE + n]
            seg = seg.astype(np.float32)
            out[g0 + li * BLOCK_SIZE: g0 + li * BLOCK_SIZE + n] = \
                seg if sort_desc else -seg
    return out


def _wand_filter_words(index, state, mask) -> np.ndarray:
    """Facet-filter allowed mask bool[S, nb*BLOCK] -> packed DISALLOWED
    words u32[nblk, BLOCK//32] in the global-block layout (ANDed out of
    matching exactly like the deleted-doc words)."""
    nw = BLOCK_SIZE // 32
    out = np.zeros((state.nblk, nw), np.uint32)
    for s, sh in enumerate(index.shards):
        nb = sh.lexical.n_blocks
        dis = np.ascontiguousarray(~mask[s, :nb * BLOCK_SIZE])
        # bit j of word w = doc w*32+j (little-endian, as the deleted words)
        words = np.packbits(dis, bitorder="little").view(np.uint32)
        out[state.block_base[s]: state.block_base[s] + nb] = \
            words.reshape(nb, nw)
    return out


def _shard_idf(shard: Shard, slots: list[_Slot], realtime: bool,
               hs: np.ndarray | None = None,
               found: np.ndarray | None = None,
               ti_c: np.ndarray | None = None,
               tails: BatchTails | None = None) -> np.ndarray:
    """Per-shard per-slot BM25 idf, realtime-df aware — the single source of
    truth for the dense planner (_plan_shard), the WAND path (ops/wand.py)
    and the join.

    hs/found/ti_c are _plan_shard's already-computed directory lookups for
    the slots' own hashes; recomputed when absent.  `tails` are the
    batch's realtime tails, whose view of this shard the tail merge
    scores; without them the shard's tail is read here."""
    lex = shard.lexical
    d = lex.directory
    if d is None or len(d.hash) == 0:
        # shard with no committed terms (all docs hashed elsewhere):
        # every slot is absent, idf contribution zero
        return np.zeros(len(slots), np.float32)
    T = len(d.hash)
    if hs is None:
        hs = np.array([sl.hash for sl in slots], dtype=np.uint64)
        ti_all = np.searchsorted(d.hash, hs)
        found = ti_all < T
        ti_c = np.minimum(ti_all, max(T - 1, 0))
        found &= (d.hash[ti_c] == hs) if T else False

    # idf df: n-gram slots redirect to their constituent's df (reference
    # posting_count_ngram_N, search.rs:3235-3260)
    df = np.where(found, d.df[ti_c], 0)
    idf_hs = np.array(
        [sl.idf_hash if sl.idf_hash is not None else sl.hash
         for sl in slots], dtype=np.uint64)
    if not np.array_equal(idf_hs, hs):
        ci_all = np.searchsorted(d.hash, idf_hs)
        cfound = (ci_all < T)
        ci_c = np.minimum(ci_all, max(T - 1, 0))
        cfound &= (d.hash[ci_c] == idf_hs) if T else False
        df = np.where(cfound, d.df[ci_c], df)

    # doc counts / dfs incl. realtime tail for idf
    n_docs = lex.doc_count
    df_total = df.copy()
    if realtime:
        tail = (tails.get(shard) if tails is not None
                else TailView(shard, slots))
        n_docs += tail.n_tail
        df_total = df_total + tail.idf_df(slots)
    return np.where(
        df_total > 0,
        np.log1p((n_docs - df_total + 0.5) / (df_total + 0.5)),
        0.0,
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# posting-space join (ops/join.py; seekstorm_tpu/search.py:795-1043): work
# per query follows its terms' posting counts instead of the corpus size

JOIN_V_MAX = 4          # slots per query on the join path
JOIN_PW_CAP = 1 << 17   # max window lanes per slot


def _join_backend_ok(device) -> bool:
    """Whether Topk batches searched on `device` may take the join: on the
    CPU, where per-element gathers are cheap, as in the reference; not on
    CUDA, whose default waits for a measurement against the WAND and dense
    routes.  SEEKSTORM_TPU_JOIN=1/0 overrides either way."""
    ov = os.environ.get("SEEKSTORM_TPU_JOIN")
    if ov is not None:
        return ov not in ("0", "false")
    return torch.device(device).type == "cpu"


def _join_shard_infos(index: Index, slots: list[_Slot], realtime: bool,
                      tails: BatchTails | None = None):
    """Per-shard join-path planning state: slot posting-window layouts
    (cached on the shard between commits) + per-shard idf (over the
    batch's `tails`).  Returns None when any shard disqualifies the path
    (deletes, stale format, too many blocks)."""
    hs = np.array([sl.hash for sl in slots], dtype=np.uint64)
    V = len(slots)
    out = []
    for shard in index.shards:
        lex = shard.lexical
        d = lex.directory
        if (d is None or getattr(d, "seg_stash_off", None) is None
                or lex.n_blocks > 4095 or shard.deleted):
            return None
        T = len(d.hash)
        ti = np.searchsorted(d.hash, hs)
        found = ti < T
        tc = np.minimum(ti, max(T - 1, 0))
        found &= (d.hash[tc] == hs) if T else False
        idf = _shard_idf(shard, slots, realtime, hs=hs, found=found,
                         ti_c=tc, tails=tails)

        cache = getattr(lex, "_join_cache", None)
        if cache is None:
            cache = lex._join_cache = {}
        wins = []
        sa = np.where(found, d.seg_start[tc], 0)
        sb = np.where(found, d.seg_start[np.minimum(tc + 1, T)], 0)
        for v in range(V):
            h = int(hs[v])
            w = cache.get(h)
            if w is None:
                w = _join_slot_window(d, int(sa[v]), int(sb[v]))
                cache[h] = w
            wins.append(w)
        out.append({"wins": wins, "idf": idf, "n_blocks": lex.n_blocks})
    return out


_JOIN_EMPTY = {
    "rows": np.zeros(0, np.int32), "a0": 0, "la": 0, "b0": 0, "lb": 0,
    "mk_lane": np.zeros(0, np.int64), "mk_blk": np.zeros(0, np.int32),
    "bm_blk": np.zeros(0, np.int32), "bm_row": np.zeros(0, np.int32),
    "has_bm": False, "nr": 0,
}


def _join_slot_window(d, a: int, b: int):
    """Posting-window layout of one term on one shard: storage rows
    spanning the compacted-CSR range [dev_off, dev_off+len) plus the
    bitmap-segment stash range, segment-start lane markers, and bitmap
    rows per block.  None when the term exceeds the join-path caps."""
    if b <= a:
        return _JOIN_EMPTY
    devl = np.asarray(d.seg_dev_len[a:b], np.int64)
    devo = np.asarray(d.seg_dev_offset[a:b], np.int64)
    blks = np.asarray(d.seg_block[a:b], np.int32)
    so = np.asarray(d.seg_stash_off[a:b], np.int64)
    sl_ = np.asarray(d.seg_stash_len[a:b], np.int64)
    bmr = np.asarray(d.seg_bitmap[a:b], np.int32)
    ln = int(devl.sum())
    off = int(devo[0])
    st_total = int(sl_.sum())
    sm = sl_ > 0
    st_off = int(so[sm][0]) if st_total else 0
    NRa = 0 if ln == 0 else (off + ln - 1) // 128 - off // 128 + 1
    NRb = (0 if st_total == 0
           else (st_off + st_total - 1) // 128 - st_off // 128 + 1)
    if (NRa + NRb) * 128 > JOIN_PW_CAP or st_total >= (1 << 13):
        return None
    a0 = off % 128 if ln else 0
    b0 = NRa * 128 + (st_off % 128) if st_total else 0
    rows = np.concatenate([
        np.arange(off // 128, off // 128 + NRa, dtype=np.int32),
        np.arange(st_off // 128, st_off // 128 + NRb, dtype=np.int32),
    ])
    am = devl > 0
    mk_lane = np.concatenate([a0 + (devo[am] - off), b0 + (so[sm] - st_off)])
    mk_blk = np.concatenate([blks[am], blks[sm]]).astype(np.int32)
    has_bm = bool((bmr >= 0).any())
    return {
        "rows": rows, "a0": a0, "la": ln, "b0": int(b0), "lb": st_total,
        "mk_lane": mk_lane.astype(np.int64), "mk_blk": mk_blk,
        "bm_blk": blks[bmr >= 0], "bm_row": bmr[bmr >= 0],
        "has_bm": has_bm, "nr": int(NRa + NRb),
    }


def _join_query_ok(spec: _QuerySpec, infos) -> bool:
    """A query rides the join path iff every slot fits a posting window in
    every shard and at most one slot is bitmap-backed anywhere."""
    if len(spec.slots) > JOIN_V_MAX or not spec.weights:
        return False
    n_bm = 0
    for s in spec.slots:
        bm = False
        for sh_info in infos:
            w = sh_info["wins"][s]
            if w is None:
                return False
            bm |= w["has_bm"]
        n_bm += bm
    return n_bm <= 1


def _build_join_plans(index: Index, slots, jspecs, infos, k: int):
    """Per-shard join plans as numpy arrays (the reference packs the same
    arrays into one i32 buffer a shard): a dict per shard of rows i32[B, V,
    NR], packA / packB i32[B, V], segp i32[B, V, NS], rowtab i32[B, NBp]
    (shard-local bitmap rows), W f32[B, V], isreq / isneg bool[B, V] and
    nreq i32[B], and the statics NR, NS, PW, NBp, has_bm and k of the whole
    batch.  The reference pads B to a power of two to bound its compiled
    shapes; rows are independent, so B stays as it is here."""
    B = len(jspecs)
    # global slot classification: bitmap-backed in ANY shard -> last slot
    bm_global = {
        s: any(info["wins"][s]["has_bm"] for info in infos)
        for spec in jspecs for s in spec.slots
    }
    order = []
    for spec in jspecs:
        csr = [s for s in spec.slots if not bm_global[s]]
        bms = [s for s in spec.slots if bm_global[s]]
        row = csr + [-1] * (JOIN_V_MAX - len(csr) - len(bms)) + bms
        order.append(row)
    has_bm = any(bm_global.values())
    V = JOIN_V_MAX

    NR = 1
    NS = 1
    for info in infos:
        for spec, row in zip(jspecs, order):
            for s in row:
                if s < 0:
                    continue
                w = info["wins"][s]
                NR = max(NR, w["nr"])
                NS = max(NS, len(w["mk_lane"]))
    NR = ceil_pow2(NR, 2)
    NS = ceil_pow2(NS, 2)
    PW = NR * 128
    NBp = ceil_pow2(max(i["n_blocks"] for i in infos), 16)

    plans = []
    for info in infos:
        wins = info["wins"]
        idf = info["idf"]
        rows = np.full((B, V, NR), -1, np.int32)
        packA = np.zeros((B, V), np.int32)
        packB = np.zeros((B, V), np.int32)
        segp = np.full((B, V, NS), -1, np.int32)
        rowtab = np.full((B, NBp), -1, np.int32)
        W = np.zeros((B, V), np.float32)
        isreq = np.zeros((B, V), bool)
        isneg = np.zeros((B, V), bool)
        nreq = np.zeros(B, np.int32)
        for qi, (spec, row) in enumerate(zip(jspecs, order)):
            nr_q = 0
            for vi, s in enumerate(row):
                if s < 0:
                    continue
                w = wins[s]
                n = len(w["rows"])
                rows[qi, vi, :n] = w["rows"]
                packA[qi, vi] = (w["a0"] << 24) | w["la"]
                packB[qi, vi] = (w["b0"] << 13) | w["lb"]
                m = len(w["mk_lane"])
                if m:
                    segp[qi, vi, :m] = (
                        (w["mk_lane"] << 12) | w["mk_blk"]
                    ).astype(np.int32)
                neg = spec.negated.get(s, False)
                req = spec.required.get(s, False) and not neg
                isreq[qi, vi] = req
                isneg[qi, vi] = neg
                if not neg and s in spec.weights:
                    W[qi, vi] = idf[s]
                if req:
                    nr_q += 1
                if vi == V - 1 and len(w["bm_blk"]):
                    rowtab[qi, w["bm_blk"]] = w["bm_row"]
            nreq[qi] = nr_q
        plans.append(dict(rows=rows, packA=packA, packB=packB, segp=segp,
                          rowtab=rowtab, W=W, isreq=isreq, isneg=isneg,
                          nreq=nreq))
    statics = dict(V=V, NR=NR, NS=NS, NBp=NBp, PW=PW, has_bm=has_bm, k=k)
    return plans, statics


# ---------------------------------------------------------------------------
# public entry points


def resolve_device(device) -> torch.device:
    """torch.device for `device`; CUDA without a card raises instead of
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def search(index: Index, request: SearchRequest,
           device="cuda") -> ResultSet:
    return search_batch(index, [request], device=device)[0]


def search_batch(index: Index, requests: list[SearchRequest],
                 device="cuda") -> list[ResultSet]:
    """Execute a batch of lexical, vector or hybrid searches on `device`.

    Requests with different settings are grouped (one dispatch per
    group); queries and paging may differ freely within a group.  With a
    mesh attached (``Index.attach_mesh``) the batch runs on the mesh's
    devices, whose family `device` must name."""
    with METRICS.batch():
        return _search_batch(index, requests, device)


def _search_batch(index: Index, requests: list[SearchRequest],
                  device) -> list[ResultSet]:
    dev = resolve_device(device)
    m = getattr(index, "_mesh", None)
    if m is not None and m.lead.type != dev.type:
        raise ValueError(f"device {device!r} named for an index whose mesh "
                         f"runs on {m.lead.type}")
    if len(requests) > 1:
        sig0 = _req_signature(requests[0])
        if any(_req_signature(r) != sig0 for r in requests[1:]):
            groups: dict[tuple, list[int]] = {}
            for i, r in enumerate(requests):
                groups.setdefault(_req_signature(r), []).append(i)
            out: list = [None] * len(requests)
            for idxs in groups.values():
                sub = search_batch(index, [requests[i] for i in idxs], dev)
                for i, rs in zip(idxs, sub):
                    out[i] = rs
            return out

    METRICS.inc("queries_total", len(requests))
    index.ensure_loaded()
    t0 = time.perf_counter()
    req0 = requests[0]

    # query rewriting (QAC / spelling, rewrite.py)
    outcomes = None
    if any(r.query_rewriting not in (None, "SearchOnly") for r in requests
           ) and req0.search_mode != SearchMode.Vector:
        outcomes = [rewrite_query(index, r.query, r.query_rewriting,
                                  index.analyzer) for r in requests]
        if all(isinstance(r.query_rewriting, dict)
               and next(iter(r.query_rewriting)) == "SuggestOnly"
               for r in requests):
            res = []
            for oc in outcomes:
                rs = ResultSet(suggestions=oc.suggestions)
                rs.time_us = (time.perf_counter() - t0) * 1e6
                res.append(rs)
            return res
        requests = [dataclasses.replace(r, query=oc.query)
                    for r, oc in zip(requests, outcomes)]
        req0 = requests[0]

    if req0.search_mode == SearchMode.Vector:
        from .vector_search import vector_search_batch

        out = vector_search_batch(index, requests, dev)
    elif req0.search_mode == SearchMode.Hybrid:
        from .vector_search import hybrid_search_batch

        out = hybrid_search_batch(index, requests, dev)
    else:
        out = _lexical_search_batch(index, requests, dev)
    dt = (time.perf_counter() - t0) * 1e6 / max(len(requests), 1)
    METRICS.observe("search_batch", dt * 1e-6 * max(len(requests), 1))
    for i, r in enumerate(out):
        r.time_us = dt
        if outcomes is not None:
            r.suggestions = outcomes[i].suggestions
    return out


def _req_signature(r: SearchRequest) -> tuple:
    """Batch-compatibility key: everything except the query text/vector
    and paging (one device launch per distinct signature)."""
    return (
        r.result_type, r.realtime,
        tuple(r.field_filter), tuple(r.fields),
        tuple((h.field, h.fragment_number, h.fragment_size,
               h.highlight_markup) for h in r.highlights),
        tuple((qf.field, qf.length, repr(qf.ranges))
              for qf in r.query_facets),
        tuple((f.field, tuple(f.values) if f.values else None,
               tuple(f.range) if f.range else None)
              for f in r.facet_filter),
        tuple((s.field, s.order, repr(s.base)) for s in r.result_sort),
        r.search_mode, r.ann_mode, r.nprobe, r.similarity_threshold,
        r.top_n, tuple(map(repr, r.distance_fields)),
        repr(r.query_rewriting),
    )


def exact_pages(index: Index, requests: list[SearchRequest],
                device="cuda") -> list[tuple[int, list[int], list[float]]]:
    """The host exact evaluation (_exact_fallback) of each request's
    committed page, bypassing the device ladder: [(count, gids, scores)].
    A check of the WAND path; it ignores the realtime tail."""
    slots, specs = _build_specs(index, [r.query for r in requests],
                                [r.query_type_default for r in requests])
    state = wand_mod.get_state(index, resolve_device(device))
    idf = np.stack([_shard_idf(sh, slots, requests[0].realtime)
                    for sh in index.shards])
    with state.lock:
        state.ensure_slots([s.hash for s in slots])
        rows = {i: state.slot_cache[s.hash] for i, s in enumerate(slots)}
    out = []
    for r, spec in zip(requests, specs):
        n = r.offset + r.length
        sc, gid, count = wand_mod._exact_fallback(
            state, rows, spec, idf, index.shard_count, n)
        out.append((count, gid[r.offset:n].tolist(), sc[r.offset:n].tolist()))
    return out


def dense_plans(index: Index, requests: list[SearchRequest],
                device="cuda", mode: str = "imp"):
    """The dense path's full-coverage plans of a batch (every candidate
    block of every query, one DensePlan or None per shard) and the index's
    StackedIndex on `device`.  ``stacked.pair_tables(plans)`` gives the
    (block, query) pairs kernel K2 scans for this batch, a way to hold K2
    against its plain version at a batch's real shapes; with mode="tf", the
    pairs the tf scan scores for a field_filter batch."""
    slots, specs = _build_specs(index, [r.query for r in requests],
                                [r.query_type_default for r in requests])
    plans = [plan_mod.plan_shard(index, sh, slots, specs,
                                 requests[0].realtime, True,
                                 plan_mod.PRUNE_BLOCKS, mode=mode)
             for sh in index.shards]
    return plans, mesh.get_stacked(index, resolve_device(device))


def join_plans(index: Index, requests: list[SearchRequest],
               device="cuda"):
    """The posting-space join's inputs for a batch as its route builds
    them: (rows, plans, statics, stacked) with the batch rows whose every
    slot fits a window, the per-shard plans and statics of
    _build_join_plans for those rows, and the index's StackedIndex on
    `device` (``stacked.run_join(plans, statics)`` runs them); rows is
    empty and plans None when a shard disqualifies the join (deletes).  A
    way to size the join's work at a batch's real windows."""
    slots, specs = _build_specs(index, [r.query for r in requests],
                                [r.query_type_default for r in requests])
    stacked = mesh.get_stacked(index, resolve_device(device))
    infos = _join_shard_infos(index, slots, requests[0].realtime)
    rows = [] if infos is None else [
        i for i, sp in enumerate(specs) if _join_query_ok(sp, infos)]
    if not rows:
        return rows, None, None, stacked
    need = max(r.offset + r.length for r in requests)
    plans, statics = _build_join_plans(index, slots,
                                       [specs[i] for i in rows], infos,
                                       ceil_pow2(max(need, 10), 16))
    return rows, plans, statics, stacked


def wand_inputs(index: Index, requests: list[SearchRequest],
                device="cuda") -> tuple:
    """Kernel K1's arguments for the WAND-eligible queries of a batch, as
    its dispatch passes them to ``ops/wand_scan.scan_blocks``: the resident
    pools with the batch's term rows, its slots joined to pool rows, and
    its per-query tables on `device`.  A way to hold K1 against its plain
    version, and to time it, at a batch's real shapes."""
    slots, specs = _build_specs(index, [r.query for r in requests],
                                [r.query_type_default for r in requests])
    idf = np.stack([_shard_idf(sh, slots, requests[0].realtime)
                    for sh in index.shards])
    state = wand_mod.get_state(index, resolve_device(device))
    with state.lock:
        slotmap, tslot, treq, tneg, wsh, _ = wand_mod.plan_batch(
            state, slots, [sp for sp in specs if wand_mod.query_ok(sp)],
            idf)
        ppool, vpool, _, _, sp_prow, _, delw, sid = state.pools
    slotmap, tslot, treq, tneg, wsh = [
        torch.from_numpy(a).to(state.device)
        for a in (slotmap, tslot, treq, tneg, wsh)]
    return (ppool, vpool, wand_mod.batch_prow(sp_prow, slotmap), delw, None,
            tslot, treq, tneg, wsh, sid)


def _warm_facets_ok(r, entry, warm_k) -> bool:
    """Cached facets serve the request iff every requested facet is a
    plain (no ranges) histogram the warmup computed, shallow enough that
    the cached depth is exact."""
    if not r.query_facets:
        return True
    if len(entry) < 4:
        return False
    return all(qf.ranges is None and qf.field in entry[3]
               and qf.length <= warm_k for qf in r.query_facets)


def _lexical_search_batch(index: Index, requests: list[SearchRequest],
                          device: torch.device) -> list[ResultSet]:
    req0 = requests[0]
    slots, specs = _build_specs(
        index, [r.query for r in requests],
        [r.query_type_default for r in requests])

    # the realtime tails this batch reads, one view a shard
    tails = BatchTails(slots, req0.realtime)

    results: list[ResultSet | None] = [None] * len(requests)
    live: list[int] = []
    warm = getattr(index, "_warmup_cache", None) or {}
    warm_k = getattr(index, "_warmup_k", 0)
    for i, (r, spec) in enumerate(zip(requests, specs)):
        if not r.query.strip():
            results[i] = _empty_query_results(index, r)
        elif not spec.weights:
            results[i] = ResultSet()
        elif (
            warm
            and len(spec.weights) == 1
            and not spec.phrases
            and not any(spec.negated.values())
            and not r.facet_filter
            and not r.result_sort
            and r.offset + r.length <= warm_k
            and (not r.realtime
                 or all(sh.tail_len() == 0 for sh in index.shards))
            and slots[next(iter(spec.weights))].hash in warm
            and _warm_facets_ok(
                r, warm[slots[next(iter(spec.weights))].hash], warm_k)
        ):
            # frequent-word cached result (the reference's warmup cache;
            # string-facet histograms are served from the same entry)
            entry = warm[slots[next(iter(spec.weights))].hash]
            scores, gids, total = entry[:3]
            rs = ResultSet()
            rs.result_count_total = int(total)
            pg = slice(r.offset, r.offset + r.length)
            rs.results = [ResultObject(doc_id=int(g), score=float(sc))
                          for sc, g in zip(scores[pg], gids[pg])]
            rs.result_count = len(rs.results)
            rs.query_terms = [slots[s2].term for s2 in spec.weights
                              if not slots[s2].virtual]
            if r.query_facets:
                rs.facets = {qf.field: entry[3][qf.field][: qf.length]
                             for qf in r.query_facets}
            _attach_docs(index, r, rs)
            results[i] = rs
        else:
            live.append(i)
    if not live:
        return [r or ResultSet() for r in results]

    live_specs = [specs[i] for i in live]
    with_counts = req0.result_type in (ResultType.Count,
                                       ResultType.TopkCount)
    has_phrase = any(s.phrases for s in live_specs)
    # paging may differ within a group; k follows the deepest page
    need = max(r.offset + r.length for r in requests)
    k = ceil_pow2(max(need, 10), 16)
    if has_phrase:
        k = ceil_pow2(max(4 * need + 64, 128))
    # boost profile (seekstorm_tpu/search.py:1427-1439): field_filter zeroes
    # the fields it leaves out; a profile other than the schema's, which the
    # commit-time impacts hold, takes the tf path
    boosts = index.boosts_or_default().copy()
    mode = "imp"
    if req0.field_filter:
        keep = set(req0.field_filter)
        for sf in index.indexed_fields:
            if sf.field not in keep:
                boosts[sf.indexed_field_id] = 0.0
        if not np.array_equal(boosts, index.boosts_or_default()):
            mode = "tf"

    B = len(live)
    merged_scores = [np.zeros(0, np.float32) for _ in range(B)]
    merged_ids = [np.zeros(0, np.int64) for _ in range(B)]
    counts = np.zeros(B, dtype=np.int64)
    counts_exact = np.ones(B, dtype=bool)
    tail_phrase_counts = np.zeros(B, dtype=np.int64)
    need_full = with_counts or has_phrase

    # facet filter, facet codes and sort key (seekstorm_tpu/search.py:
    # 1452-1513): host columns from the facet runtime; each route lays them
    # out by global block and caches them on its device state
    rt = None
    mask = fsig = None
    if req0.facet_filter:
        rt = facets_mod.get_runtime(index)
        fsig = tuple(
            (f.field, tuple(f.values) if f.values else None,
             tuple(f.range) if f.range else None)
            for f in req0.facet_filter)
        mask = rt.filter_mask(req0.facet_filter)

    facet_specs = []
    fkey = None
    fcm = 1
    if req0.query_facets:
        rt = rt or facets_mod.get_runtime(index)
        for qf in req0.query_facets:
            _, labels, nc = rt.codes_for(qf)
            facet_specs.append((qf, labels, nc))
        fcm = ceil_pow2(max(nc for _, _, nc in facet_specs), 16)
        fkey = ("facets", tuple(
            (qf.field,
             tuple((r[0], float(r[1])) for r in qf.ranges.ranges)
             if qf.ranges else None)
            for qf, _, _ in facet_specs))
        need_full = True    # facet counting covers every matched doc

    def facet_codes(state):
        return _wand_facet_codes(index, state, [rt.codes_for(qf)[0]
                                                for qf, _, _ in facet_specs])

    sorting = bool(req0.result_sort)
    sort_desc = True
    skey_host = skey_sig = None
    if sorting:
        rt = rt or facets_mod.get_runtime(index)
        rs0 = req0.result_sort[0]
        sort_desc = rs0.order != "Ascending"
        skey_host = rt.sort_key(rs0)
        skey_sig = ("sort", rs0.field,
                    tuple(rs0.base) if rs0.base is not None else None)
        need_full = True    # score pruning is invalid under a sort key
        k = ceil_pow2(max(4 * need, 64))

    fc_total = np.zeros((max(len(facet_specs), 1), B, fcm), np.int64)

    # Sorted batches ride WAND only on request (the reference's
    # SEEKSTORM_TPU_WAND_SORT): rank-by-key bounds are a bucket's best key,
    # which prunes only where sort keys cluster with insertion order
    wand_sort_ok = (not req0.result_sort
                    or bool(os.environ.get("SEEKSTORM_TPU_WAND_SORT")))
    wanded = np.zeros(B, bool)
    if (mode == "imp"
            and need <= MAX_PAGE
            and not (req0.facet_filter and mask is None)
            and len(req0.result_sort) <= 1
            and wand_sort_ok
            and wand_mod.wand_auto(index)):
        wrows = [i for i in range(B) if wand_mod.query_ok(live_specs[i])]
        if wrows:
            wstate = wand_mod.get_state(index, device)
            wfcod_dev = None
            if facet_specs:
                _, wfcod_dev = wstate.aux(fkey, lambda: facet_codes(wstate))
            wfilt_dev = wfilt_host = None
            if mask is not None:
                wfilt_host, wfilt_dev = wstate.aux(
                    ("filter", fsig),
                    lambda: _wand_filter_words(index, wstate, mask))
            wskeyb_dev = wrank_host = None
            if sorting:
                wrank_host, _ = wstate.aux(
                    skey_sig + (sort_desc, "flat"),
                    lambda: _wand_rank_key(index, wstate, skey_host,
                                           sort_desc), device=False)
                _, wskeyb_dev = wstate.aux(
                    skey_sig + (sort_desc, "bmax"),
                    lambda: wrank_host.reshape(-1, 32).max(axis=1)
                    .reshape(wstate.nblk, BLOCK_SIZE // 32))
            idf_ps = np.stack([_shard_idf(sh, slots, req0.realtime,
                                          tails=tails)
                               for sh in index.shards])      # [S, V]
            wsc, wgid, wcnt, wfc, whandled = wand_mod.run_batch(
                index, slots, [live_specs[i] for i in wrows], idf_ps,
                max(need, 1), with_counts, device,
                count_only=req0.result_type == ResultType.Count,
                fcod_dev=wfcod_dev, n_facets=len(facet_specs), fcm=fcm,
                filtw_dev=wfilt_dev, filt_host=wfilt_host,
                skeyb_dev=wskeyb_dev, rank_key_host=wrank_host)
            for r, qi in enumerate(wrows):
                if whandled[r]:
                    merged_scores[qi] = wsc[r]
                    merged_ids[qi] = wgid[r]
                    counts[qi] = wcnt[r]
                    wanded[qi] = True
                    if wfc is not None:
                        fc_total[:len(facet_specs), qi] += wfc[:, r, :fcm]

    # posting-space join (seekstorm_tpu/search.py:1614-1644): Topk batches
    # whose queries fit posting windows; work per query follows its terms'
    # posting counts, exact with no pruning.  Queries that do not fit (huge
    # windows, two bitmap terms, deep pages) stay on the dense path
    joined = np.zeros(B, bool)
    if (mode == "imp"
            and not with_counts and not has_phrase
            and not req0.query_facets and not req0.facet_filter
            and not req0.result_sort
            and k <= STASH_K
            and _join_backend_ok(device)):
        infos = _join_shard_infos(index, slots, req0.realtime, tails)
        jrows = []
        if infos is not None:
            with METRICS.timer("lex_plan"):
                jrows = [i for i, sp in enumerate(live_specs)
                         if not wanded[i] and _join_query_ok(sp, infos)]
                if jrows:
                    jplans, statics = _build_join_plans(
                        index, slots, [live_specs[i] for i in jrows], infos,
                        k)
        if jrows:
            METRICS.inc("device_dispatch_total")
            ts_j, gid_j = mesh.get_stacked(index, device).run_join(jplans,
                                                                   statics)
            METRICS.inc("join_rows_total", len(jrows))
            for r, qi in enumerate(jrows):
                valid = np.isfinite(ts_j[r])
                merged_scores[qi] = ts_j[r][valid].astype(np.float32)
                merged_ids[qi] = gid_j[r][valid].astype(np.int64)
                joined[qi] = True

    rest_rows = [i for i in range(B) if not joined[i] and not wanded[i]]
    if rest_rows:
        stacked = mesh.get_stacked(index, device)
        aux = dict(fcm=fcm, sort_desc=sort_desc)
        if mode == "tf":
            aux["boosts"] = boosts
        if facet_specs:
            aux["fcod"] = stacked.aux_device(fkey,
                                             lambda: facet_codes(stacked))
        if sorting:
            aux["skey"] = stacked.aux_device(
                skey_sig, lambda: _wand_rank_key(index, stacked, skey_host,
                                                 True))
        if mask is not None:
            # the reference ORs the disallowed docs into the deleted mask
            # (_merge_deleted); here, the packed words
            aux["disallowed"] = stacked.aux_device(
                ("filter", fsig),
                lambda: (stacked.delw_host
                         | _wand_filter_words(index, stacked, mask)
                         ).view(np.int32))
        ts, gid, cnt, fcounts, all_full = _dense_rows(
            index, slots, [live_specs[i] for i in rest_rows], req0.realtime,
            need_full, need, k, with_counts, stacked,
            filtered=bool(req0.facet_filter), aux=aux, mode=mode,
            tails=tails)
        if ts is not None:
            for r, qi in enumerate(rest_rows):
                valid = np.isfinite(ts[r])
                merged_scores[qi] = ts[r][valid]
                merged_ids[qi] = gid[r][valid]
            if with_counts and all_full:
                counts[rest_rows] += cnt
            elif with_counts:
                counts_exact[:] = False
            if facet_specs and all_full:
                fc_total[:len(facet_specs), rest_rows] += \
                    fcounts[:len(facet_specs)]

    # WAND pages are deduped and (score desc, gid asc) ordered; join and
    # dense pages and a tail merge are not, and _finalize_lexical re-sorts
    # them
    canonical = wanded.copy()
    for shard in index.shards:
        tail = tails.get(shard)
        if tail is not None and tail.n_tail > 0:
            _merge_tail(index, tail, slots, live_specs, boosts,
                        merged_scores, merged_ids, counts, with_counts,
                        req0, facet_specs, fc_total, fcm, sorting, sort_desc,
                        tail_phrase_counts=tail_phrase_counts)
            canonical[:] = False
    return _finalize_lexical(index, requests, results, live, live_specs,
                             slots, merged_scores, merged_ids, counts,
                             counts_exact, with_counts, facet_specs,
                             fc_total, sorting, sort_desc,
                             tail_phrase_counts=tail_phrase_counts,
                             phrase_escalate_ok=mode == "imp",
                             canonical=canonical, tails=tails)


def _compact_slots(slots, specs):
    """The reference's slot-table compaction (search.py:1665-1687): when
    the rows left for the dense path use under a quarter of the batch's
    slots, plan them over a table of just those slots (same order)."""
    used = sorted({s for sp in specs for s in sp.slots})
    if len(used) >= len(slots) // 4:
        return slots, specs
    remap = {s: j for j, s in enumerate(used)}
    return [slots[s] for s in used], [
        _QuerySpec(
            slots=[remap[s] for s in sp.slots],
            weights={remap[s]: w for s, w in sp.weights.items()},
            required={remap[s]: v for s, v in sp.required.items()},
            negated={remap[s]: v for s, v in sp.negated.items()},
            phrases=[[(remap[s], off) for s, off in grp]
                     for grp in sp.phrases],
            parsed=sp.parsed)
        for sp in specs]


def _dense_rows(index, slots, specs, realtime: bool, need_full: bool,
                need: int, k: int, with_counts: bool, stacked,
                filtered: bool = False, aux=None, mode: str = "imp",
                tails: BatchTails | None = None):
    """The dense path for `specs` (search.py:1646-1750) on the index's
    StackedIndex, in impact mode or, for a batch with a boost profile of
    its own, tf mode: plan every shard, scan, and re-run in full when a
    pruned plan's k-th score falls below a bound it left unscored.  aux:
    the batch's facet codes, sort key, filter words and (tf mode) boosts
    for StackedIndex.run; `tails`, the batch's realtime tails, for the
    idf.  Returns (ts f32[B, k], gid i64[B, k], cnt i64[B],
    fcounts i64[NF, B, fcm], all_full), or Nones when no shard selected a
    block."""
    aux = aux or {}
    stats = wand_mod.route_stats(index)
    cover_full = need_full or not stats.prune_ok()
    # Topk batches on large shards plan like the reference's query-tiled
    # kernel, which prunes as soon as candidates pass PRUNE_BLOCKS; a facet
    # filter keeps a batch off that plan, as in the reference
    if (mode == "imp" and not cover_full and not filtered and max(
            sh.lexical.n_blocks
            for sh in index.shards) >= plan_mod.QT_MIN_BLOCKS):
        mode = "qt"
    slots, specs = _compact_slots(slots, specs)

    def plans_for(full: bool):
        with METRICS.timer("lex_plan"):
            return [plan_mod.plan_shard(index, sh, slots, specs, realtime,
                                        full, plan_mod.PRUNE_BLOCKS,
                                        mode=mode, tails=tails)
                    for sh in index.shards]

    plans = plans_for(cover_full)
    if all(p is None for p in plans):
        return None, None, None, None, True
    METRICS.inc("device_dispatch_total")
    all_full = all(p is None or p.full for p in plans)
    with METRICS.timer("lex_device"):
        ts, gid, cnt, fcounts = stacked.run(plans, k,
                                            with_counts and all_full, **aux)
    if not all_full:
        ub = np.zeros(len(specs), np.float32)
        for p in plans:
            if p is not None:
                ub = np.maximum(ub, p.ub_unscored)
        kth = ts[:, min(need, k) - 1]
        escalate = bool(((kth < ub) | ~np.isfinite(kth)).any())
        stats.record_prune(escalate)
        if escalate:
            METRICS.inc("plan_escalations_total")
            METRICS.inc("device_dispatch_total")
            plans = plans_for(True)
            with METRICS.timer("lex_device"):
                ts, gid, cnt, fcounts = stacked.run(plans, k, with_counts,
                                                    **aux)
            all_full = True
    return ts, gid, cnt, fcounts, all_full


# ---------------------------------------------------------------------------
# host assembly (seekstorm_tpu/search.py:1173-1340, 1882-2336)


def _empty_query_results(index: Index, req: SearchRequest) -> ResultSet:
    """Empty-query browse path (reference search.rs:1413 -> iterator.rs):
    supports facet_filter, query_facets and result_sort over all docs
    (reference enable_empty_query semantics)."""
    rs = ResultSet()
    index.ensure_loaded()

    # match-all mask over all docs (committed + tail), host columnar
    rt = facets_mod.get_runtime(index) if (
        req.facet_filter or req.query_facets or req.result_sort
    ) else None

    gids = []
    keep = []
    for shard in index.shards:
        n = shard.doc_count
        local = np.arange(n, dtype=np.int64)
        mask = np.ones(n, dtype=bool)
        if shard.deleted:
            dl = np.fromiter(shard.deleted, dtype=np.int64)
            dl = dl[dl < n]
            mask[dl] = False
        if rt is not None and req.facet_filter:
            allowed = rt.filter_mask(req.facet_filter)
            if allowed is not None:
                am = allowed[shard.shard_id]
                committed = min(n, shard.committed_doc_count, am.shape[0])
                mask[:committed] &= am[local[:committed]]
                # tail docs: evaluate from level-0 values
                for li in range(committed, n):
                    ok = True
                    for f in req.facet_filter:
                        sf = index.schema_map[f.field]
                        vals = shard.level0.facet_values.get(sf.facet_id, [])
                        ti = li - shard.full_levels * BLOCK_SIZE
                        v = vals[ti] if 0 <= ti < len(vals) else None
                        if f.values is not None:
                            if sf.field_type.is_string_facet:
                                tab = getattr(index, "_facet_tables", {}).get(
                                    sf.facet_id, {"": 0})
                                want = {tab.get(str(x), -1) for x in f.values}
                                sets = getattr(index, "_facet_set_tables",
                                               {}).get(sf.facet_id)
                                if sets is not None:
                                    members = next(
                                        (m for m, so in sets.items()
                                         if so == v), ())
                                    ok &= bool(want & set(members))
                                else:
                                    ok &= v in want
                            else:
                                ok &= v in [float(x) for x in f.values]
                        elif f.range is not None and v is not None:
                            lo, hi = f.range
                            ok &= lo <= v <= hi
                        else:
                            ok &= v is not None
                    if not ok:
                        mask[li] = False
        sel = local[mask]
        gids.append(sel * index.shard_count + shard.shard_id)
        keep.append((shard, sel))
    all_gids = np.concatenate(gids) if gids else np.zeros(0, np.int64)
    rs.result_count_total = int(len(all_gids))

    # ordering: docid asc by default, or result_sort keys
    if rt is not None and req.result_sort:
        rs0 = req.result_sort[0]
        key = rt.sort_key(rs0)  # [S, N]
        kvals = np.zeros(len(all_gids), np.float32)
        pos = 0
        for shard, sel in keep:
            committed_cols = key.shape[1]
            kv = np.zeros(len(sel), np.float32)
            inb = sel < committed_cols
            kv[inb] = key[shard.shard_id, sel[inb]]
            kvals[pos : pos + len(sel)] = kv
            pos += len(sel)
        order = np.lexsort((all_gids, -kvals if rs0.order != "Ascending"
                            else kvals))
        all_gids = all_gids[order]
        kvals = kvals[order]
    else:
        order = np.argsort(all_gids, kind="stable")
        all_gids = all_gids[order]
        kvals = None

    page = all_gids[req.offset : req.offset + req.length]
    if kvals is not None:
        pk = kvals[req.offset : req.offset + req.length]
        rs.results = [ResultObject(doc_id=int(g), score=float(v))
                      for g, v in zip(page, pk)]
    else:
        rs.results = [ResultObject(doc_id=int(g), score=0.0) for g in page]
    rs.result_count = len(rs.results)

    # facet counting over all matching docs
    if rt is not None and req.query_facets:
        rs.facets = {}
        for qf in req.query_facets:
            codes, labels, nc = rt.codes_for(qf)
            sf = index.schema_map[qf.field]
            vec = np.zeros(max(nc, 1), np.float64)
            for shard, sel in keep:
                committed = shard.committed_doc_count
                inb = sel[sel < committed]
                c = codes[shard.shard_id, inb]
                np.add.at(vec, np.clip(c, 0, nc - 1), 1)
                # tail docs: codes from level-0 facet values
                tail_sel = sel[sel >= committed]
                if len(tail_sel):
                    vals = shard.level0.facet_values.get(sf.facet_id, [])
                    base2 = shard.full_levels * BLOCK_SIZE
                    raw = [vals[g - base2] if 0 <= g - base2 < len(vals)
                           else None for g in tail_sel]
                    if qf.ranges is not None:
                        if sf.field_type == FieldType.Point:
                            lat = np.array([v[0] if v else 0.0 for v in raw])
                            lon = np.array([v[1] if v else 0.0 for v in raw])
                            code_col = geo_mod.point_distance(
                                geo_mod.encode_morton_2_d(lat, lon),
                                float(qf.ranges.base[0]),
                                float(qf.ranges.base[1]))
                            if qf.ranges.unit == "Miles":
                                code_col = code_col * 0.621371192
                        else:
                            code_col = np.array(
                                [0 if v is None else v for v in raw],
                                np.float64)
                        bounds = np.array([float(r[1])
                                           for r in qf.ranges.ranges])
                        cc = np.searchsorted(bounds, code_col, side="right")
                    else:
                        cc = np.array([0 if v is None else int(v)
                                       for v in raw], np.int64)
                    np.add.at(vec, np.clip(cc, 0, nc - 1), 1)
            if qf.ranges is not None and qf.ranges.range_type != \
                    "CountWithinRange":
                if qf.ranges.range_type == "CountAboveRange":
                    vec = np.cumsum(vec[::-1])[::-1]
                else:
                    vec = np.cumsum(vec)
            if isinstance(labels, tuple) and labels and labels[0] == "__SETS__":
                set_members = labels[1]
                vcounts = {}
                for so in np.flatnonzero(vec):
                    if so < len(set_members):
                        for v in set_members[so]:
                            vcounts[v] = vcounts.get(v, 0) + int(vec[so])
                pairs = sorted(vcounts.items(),
                               key=lambda kv2: (-kv2[1], str(kv2[0])))
            else:
                nz = np.flatnonzero(vec)
                pairs = sorted(
                    ((labels[c2] if labels else int(c2), int(vec[c2]))
                     for c2 in nz),
                    key=lambda kv2: (-kv2[1], str(kv2[0])),
                )
            rs.facets[qf.field] = pairs[: qf.length]

    _attach_docs(index, req, rs)
    return rs


def _slot_global_docids(index, slots, s) -> np.ndarray:
    """All committed global doc ids holding slot s (host posting lists)."""
    h = slots[s].hash
    out = []
    for shard in index.shards:
        lex = shard.lexical
        d = lex.directory
        ti = d.lookup(h)
        if ti < 0 or lex.pl_docid is None:
            continue
        for e in range(int(d.seg_start[ti]), int(d.seg_start[ti + 1])):
            a = int(d.seg_offset[e])
            ln = int(d.seg_len[e])
            ids = (lex.pl_docid[a : a + ln].astype(np.int64)
                   + int(d.seg_block[e]) * BLOCK_SIZE)
            out.append(ids * index.shard_count + shard.shard_id)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _phrase_exact_committed(index, slots, spec, request) -> np.ndarray:
    """Sorted global ids of committed docs matching the WHOLE query's
    phrase + required/negated/deleted (+ facet filter) constraints —
    exact phrase counting with no candidate cliff (reference gets this
    from per-doc position streams, add_result.rs:38-92)."""
    from .phrase import phrase_docs_global

    cand = phrase_docs_global(index, slots, spec)
    cand = np.sort(cand)
    phrase_slots = {s for ph in spec.phrases for s, _ in ph}
    for s, r in spec.required.items():
        if not r or spec.negated.get(s) or s in phrase_slots:
            continue
        if len(cand) == 0:
            break
        cand = cand[np.isin(cand, _slot_global_docids(index, slots, s))]
    for s, n_ in spec.negated.items():
        if not n_ or len(cand) == 0:
            continue
        cand = cand[~np.isin(cand, _slot_global_docids(index, slots, s))]
    S = index.shard_count
    for shard in index.shards:
        if shard.deleted and len(cand):
            dl = np.fromiter(shard.deleted, dtype=np.int64)
            cand = cand[~np.isin(cand, dl * S + shard.shard_id)]
    if request is not None and request.facet_filter and len(cand):
        rt = facets_mod.get_runtime(index)
        allowed = rt.filter_mask(request.facet_filter)
        if allowed is not None:
            sid = (cand % S).astype(np.int64)
            loc = (cand // S).astype(np.int64)
            okm = np.ones(len(cand), bool)
            for shard in index.shards:
                m = sid == shard.shard_id
                am = allowed[shard.shard_id]
                inb = loc[m] < am.shape[0]
                ok_part = np.zeros(int(m.sum()), bool)
                ok_part[inb] = am[loc[m][inb]]
                okm[m] = ok_part
            cand = cand[okm]
    return cand


def _score_gids(index, slots, spec, gids, realtime,
                tails: BatchTails | None = None) -> np.ndarray:
    """Exact imp-mode BM25F scores of arbitrary committed global ids from
    the host CSR (idf x stored impact, accumulated in ascending slot id,
    the same arithmetic as the device scorer); the idf over the batch's
    realtime `tails`."""
    S = index.shard_count
    out = np.zeros(len(gids), np.float32)
    if not len(gids):
        return out
    sid = (gids % S).astype(np.int64)
    loc = (gids // S).astype(np.int64)
    idf_by_shard = [_shard_idf(sh, slots, realtime, tails=tails)
                    for sh in index.shards]
    for t in sorted(spec.weights):
        if spec.negated.get(t):
            continue
        h = slots[t].hash
        for shard in index.shards:
            rows = np.flatnonzero(sid == shard.shard_id)
            if not len(rows):
                continue
            idf_t = np.float32(idf_by_shard[shard.shard_id][t])
            lex = shard.lexical
            d = lex.directory
            if d is None or lex.pl_docid is None:
                continue
            ti = d.lookup(h)
            if ti < 0:
                continue
            blocks = loc[rows] >> 16
            docids = (loc[rows] & 0xFFFF).astype(lex.pl_docid.dtype)
            for e in range(int(d.seg_start[ti]), int(d.seg_start[ti + 1])):
                bl = int(d.seg_block[e])
                a = int(d.seg_offset[e])
                ln = int(d.seg_len[e])
                if ln <= 0:
                    continue
                m = np.flatnonzero(blocks == bl)
                if not len(m):
                    continue
                pl = lex.pl_docid[a: a + ln]
                pos = np.searchsorted(pl, docids[m])
                pos = np.clip(pos, 0, ln - 1)
                hit = pl[pos] == docids[m]
                out[rows[m[hit]]] += idf_t * \
                    lex.pl_impact[a: a + ln][pos[hit]].astype(np.float32)
    return out


def _finalize_lexical(index, requests, results, live, live_specs, slots,
                      merged_scores, merged_ids, counts, counts_exact,
                      with_counts, facet_specs=(), fc_total=None,
                      sorting=False, sort_desc=True,
                      tail_phrase_counts=None, phrase_escalate_ok=True,
                      canonical=None, tails=None):
    with METRICS.timer("search_finalize"):
        # phrase verification + final assembly
        for bi, qi in enumerate(live):
            spec = live_specs[bi]
            scores, gids = merged_scores[bi], merged_ids[bi]
            if canonical is None or not canonical[bi]:
                # dedupe defensively (re-runs can concatenate duplicates)
                _, first = np.unique(gids, return_index=True)
                keepmask = np.zeros(len(gids), dtype=bool)
                keepmask[first] = True
                scores, gids = scores[keepmask], gids[keepmask]
                order = np.lexsort((gids, -scores))
                scores, gids = scores[order], gids[order]
            if spec.phrases:
                pd = None
                if with_counts:
                    # exact committed phrase-match set (host posting
                    # intersection + vectorized position join, phrase.py);
                    # retrieved results check membership, tail docs verify
                    # per doc
                    pd = _phrase_exact_committed(index, slots, spec,
                                                 requests[qi])
                    if len(gids):
                        S_ = index.shard_count
                        sid = (gids % S_).astype(np.int64)
                        loc = (gids // S_).astype(np.int64)
                        committed = np.array(
                            [index.shards[x].committed_doc_count for x in sid])
                        is_tail = loc >= committed
                        keep = np.isin(gids, pd)
                        for row in np.flatnonzero(is_tail):
                            keep[row] = _phrase_ok(index, slots, spec,
                                                   int(gids[row]))
                        scores, gids = scores[keep], gids[keep]
                    counts[bi] = len(pd) + (
                        int(tail_phrase_counts[bi])
                        if tail_phrase_counts is not None else 0)
                    counts_exact[bi] = True
                elif len(gids):
                    # Topk-only: the device candidates already satisfy the
                    # boolean/filter constraints — verify positional
                    # adjacency per retrieved candidate, in score order,
                    # stopping once the requested page is filled (instead of
                    # walking the full posting intersection)
                    want = requests[qi].offset + requests[qi].length
                    kept: list[int] = []
                    for row in range(len(gids)):
                        if _phrase_ok(index, slots, spec, int(gids[row])):
                            kept.append(row)
                            if len(kept) >= want:
                                break
                    scores, gids = scores[kept], gids[kept]
                # candidate-cliff escalation (reference parity: phrase checks
                # run on EVERY intersected doc, add_result.rs:38-92, so a
                # phrase match can never silently drop off a page): when the
                # verified page is short, rebuild it from the exact committed
                # phrase set, scored from the host CSR; verified realtime
                # tail rows keep their oracle scores.
                want = requests[qi].offset + requests[qi].length
                if (phrase_escalate_ok
                        and len(gids) < want
                        and not sorting
                        and not any(slots[s].virtual for s in spec.slots)):
                    if pd is None:
                        pd = _phrase_exact_committed(index, slots, spec,
                                                     requests[qi])
                    S_ = index.shard_count
                    if len(gids):
                        committed = np.array(
                            [index.shards[int(g % S_)].committed_doc_count
                             for g in gids])
                        is_tail = (gids // S_) >= committed
                        t_sc, t_g = scores[is_tail], gids[is_tail]
                    else:
                        t_sc = np.zeros(0, np.float32)
                        t_g = np.zeros(0, np.int64)
                    if len(pd) + len(t_g) > len(gids):
                        sc_pd = _score_gids(index, slots, spec, pd,
                                            requests[qi].realtime, tails)
                        allsc = np.concatenate([sc_pd, t_sc])
                        allg = np.concatenate([pd, t_g])
                        order3 = np.lexsort((allg, -allsc))
                        scores, gids = (allsc[order3].astype(np.float32),
                                        allg[order3])
            rs = ResultSet()
            rs.query_terms = [slots[s].term for s in spec.weights
                              if not slots[s].virtual]
            rs.result_count_total = int(counts[bi]) if with_counts else 0
            rs.count_exact = bool(counts_exact[bi])
            page = slice(requests[qi].offset,
                         requests[qi].offset + requests[qi].length)
            if sorting:
                # device rank = key (desc) or -key (asc); report the real key
                vals = scores if sort_desc else -scores
                # multi-key tie-breaking over the candidate window (reference
                # result_ordering_root min_heap.rs:56-545): sub-sort ties of
                # the primary key by the remaining sort fields using host columns
                sort_fields = requests[qi].result_sort
                if len(sort_fields) > 1 and len(gids):
                    rt2 = facets_mod.get_runtime(index)
                    keys = [(-vals if sort_fields[0].order != "Ascending"
                             else vals)]
                    for rs_f in sort_fields[1:]:
                        col = np.zeros(len(gids), np.float32)
                        for row, g in enumerate(gids):
                            v = rt2.raw_value(rs_f.field, int(g))
                            col[row] = 0.0 if v is None else float(v)
                        keys.append(-col if rs_f.order != "Ascending" else col)
                    keys.append(gids)
                    order2 = np.lexsort(tuple(reversed(keys)))
                    vals, gids = vals[order2], gids[order2]
                rs.results = [
                    ResultObject(doc_id=int(g), score=float(v))
                    for v, g in zip(vals[page], gids[page])
                ]
            else:
                # .tolist() yields native Python scalars in one C pass —
                # per-element int()/float() numpy-scalar unwrap was ~30% of
                # the assembly cost at large batch
                rs.results = [
                    ResultObject(doc_id=g, score=s)
                    for s, g in zip(scores[page].tolist(), gids[page].tolist())
                ]
            rs.result_count = len(rs.results)
            if facet_specs and fc_total is not None:
                rs.facets = {}
                for fi, (qf, labels, nc) in enumerate(facet_specs):
                    vec = fc_total[fi, bi, :nc].copy()
                    if qf.ranges is not None and qf.ranges.range_type != \
                            "CountWithinRange":
                        # cumulative range counts (reference RangeType
                        # search.rs:220-228, cumulation search.rs:3660-3764)
                        if qf.ranges.range_type == "CountAboveRange":
                            vec = np.cumsum(vec[::-1])[::-1]
                        elif qf.ranges.range_type == "CountBelowRange":
                            vec = np.cumsum(vec)
                    if isinstance(labels, tuple) and labels and \
                            labels[0] == "__SETS__":
                        # StringSet: expand set-ordinal histogram to value
                        # counts
                        set_members = labels[1]
                        vcounts: dict[str, int] = {}
                        for so in np.flatnonzero(vec):
                            if so < len(set_members):
                                for v in set_members[so]:
                                    vcounts[v] = (vcounts.get(v, 0)
                                                  + int(vec[so]))
                        pairs = sorted(
                            vcounts.items(),
                            key=lambda kv: (-kv[1], str(kv[0])),
                        )[: qf.length]
                    else:
                        nz = np.flatnonzero(vec)
                        pairs = sorted(
                            ((labels[c] if labels else int(c), int(vec[c]))
                             for c in nz),
                            key=lambda kv: (-kv[1], str(kv[0])),
                        )[: qf.length]
                    rs.facets[qf.field] = pairs
            _attach_docs(index, requests[qi], rs)
            results[qi] = rs

        return [r or ResultSet() for r in results]


def _merge_tail(
    index: Index, tail: TailView, slots, specs, boosts,
    merged_scores, merged_ids, counts, with_counts,
    req0=None, facet_specs=(), fc_total=None, fcm=1,
    sorting=False, sort_desc=True, tail_phrase_counts=None,
) -> None:
    """Score a shard's uncommitted level-0 tail, as the batch's view of it
    holds it, for every query of the batch in one pass over the batch's
    (query, posting) pairs (tail.py), and merge: counts, tail facet counts,
    the facet filter and sort keys over the tail, and each query's first
    min(n_tail, 1024) tail docs appended to its candidates."""
    shard = tail.shard
    n_tail, base = tail.n_tail, tail.base
    with METRICS.timer("tail_merge"):
        with METRICS.timer("tail_gather"):
            lex = shard.lexical
            indptr, pdoc, pimp, tail_df = tail.postings(
                slots, boosts, index._avg_len(shard))
            w = slot_weights(lex, slots, lex.doc_count + n_tail, tail_df)
            tail_deleted = np.zeros(n_tail, dtype=bool)
            for sid in shard.deleted:
                if base <= sid < base + n_tail:
                    tail_deleted[sid - base] = True

            # facet filter / codes / sort keys over the tail (host values)
            tail_vals = {}

            def _tail_col(field):
                sf = index.schema_map[field]
                if sf.facet_id in tail_vals:
                    return tail_vals[sf.facet_id]
                vals = shard.level0.facet_values.get(sf.facet_id, [])
                vv = vals[tail.start : tail.end]
                if sf.field_type == FieldType.Point:
                    lat = np.array([v[0] if v else 0.0 for v in vv])
                    lon = np.array([v[1] if v else 0.0 for v in vv])
                    col = geo_mod.encode_morton_2_d(lat, lon)
                else:
                    col = np.array(
                        [0 if v is None else v for v in vv], dtype=np.float64
                    )
                tail_vals[sf.facet_id] = col
                return col

            if req0 is not None and req0.facet_filter:
                for f in req0.facet_filter:
                    sf = index.schema_map[f.field]
                    col = _tail_col(f.field)
                    if f.values is not None:
                        if sf.field_type.is_string_facet:
                            tab = getattr(index, "_facet_tables", {}).get(
                                sf.facet_id, {"": 0}
                            )
                            vals = [tab.get(str(v), -1) for v in f.values]
                        else:
                            vals = [float(v) for v in f.values]
                        tail_deleted |= ~np.isin(col, vals)
                    elif f.range is not None:
                        lo, hi = f.range
                        tail_deleted |= ~((col >= lo) & (col <= hi))

            tail_key = None
            if sorting and req0 is not None and req0.result_sort:
                rs0 = req0.result_sort[0]
                sf = index.schema_map[rs0.field]
                col = _tail_col(rs0.field)
                if sf.field_type == FieldType.Point:
                    tail_key = geo_mod.point_distance(
                        col, float(rs0.base[0]), float(rs0.base[1])
                    ).astype(np.float32)
                else:
                    tail_key = col.astype(np.float32)

        # seconds of the scoring (with the count), then of the selection and
        # the append; facet counting in neither
        t_a = time.perf_counter()
        sp = score_pairs(specs, indptr, pdoc, pimp, w, n_tail, tail_deleted)
        mq, md = sp.q[sp.matched], sp.doc[sp.matched]
        if with_counts:
            phr = np.array([bool(spec.phrases) and tail_phrase_counts
                            is not None for spec in specs], bool)
            counts += np.bincount(mq[~phr[mq]], minlength=len(specs))
            # exact: phrase-verify every matched tail doc (the tail is
            # <= 64K docs; its phrase candidates are few)
            for qi, li in zip(mq[phr[mq]].tolist(), md[phr[mq]].tolist()):
                g = (li + base) * index.shard_count + shard.shard_id
                if _phrase_ok(index, slots, specs[qi], g):
                    tail_phrase_counts[qi] += 1
        score_s = time.perf_counter() - t_a
        if facet_specs and fc_total is not None:
            for fi, (qf, labels, nc) in enumerate(facet_specs):
                sf = index.schema_map[qf.field]
                col = _tail_col(qf.field)
                if qf.ranges is not None:
                    if sf.field_type == FieldType.Point:
                        col = geo_mod.point_distance(
                            col, float(qf.ranges.base[0]),
                            float(qf.ranges.base[1]),
                        )
                        if qf.ranges.unit == "Miles":
                            col = col * 0.621371192
                    bounds = np.array(
                        [float(r[1]) for r in qf.ranges.ranges])
                    codes = np.searchsorted(bounds, col, side="right")
                else:
                    codes = col.astype(np.int64)
                codes = np.clip(codes, 0, fcm - 1)
                np.add.at(fc_total[fi], (mq, codes[md]), 1)
        t_b = time.perf_counter()
        if sorting and tail_key is not None:
            rank = (tail_key if sort_desc else -tail_key)[md]
        else:
            rank = sp.score[sp.matched]
        bounds, ids, s2 = select(mq, md, rank, len(specs), min(n_tail, 1024))
        gids = (ids + base) * index.shard_count + shard.shard_id
        for qi in range(len(specs)):
            a, b = bounds[qi], bounds[qi + 1]
            merged_scores[qi] = np.concatenate([merged_scores[qi], s2[a:b]])
            merged_ids[qi] = np.concatenate([merged_ids[qi], gids[a:b]])
        METRICS.observe("tail_score", score_s)
        METRICS.observe("tail_select", time.perf_counter() - t_b)
        METRICS.inc("tail_entries_total", len(ids))
        METRICS.inc("tail_postings_total", sp.n_pairs)


def _phrase_ok(index: Index, slots, spec: _QuerySpec, global_id: int) -> bool:
    shard = index.shards[global_id % index.shard_count]
    local = global_id // index.shard_count
    for ph in spec.phrases:
        pos_by_term = []
        offsets = []
        for s, off in ph:
            h = slots[s].hash
            if local < shard.committed_doc_count:
                p = shard.lexical.get_positions(h, local)
            else:
                p = index.tail_positions(shard, h, local - shard.tail_start)
            if p is None:
                return False
            pos_by_term.append(p)
            offsets.append(off)
        if not verify_phrase(pos_by_term, offsets):
            return False
    return True


def _attach_docs(index: Index, req: SearchRequest, rs: ResultSet) -> None:
    if not req.fields and not req.highlights:
        return
    from .highlighter import highlight_doc

    for r in rs.results:
        doc = index.get_document(r.doc_id)
        if doc is None:
            continue
        if req.fields:
            doc = {k: v for k, v in doc.items() if k in req.fields}
        if req.highlights:
            doc = highlight_doc(index, req, doc)
        r.doc = doc


# bind as Index methods, on the index's own device unless told otherwise
Index.search = lambda self, request, device=None: search(
    self, request, self.device if device is None else device)
Index.search_batch = lambda self, requests, device=None: search_batch(
    self, requests, self.device if device is None else device)
