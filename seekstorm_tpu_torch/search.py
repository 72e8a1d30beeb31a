"""Lexical search on a torch device.

Port of the lexical entry points of ``seekstorm_tpu/search.py``
(``search``/``search_batch`` and ``_lexical_search_batch``, impact mode).
Parsing, idf, the realtime tail merge, phrase verification and result
assembly are the reference's host functions, imported unchanged; the
device dispatch is the port's.

A batch routes as the reference routes it:

  * WAND (``ops/wand.run_batch``) for queries of at most 8 slots when
    ``wand_auto`` holds (indexes of 16 blocks and up, or
    ``SEEKSTORM_TPU_WAND=1``; ``SEEKSTORM_TPU_NO_WAND=1`` turns it off) and
    pages end at 1024 or less;
  * the dense path (``plan.py``, ``parallel/mesh.StackedIndex``, kernel
    K2) for the rest: smaller indexes, longer queries, deeper pages, and
    the WAND stragglers deferred at batch >= 512.  Its plans prune blocks
    by upper bound unless counts or phrases need full coverage, and a
    pruned batch whose k-th score falls below an unscored bound re-runs
    in full.

``ResultType.Count`` takes WAND's phase-1 popcount on the WAND route and
the dense path's counts elsewhere.  The device is explicit:
``device="cuda"`` without CUDA raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from seekstorm_tpu.index import Index
from seekstorm_tpu.metrics import METRICS
from seekstorm_tpu.search import (ResultObject, ResultSet, ResultType,
                                  SearchMode, SearchRequest, _attach_docs,
                                  _build_specs, _empty_query_results,
                                  _finalize_lexical, _merge_tail,
                                  _QuerySpec, _req_signature, _shard_idf)
from seekstorm_tpu.utils import ceil_pow2

from . import plan as plan_mod
from .ops import wand as wand_mod
from .parallel import mesh

MAX_PAGE = 1024    # deepest offset + length the WAND route serves


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
    """Execute a batch of lexical searches on `device`.

    Requests with different settings are grouped (one dispatch per
    group); queries and paging may differ freely within a group."""
    dev = resolve_device(device)
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
    if req0.search_mode != SearchMode.Lexical:
        raise NotImplementedError(
            f"{req0.search_mode.value} search is not ported yet "
            "(ROADMAP A.8 vector)")

    # query rewriting (QAC / spelling): host code of the reference
    outcomes = None
    if any(r.query_rewriting not in (None, "SearchOnly") for r in requests):
        from seekstorm_tpu.rewrite import rewrite_query

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

    out = _lexical_search_batch(index, requests, dev)
    dt = (time.perf_counter() - t0) * 1e6 / max(len(requests), 1)
    METRICS.observe("search_batch", dt * 1e-6 * max(len(requests), 1))
    for i, r in enumerate(out):
        r.time_us = dt
        if outcomes is not None:
            r.suggestions = outcomes[i].suggestions
    return out


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
                device="cuda"):
    """The dense path's full-coverage plans of a batch (every candidate
    block of every query, one DensePlan or None per shard) and the index's
    StackedIndex on `device`.  ``stacked.pair_tables(plans)`` gives the
    (block, query) pairs kernel K2 scans for this batch, a way to hold K2
    against its plain version at a batch's real shapes."""
    slots, specs = _build_specs(index, [r.query for r in requests],
                                [r.query_type_default for r in requests])
    plans = [plan_mod.plan_shard(index, sh, slots, specs,
                                 requests[0].realtime, True,
                                 plan_mod.PRUNE_BLOCKS)
             for sh in index.shards]
    return plans, mesh.get_stacked(index, resolve_device(device))


def _unsupported(req0: SearchRequest) -> str | None:
    if req0.query_facets:
        return "query_facets (ROADMAP A.6 WAND facet histograms)"
    if req0.facet_filter:
        return "facet_filter (ROADMAP A.6 WAND batch filter)"
    if req0.result_sort:
        return "result_sort (ROADMAP A.6 WAND rank-by-key)"
    if req0.field_filter:
        return "field_filter (ROADMAP A.7 tf path)"
    return None


def _lexical_search_batch(index: Index, requests: list[SearchRequest],
                          device: torch.device) -> list[ResultSet]:
    req0 = requests[0]
    what = _unsupported(req0)
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet")
    slots, specs = _build_specs(
        index, [r.query for r in requests],
        [r.query_type_default for r in requests])

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
            and r.offset + r.length <= warm_k
            and (not r.realtime
                 or all(sh.tail_len() == 0 for sh in index.shards))
            and slots[next(iter(spec.weights))].hash in warm
        ):
            # frequent-word cached result (the reference's warmup cache)
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
    B = len(live)
    merged_scores = [np.zeros(0, np.float32) for _ in range(B)]
    merged_ids = [np.zeros(0, np.int64) for _ in range(B)]
    counts = np.zeros(B, dtype=np.int64)
    counts_exact = np.ones(B, dtype=bool)
    tail_phrase_counts = np.zeros(B, dtype=np.int64)

    wanded = np.zeros(B, bool)
    if need <= MAX_PAGE and wand_mod.wand_auto(index):
        wrows = [i for i in range(B) if wand_mod.query_ok(live_specs[i])]
        if wrows:
            idf_ps = np.stack([_shard_idf(sh, slots, req0.realtime)
                               for sh in index.shards])      # [S, V]
            wsc, wgid, wcnt, whandled = wand_mod.run_batch(
                index, slots, [live_specs[i] for i in wrows], idf_ps,
                max(need, 1), with_counts, device,
                count_only=req0.result_type == ResultType.Count)
            for r, qi in enumerate(wrows):
                if whandled[r]:
                    merged_scores[qi] = wsc[r]
                    merged_ids[qi] = wgid[r]
                    counts[qi] = wcnt[r]
                    wanded[qi] = True

    rest_rows = [i for i in range(B) if not wanded[i]]
    if rest_rows:
        need_full = with_counts or has_phrase
        ts, gid, cnt, all_full = _dense_rows(
            index, slots, [live_specs[i] for i in rest_rows], req0.realtime,
            need_full, need, k, with_counts, device)
        if ts is not None:
            for r, qi in enumerate(rest_rows):
                valid = np.isfinite(ts[r])
                merged_scores[qi] = ts[r][valid]
                merged_ids[qi] = gid[r][valid]
            if with_counts and all_full:
                counts[rest_rows] += cnt
            elif with_counts:
                counts_exact[:] = False

    # WAND pages are deduped and (score desc, gid asc) ordered; dense
    # pages and a tail merge are not, and _finalize_lexical re-sorts them
    canonical = wanded.copy()
    boosts = index.boosts_or_default().copy()
    for shard in index.shards:
        if req0.realtime and shard.tail_len() > 0:
            _merge_tail(index, shard, slots, live_specs, boosts,
                        merged_scores, merged_ids, counts, with_counts, req0,
                        tail_phrase_counts=tail_phrase_counts)
            canonical[:] = False
    return _finalize_lexical(index, requests, results, live, live_specs,
                             slots, merged_scores, merged_ids, counts,
                             counts_exact, with_counts,
                             tail_phrase_counts=tail_phrase_counts,
                             phrase_escalate_ok=True, canonical=canonical)


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
                need: int, k: int, with_counts: bool, device):
    """The dense path for `specs` (search.py:1646-1750, impact mode):
    plan every shard, scan, and re-run in full when a pruned plan's k-th
    score falls below a bound it left unscored.  Returns (ts f32[B, k],
    gid i64[B, k], cnt i64[B], all_full), or Nones when no shard selected
    a block."""
    stats = wand_mod.route_stats(index)
    cover_full = need_full or not stats.prune_ok()
    # Topk batches on large shards plan like the reference's query-tiled
    # kernel, which prunes as soon as candidates pass PRUNE_BLOCKS
    mode = ("qt" if not cover_full and max(
        sh.lexical.n_blocks for sh in index.shards) >= plan_mod.QT_MIN_BLOCKS
        else "imp")
    slots, specs = _compact_slots(slots, specs)

    def plans_for(full: bool):
        with METRICS.timer("lex_plan"):
            return [plan_mod.plan_shard(index, sh, slots, specs, realtime,
                                        full, plan_mod.PRUNE_BLOCKS,
                                        mode=mode)
                    for sh in index.shards]

    plans = plans_for(cover_full)
    if all(p is None for p in plans):
        return None, None, None, True
    stacked = mesh.get_stacked(index, device)
    METRICS.inc("device_dispatch_total")
    all_full = all(p is None or p.full for p in plans)
    with METRICS.timer("lex_device"):
        ts, gid, cnt = stacked.run(plans, k, with_counts and all_full)
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
                ts, gid, cnt = stacked.run(plans, k, with_counts)
            all_full = True
    return ts, gid, cnt, all_full
