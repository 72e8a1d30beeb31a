"""Lexical search on a torch device.

Port of the lexical entry points of ``seekstorm_tpu/search.py``
(``search``/``search_batch`` and the bucket-WAND route of
``_lexical_search_batch``).  Parsing, idf, the realtime tail merge, phrase
verification and result assembly are the reference's host functions,
imported unchanged; only the device dispatch is the port's
(``ops/wand.run_batch``).

Every eligible query rides WAND whatever the index size (the reference
routes indexes below 16 blocks to its dense kernels; both engines return
exact results), and queries whose upper bounds saturate go to the host
exact evaluation.

The device is explicit: ``device="cuda"`` without CUDA raises.
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
                                  _req_signature, _shard_idf)

from .ops import wand as wand_mod

MAX_PAGE = 1024    # offset + length served by the WAND host ladder


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


def _unsupported(req0: SearchRequest) -> str | None:
    if req0.query_facets:
        return "query_facets (ROADMAP A.6 WAND facet histograms)"
    if req0.facet_filter:
        return "facet_filter (ROADMAP A.6 WAND batch filter)"
    if req0.result_sort:
        return "result_sort (ROADMAP A.6 WAND rank-by-key)"
    if req0.field_filter:
        return "field_filter (ROADMAP A.7 tf path)"
    if req0.result_type == ResultType.Count:
        return "ResultType.Count (ROADMAP A.6 WAND count-only)"
    return None


def _lexical_search_batch(index: Index, requests: list[SearchRequest],
                          device: torch.device) -> list[ResultSet]:
    req0 = requests[0]
    what = _unsupported(req0)
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet")
    need = max(r.offset + r.length for r in requests)
    if need > MAX_PAGE:
        raise NotImplementedError(
            f"pages deeper than {MAX_PAGE} need the dense path, not ported "
            "yet (ROADMAP A.5)")
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
        elif not wand_mod.query_ok(spec):
            raise NotImplementedError(
                f"query {r.query!r} has {len(spec.slots)} term slots; more "
                f"than {wand_mod.T_MAX} need the dense path, not ported yet "
                "(ROADMAP A.5)")
        else:
            live.append(i)
    if not live:
        return [r or ResultSet() for r in results]

    live_specs = [specs[i] for i in live]
    with_counts = req0.result_type == ResultType.TopkCount
    B = len(live)
    counts_exact = np.ones(B, dtype=bool)
    tail_phrase_counts = np.zeros(B, dtype=np.int64)
    idf_ps = np.stack([_shard_idf(sh, slots, req0.realtime)
                       for sh in index.shards])          # [S, V]
    merged_scores, merged_ids, counts = wand_mod.run_batch(
        index, slots, live_specs, idf_ps, max(need, 1), with_counts, device)

    # WAND pages are deduped and (score desc, gid asc) ordered; a tail
    # merge concatenates and voids that
    canonical = np.ones(B, dtype=bool)
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
                             canonical=canonical)
