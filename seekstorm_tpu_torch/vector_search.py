"""Vector + hybrid search execution.

Reference call path mirrored (reference seekstorm/src/search.rs:1462-1743
query normalize/quantize + per-shard vector fan-out; vector.rs:1202
search_vector_shard; RRF hybrid fusion search.rs:1962-2035 with k = 0.6).

The port's copy of ``seekstorm_tpu/vector_search.py``: the host code is the
reference's; a shard's committed scan runs on the torch device the caller
names, cluster selection by ``ops/vector.medoid_select`` and the tiled scan
by ``ops/vector.vector_scan_topk`` (kernel K4 on CUDA), or, with a mesh
attached, on its positions (``_scan_committed_mesh``).  The realtime tail
is scanned exactly on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index import Index, Shard
from .metrics import METRICS
from .quantize import (
    preprocess_vectors,
    quantize_prepared,
    score_to_user,
    similarity_scores,
    threshold_to_score,
)
from .schema import BLOCK_SIZE, VectorSimilarity
from .utils import ceil_pow2

RRF_K = 0.6


class AnnMode:
    All = "All"
    Nprobe = "Nprobe"
    SimilarityThreshold = "SimilarityThreshold"
    NprobeSimilarityThreshold = "NprobeSimilarityThreshold"


def _quantize_queries(index: Index, requests):
    vc = index.meta.vector
    raw = np.stack([np.asarray(r.query_vector, dtype=np.float32) for r in requests])
    if vc.dim and raw.shape[1] != vc.dim:
        raise ValueError(
            f"query_vector has dimension {raw.shape[1]}, index expects {vc.dim}"
        )
    xp = preprocess_vectors(raw, vc.similarity, vc.quantization)
    qb = quantize_prepared(xp, vc.precision, vc.quantization)
    return xp, qb


def vector_search_batch(index: Index, requests, device) -> list:
    from .search import ResultObject, ResultSet, ResultType

    vc = index.meta.vector
    B = len(requests)
    req0 = requests[0]
    model = index.vectors.model if index.vectors else None
    if any(r.query_vector is None for r in requests):
        if model is None:
            raise ValueError(
                "vector search requires query_vector (or an index with "
                "Model2Vec inference to embed the query string)"
            )
        # embed query strings with the index's Model2Vec model
        missing = [i for i, r in enumerate(requests) if r.query_vector is None]
        with METRICS.timer("vector_embed"):
            embs = model.encode([requests[i].query for i in missing])
        requests = list(requests)
        for j, i in enumerate(missing):
            requests[i] = dataclasses.replace(requests[i],
                                              query_vector=embs[j].tolist())
        req0 = requests[0]
    xp, qb = _quantize_queries(index, requests)
    euclidean = vc.similarity == VectorSimilarity.Euclidean

    mode = getattr(req0, "ann_mode", AnnMode.All)
    nprobe = int(getattr(req0, "nprobe", 0) or 0)
    sim_thr = getattr(req0, "similarity_threshold", None)
    with_counts = req0.result_type in (ResultType.Count, ResultType.TopkCount)
    need = req0.offset + req0.length
    k = ceil_pow2(max(need, req0.top_n, 10) * 2, 16)
    # each query's list must hold its page's distinct docs: a doc may have
    # several rows (chunks), so k rows can hold fewer (_widened)
    need_q = np.array([r.offset + r.length for r in requests], np.int64)

    cand: list[list] = [[] for _ in range(B)]
    counts = np.zeros(B, np.int64)
    # observed-work counters (reference observed_cluster_count /
    # observed_vector_count, search.rs:200-204): clusters visited and
    # candidate vectors scanned per query, across shards
    obs_cl = np.zeros(B, np.int64)
    obs_vec = np.zeros(B, np.int64)

    score_min = np.full(B, -np.inf, np.float32)
    if sim_thr is not None and mode in (
        AnnMode.SimilarityThreshold,
        AnnMode.NprobeSimilarityThreshold,
    ):
        score_min[:] = threshold_to_score(float(sim_thr), vc.similarity)

    np_eff = nprobe if mode in (AnnMode.Nprobe,
                                AnnMode.NprobeSimilarityThreshold) else 0
    cluster_thr = np.full(B, -np.inf, np.float32)
    if sim_thr is not None and mode in (
        AnnMode.SimilarityThreshold,
        AnnMode.NprobeSimilarityThreshold,
    ):
        cluster_thr[:] = threshold_to_score(float(sim_thr), vc.similarity)
    use_ff = bool(req0.field_filter and index.vectors
                  and index.vectors.vector_fields)

    def _field_ok(nf_pad):
        ok = np.ones(nf_pad, bool)
        if use_ff:
            allowed = {
                sf.vector_field_id
                for sf in index.vectors.vector_fields
                if sf.field in req0.field_filter
            }
            ok[:] = False
            for a in allowed:
                ok[a] = True
        return ok

    mesh = getattr(index, "_mesh", None)
    if (mesh is not None and index.vectors is not None
            and any(index.vectors.shards[sh.shard_id].levels
                    for sh in index.shards)):
        _scan_committed_mesh(
            index, mesh, qb, mode, np_eff, score_min, cluster_thr,
            with_counts, k, need_q, use_ff, _field_ok, euclidean,
            cand, counts, obs_cl, obs_vec)
    elif index.vectors is not None:
        for shard in index.shards:
            _scan_committed_shard(
                index, shard, qb, mode, np_eff, score_min, cluster_thr,
                with_counts, k, need_q, use_ff, _field_ok, euclidean,
                cand, counts, obs_cl, obs_vec, device)

    with METRICS.timer("vector_tail"):
        for shard in index.shards:
            if index.vectors is None:
                break
            # realtime tail (exact f32 scan)
            if req0.realtime:
                tail = (index.vectors.tail_rows(shard) if index.vectors
                        else None)
                if tail is not None:
                    raw, docid, fieldid, chunkid = tail
                    tp = preprocess_vectors(raw, vc.similarity,
                                            vc.quantization)
                    dots = xp @ tp.T
                    sc = similarity_scores(
                        dots, (xp * xp).sum(1), (tp * tp).sum(1), vc.similarity
                    )
                    if req0.field_filter and index.vectors.vector_fields:
                        allowed = {
                            sf.vector_field_id
                            for sf in index.vectors.vector_fields
                            if sf.field in req0.field_filter
                        }
                        fmask = np.isin(fieldid, list(allowed))
                        sc = np.where(fmask[None, :], sc, -np.inf)
                    # tail deletes
                    dmask = np.array(
                        [d in shard.deleted for d in docid], dtype=bool
                    )
                    sc = np.where(dmask[None, :], -np.inf, sc)
                    ok = sc >= score_min[:, None]
                    sc = np.where(ok, sc, -np.inf)
                    counts += ok.sum(axis=1)
                    obs_vec += len(docid)  # the whole tail is scanned
                    if len(docid) > 1 and not (np.diff(docid) > 0).all():
                        # several rows a doc (chunks): each doc's best row,
                        # so the top k below are k distinct docs
                        sc, docid = _best_row_per_doc(sc, docid)
                    tgids = (docid.astype(np.int64) * index.shard_count
                             + shard.shard_id)
                    for qi in range(B):
                        order = np.argsort(-sc[qi])[:k]
                        m = np.isfinite(sc[qi][order])
                        sel = order[m]
                        if len(sel):
                            cand[qi].append((sc[qi][sel].astype(np.float32),
                                             tgids[sel]))

    with METRICS.timer("vector_merge"):
        out = []
        n_rows = n_docs = 0
        for qi, r in enumerate(requests):
            rs = ResultSet()
            if cand[qi]:
                s = np.concatenate([c[0] for c in cand[qi]])
                g = np.concatenate([c[1] for c in cand[qi]])
                # dedupe multi-vector docs to their best score: sort by
                # (gid asc, score desc), keep each gid's first row, then rank
                # by (score desc, gid asc)
                order = np.lexsort((-s, g))
                gs, ss = g[order], s[order]
                uniq_g, first = np.unique(gs, return_index=True)
                us = ss[first]
                n_rows += len(s)
                n_docs += len(uniq_g)
                rank = np.lexsort((uniq_g, -us))
                n_ranked = len(rank)
                page = rank[r.offset : r.offset + r.length]
                rs.results = [
                    ResultObject(
                        doc_id=int(uniq_g[i]),
                        score=float(score_to_user(us[i], vc.similarity)),
                    )
                    for i in page
                ]
            else:
                n_ranked = 0
                rs.results = []
            rs.result_count = len(rs.results)
            rs.result_count_total = (int(counts[qi]) if with_counts
                                     else n_ranked)
            rs.observed_vector_count = int(obs_vec[qi])
            rs.observed_cluster_count = int(obs_cl[qi])
            from .search import _attach_docs

            _attach_docs(index, r, rs)
            out.append(rs)
        METRICS.inc("vector_candidates_total", n_rows)
        METRICS.inc("vector_docs_total", n_docs)
    return out


def hybrid_search_batch(index: Index, requests, device) -> list:
    """RRF fusion of lexical and vector result lists
    (reference search.rs:1962-2035, k=0.6)."""
    from .search import (
        ResultObject,
        ResultSet,
        SearchMode,
        _attach_docs,
        _lexical_search_batch,
    )

    lex_reqs = [
        dataclasses.replace(
            r, search_mode=SearchMode.Lexical, offset=0,
            length=max(r.offset + r.length, 20), fields=[], highlights=[],
        )
        for r in requests
    ]
    vec_reqs = [
        dataclasses.replace(
            r, search_mode=SearchMode.Vector, offset=0,
            length=max(r.offset + r.length, 20), fields=[], highlights=[],
        )
        for r in requests
    ]
    lex = _lexical_search_batch(index, lex_reqs, device)
    vec = vector_search_batch(index, vec_reqs, device)

    out = []
    with METRICS.timer("hybrid_fuse"):
        for r, lr, vr in zip(requests, lex, vec):
            fused: dict[int, float] = {}
            for rank, res in enumerate(lr.results):
                fused[res.doc_id] = (fused.get(res.doc_id, 0.0)
                                     + 1.0 / (RRF_K + rank))
            for rank, res in enumerate(vr.results):
                fused[res.doc_id] = (fused.get(res.doc_id, 0.0)
                                     + 1.0 / (RRF_K + rank))
            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
            rs = ResultSet()
            page = ranked[r.offset : r.offset + r.length]
            rs.results = [ResultObject(doc_id=g, score=s) for g, s in page]
            rs.result_count = len(rs.results)
            rs.result_count_total = len(ranked)
            _attach_docs(index, r, rs)
            out.append(rs)
    return out


def _best_row_per_doc(sc: np.ndarray, docid: np.ndarray):
    """sc [B, R] row scores and docid [R] (several rows a doc) to each
    doc's best score [B, D] and the docs [D], ascending."""
    order = np.argsort(docid, kind="stable")
    d = docid[order]
    start = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
    return np.maximum.reduceat(sc[:, order], start, axis=1), d[start]


def _short_lists(ts: np.ndarray, gid: np.ndarray, need: np.ndarray,
                 k: int) -> np.ndarray:
    """Positions of the queries some of whose sources' lists (ts, gid
    [n, S*k]: S lists of k rows, best first, -inf past the matches) are
    full and hold fewer distinct docs than the query's `need`: rows past
    the k-th may hold docs its page needs."""
    n = len(ts)
    full = np.isfinite(ts.reshape(n, -1, k)[:, :, -1])
    g = np.sort(gid.reshape(n, -1, k), axis=2)
    distinct = 1 + (g[:, :, 1:] != g[:, :, :-1]).sum(axis=2)
    return np.flatnonzero((full & (distinct < need[:, None])).any(axis=1))


def _widened(scan, k: int, need: np.ndarray):
    """Each query's (scores, gids) rows from `scan(queries, k)` (numpy
    [n, S*k] each, S sources' lists of k rows; queries None: the whole
    batch), the queries whose lists fall short rescanned at twice the
    rows until every source's list holds the query's `need` distinct docs
    or every row that matches.  Counts the widened queries in
    ``vector_widened_total``."""
    ts, gid = scan(None, k)
    rows = list(zip(ts, gid))
    todo = _short_lists(ts, gid, need, k)
    METRICS.inc("vector_widened_total", len(todo))
    while len(todo):
        k *= 2
        ts, gid = scan(todo, k)
        for j, qi in enumerate(todo):
            rows[qi] = (ts[j], gid[j])
        todo = todo[_short_lists(ts, gid, need[todo], k)]
    return rows


def deleted_mask(shard: Shard, device) -> torch.Tensor:
    """The shard's deleted docs as bool[max(n_blocks, 1) * BLOCK_SIZE] on
    `device`, cached on the shard until a delete, commit or clear drops it
    (the reference's search._device_arrays, 1046-1064)."""
    dev = torch.device(device)
    cache = getattr(shard, "_dev", None)
    if cache is None:
        cache = shard._dev = {}
    mask = cache.get(dev)
    if mask is None:
        n = max(shard.lexical.n_blocks, 1) * BLOCK_SIZE
        deleted = np.zeros(n, dtype=bool)
        if shard.deleted:
            ids = np.fromiter(shard.deleted, dtype=np.int64)
            deleted[ids[ids < n]] = True
        mask = cache[dev] = torch.from_numpy(deleted).to(dev)
    return mask


def _scan_committed_shard(index, shard, qb, mode, np_eff, score_min,
                          cluster_thr, with_counts, k, need, use_ff,
                          field_ok_fn, euclidean, cand, counts, obs_cl,
                          obs_vec, device):
    """Committed scan of one shard on `device` (reference
    search_vector_shard, vector.rs:1202)."""
    from .ops.vector import medoid_select, vector_scan_topk
    from .vector_index import TILE

    dev = index.vectors.device(shard, device)
    if dev["n_rows"] <= 0:
        return
    METRICS.inc("vector_dispatch_total")
    with METRICS.timer("vector_scan"):
        quantized = dev["quantized"]
        qd = qb.data.astype(np.int8) if quantized else qb.data

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        q_host = (qd, qb.scale, qb.zp, qb.qsum, qb.norm2)
        qargs = tuple(put(a) for a in q_host)
        exhaustive = mode == AnnMode.All or dev["n_clusters"] <= 1
        crs = dev["cluster_row_start"]
        tile_ids = np.zeros(0, np.int32)
        if exhaustive:
            obs_cl += dev["n_clusters"]
            obs_vec += dev["n_rows"]
        else:
            with METRICS.timer("vector_select"):
                sel, _mscores = medoid_select(
                    dev["med_data"], dev["m_scale"], dev["m_zp"],
                    dev["m_qsum"], dev["m_norm2"], dev["m_valid"],
                    dev["always_scan"],
                    *qargs, put(cluster_thr),
                    quantized=quantized, euclidean=euclidean,
                    nprobe=min(np_eff, dev["n_clusters"]) if np_eff else 0,
                )
                sel = sel.cpu().numpy()[:, : dev["n_clusters"]]
                obs_cl += sel.sum(axis=1)
                obs_vec += (sel @ np.diff(crs)).astype(np.int64)
                # union of tiles covered by any selected cluster
                any_sel = sel.any(axis=0)
                tiles = set()
                for c in np.flatnonzero(any_sel):
                    t0 = int(crs[c]) // TILE
                    t1 = ((int(crs[c + 1]) - 1) // TILE
                          if crs[c + 1] > crs[c] else t0)
                    tiles.update(range(t0, t1 + 1))
                tile_ids = np.array(sorted(tiles), dtype=np.int32)
        nt_pad = ceil_pow2(max(len(tile_ids), 1), 4)
        tid = np.full(nt_pad, -1, np.int32)
        tid[: len(tile_ids)] = tile_ids

        field_ok = put(field_ok_fn(dev["nf_pad"]))
        tid = put(tid)
        deleted = deleted_mask(shard, device)
        h_doc = dev["h_docid"]

        def scan(sub, kk):
            whole = sub is None
            ts, rows, cnt = vector_scan_topk(
                dev["data"], dev["scale"], dev["zp"], dev["qsum"],
                dev["norm2"], dev["docid"], dev["fieldid"], deleted, tid,
                field_ok,
                *(qargs if whole else (put(a[sub]) for a in q_host)),
                put(score_min if whole else score_min[sub]),
                k=kk, quantized=quantized, euclidean=euclidean,
                with_counts=with_counts and whole, exhaustive=exhaustive,
                use_field_filter=use_ff,
            )
            if whole:
                counts[:] += cnt.cpu().numpy()
            rows = rows.cpu().numpy()
            return ts.cpu().numpy(), (h_doc[rows].astype(np.int64)
                                      * index.shard_count + shard.shard_id)

        for qi, (ts, gids) in enumerate(_widened(scan, k, need)):
            m = np.isfinite(ts)
            if m.any():
                cand[qi].append((ts[m], gids[m]))


def _scan_committed_mesh(index, mesh, qb, mode, np_eff, score_min,
                         cluster_thr, with_counts, k, need, use_ff,
                         field_ok_fn, euclidean, cand, counts, obs_cl,
                         obs_vec):
    """Committed scan over a mesh (the reference's _scan_committed_mesh,
    vector_search.py:331-416): the positions hold their shards' vectors
    (``IndexVectors.device_stacked``); one medoid pass selects each shard's
    clusters, the host turns the union selection into each shard's tiles,
    and one scan pass returns every shard's candidates, unmerged, on the
    lead device.  Each position's deleted masks are its own shards'."""
    from .ops.vector import medoid_mesh, vector_scan_mesh
    from .vector_index import TILE

    METRICS.inc("vector_dispatch_total")
    with METRICS.timer("vector_scan"):
        dev = index.vectors.device_stacked(mesh)
        hs = dev["per_shard"]
        S = index.shard_count
        SL = S // mesh.devices.size
        quantized = dev["quantized"]
        q = ((qb.data.astype(np.int8) if quantized else qb.data), qb.scale,
             qb.zp, qb.qsum, qb.norm2)
        exhaustive = (mode == AnnMode.All
                      or all(h["n_clusters"] <= 1 for h in hs))
        if exhaustive:
            tid = np.full((S, 1), -1, np.int32)
            for h in hs:
                obs_cl += h["n_clusters"]
                obs_vec += h["n_rows"]
        else:
            with METRICS.timer("vector_select"):
                any_sel, ocl, ovec = medoid_mesh(
                    dev["positions"], q, cluster_thr, C_pad=dev["C_pad"],
                    quantized=quantized,
                    euclidean=euclidean, nprobe=int(np_eff) if np_eff else 0,
                    lead=mesh.lead)
                any_sel = any_sel.cpu().numpy()
                obs_cl += ocl.cpu().numpy()
                obs_vec += ovec.cpu().numpy()
                per_tiles = []
                for s, h in enumerate(hs):
                    crs = h["cluster_row_start"]
                    tiles = set()
                    for c in np.flatnonzero(any_sel[s, : h["n_clusters"]]):
                        t0 = int(crs[c]) // TILE
                        t1 = ((int(crs[c + 1]) - 1) // TILE
                              if crs[c + 1] > crs[c] else t0)
                        tiles.update(range(t0, t1 + 1))
                    per_tiles.append(sorted(tiles))
                nt_sel = ceil_pow2(max(max(len(t) for t in per_tiles), 1), 4)
                tid = np.full((S, nt_sel), -1, np.int32)
                for s, t in enumerate(per_tiles):
                    tid[s, : len(t)] = t

        positions = [
            dict(p, deleted=[deleted_mask(index.shards[d * SL + j],
                                          p["device"])
                             for j in range(SL)])
            for d, p in enumerate(dev["positions"])]
        field_ok = field_ok_fn(dev["nf_pad"])

        def scan(sub, kk):
            whole = sub is None
            ts, gid, cnt = vector_scan_mesh(
                positions, tid, field_ok,
                q if whole else tuple(a[sub] for a in q),
                score_min if whole else score_min[sub], S=S, k=kk,
                quantized=quantized, euclidean=euclidean,
                with_counts=with_counts and whole,
                exhaustive=exhaustive, use_field_filter=use_ff,
                pool_tiles=dev["n_tiles"], lead=mesh.lead)
            if whole:
                counts[:] += cnt.cpu().numpy()
            return ts.cpu().numpy(), gid.cpu().numpy()

        for qi, (ts, gid) in enumerate(_widened(scan, k, need)):
            m = np.isfinite(ts)
            if m.any():
                cand[qi].append((ts[m].astype(np.float32),
                                 gid[m].astype(np.int64)))
