#!/usr/bin/env python3
"""Run the PyTorch port (seekstorm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found:

  1. card:   nvidia-smi name and power limit, torch's device name, and
             whether the native host library loaded (ingesting the corpus
             below needs it);
  2. build:  nvcc builds kernels K1 (csrc/wand_scan.cu), K2
             (csrc/dense_scan.cu), K3 (csrc/facet_hist.cu) and K4
             (csrc/vector_scan.cu) from the sources, one process each;
  3. K1:     K1 against its plain PyTorch version on random pools at the
             serving shapes (Bq=2048, NBLK=16, V=4096, T in {2,4,8}, filter
             off and on): counts equal, UBs, the rung maxima (ub4, ub16,
             g1) and the matched words bitwise equal, with both times (CUDA
             events, median of 20), K1's bound (bytes once at 3.35 TB/s, or
             operations at the f32 peak) and its share of it;
  4. index:  1,048,576 docs of bench.make_corpus (seed 7, vocab 30,000,
             title boost 10, 1 shard) with bench_facet.py's facet fields
             (brand of 24 values, price 1-499, a location), committed, plus
             5,000 uncommitted with the same fields;
  5. serve:  the default route (WAND at 16 blocks):
             bench.make_queries(2048, seed 100) as Topk and TopkCount with
             realtime=True through seekstorm_tpu_torch.search_batch on
             "cuda"; K1 must have launched, and K2 too whenever a WAND
             straggler fell back (at batch 2048 stragglers defer to the
             dense path); K1 at the batch's own shapes against its plain
             version (bitwise) with its time, bound and share; the warm
             batch latency, a cProfile of one warm batch (where the host's
             time goes) and the device's kernel time by name over one warm
             batch (torch.profiler); 256 queries must give the
             same pages, ids in the same order, on "cpu" (with
             SEEKSTORM_TPU_WAND_DEFER_DENSE=1 there, so its stragglers take
             the dense path as well), and 64 queries with realtime=False
             the same pages as the host exact evaluation;
  6. K2:     K2 against its plain PyTorch versions on every (block,
             query) pair of the 2,048-query TopkCount batch's dense plan:
             the unfused mode (masked scores) tile by tile, scores bitwise
             equal, matched words and counts equal; the fused mode (the
             per-pair top-kk in the kernel) at kk=10 and 128 in one launch
             at each split (CTAs a pair), without and with the matched
             words, values bitwise equal, docs equal at every finite
             entry, -inf pattern, counts and matched words equal; at 1,024
             pairs, the whole plan and the serve batch's straggler pairs
             (kk=16):
             the fused time at each split and at the wrapper's default,
             the yardstick (unfused K2 + topk_block(16), tile by tile),
             the plain time, the fused bound and its share;
  6b. K3:    K3 against its plain PyTorch version, counts equal, at the
             shapes of the 2,048-query facet2 batch on both routes (NF=2,
             fcm=32: K1's matched words under the brand filter, and K2's
             fused-mode matched words over the batch's dense plan), the
             dense route's pairs in a shuffled order, one wide code space
             (fcm=65,536, global atomics), the widest the shared histogram
             takes (8,192 bins) and the tf scan's matched words of a
             256-query field_filter batch, with K3's time, its bound
             (the matched words, the codes of the blocks touched and the
             histogram, each once) and share, the plain time, and
             torch.bincount on indices unpacked beforehand;
  7. dense:  the same batches with SEEKSTORM_TPU_NO_WAND=1 (the dense
             path): K2 must have launched, once for the TopkCount batch
             (fused mode); pages equal to the WAND route's
             (counts exact, scores within rtol 3e-5, membership per score
             cluster); warm batch latency and the device's kernel time by
             name (torch.profiler); 256 queries must give the same pages on
             "cpu"; a batch of pages 1990-2009 and a batch of 10- to
             12-term queries served, their first 32 equal on "cpu";
  8. facets: bench_facet.py's facet2 (TopkCount, two-term queries, facets
             brand and price in ranges cheap/mid/lux, filter brand in the
             first 6 brands) and geosort (Topk, loc ascending from
             [37.7, -122.4]) with realtime=True, batches of 64 and one
             facet2 batch of 2,048, on the default route, with
             SEEKSTORM_TPU_NO_WAND=1, and geosort with
             SEEKSTORM_TPU_WAND_SORT=1: K1, K2 and K3 launched where the
             route says; pages, counts and facet lists equal between the
             routes and equal to "cpu" on the first 64 queries of each
             batch; every filtered page's docs carry an allowed brand; a
             result's brand counts sum to its count; warm batch latency
             and the device's kernel time by name;
  9. tf:     field_filter batches (the tf path: plans over the full
             postings, scored from per-field term frequencies by torch ops):
             256 queries of bench.make_queries as TopkCount with
             realtime=True under field_filter=["title"] and ["body"], and
             256 facet2 requests (brand counts, price ranges, brand filter)
             under field_filter=["body"], whose matched words feed K3: no
             K1 or K2 launch, one K3 launch for the faceted batch; pages,
             counts and facet lists equal to "cpu" on the first 64; eight
             queries on the corpus's most frequent words (dense-term rows)
             equal to "cpu"; field_filter naming both fields equal to the unfiltered batch;
             a title-only page holds no doc that matches in the body alone
             (its count is at most the unfiltered count); warm batch
             latency and the device's kernel time by name;
  10. K4:    K4 against its plain version (ops/vector.vector_scan_ref) on
             random pools from a seed: i8 and f32, dot and Euclidean, all
             tiles and selected tiles with -1 padding, the field filter off
             and on, 10% of the docs deleted, a threshold that cuts half
             the queries, k in 32/256/2,048 and one case with NT*256 < k;
             i8 bitwise equal (scores, rows, counts), f32 within the bound
             of a different sum order (2.1*d*2^-24*sum|q_i r_i|, doubled
             for Euclidean); at the serving shape (B=64, 1,048,576 rows,
             d=128, i8, Euclidean, k=32) bitwise equal, with K4's time
             (the kernel and the merge of its per-tile lists), its bound
             (bytes once at 3.35 TB/s, or the dots at 1,979 int8 TOPS) and
             share, the plain time, an f32 matmul + torch.topk of the same
             shapes, and the device's kernel time by name;
  11. vector: bench_vector.make_proxy("sift", 1,048,576, seed 11) with a
             body field of bench.make_corpus (seed 7) in bench_vector.py's
             configuration (Euclidean, i8, scalar quantization, Auto
             clustering, 1 shard), ingested in steps of 8,192 and
             committed, plus 5,000 uncommitted docs; 256 of the proxy's
             queries in batches of 64 as TopkCount top-10 pages with the
             realtime tail under ann_mode All, Nprobe 16 and 33 and
             SimilarityThreshold: one K4 launch a batch; recall@10 against
             an exact ground truth on the card (ties count), >= 0.97 at
             All (just under the i8 scores' own ceiling on this proxy,
             0.9738), printed again on a [summary] line before the result;
             a warm Nprobe 16 and 33 batch's K4 result (selected tiles
             with -1 padding) bitwise equal to vector_scan_ref on the same
             tensors; every vector counted at All; the threshold honoured;
             observed vectors and clusters a query; warm batch latency and
             the device's kernel time by name; 64 queries at All equal to
             "cpu" exactly, recall at nprobe 16 and 33 within 0.02 of
             "cpu"'s (the global re-cluster runs on each device); 64
             hybrid requests (bench.make_queries text with the proxy's
             vectors) equal to "cpu" exactly.

The script imports the port (seekstorm_tpu_torch), bench.py,
bench_vector.py (numpy alone at import) and torch;
jax and the JAX package (seekstorm_tpu) are blocked through every phase.

Any failed check raises, so the exit code is not 0 and no result line is
printed.  Without CUDA, or without the repository beside it, the script
exits 1 at once.  The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.abc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
N_DOCS = 1 << 20
N_TAIL = 5_000
N_QUERIES = 2048
N_TF = 256                   # queries of a field_filter batch
K1_SHAPES = dict(Bq=2048, NBLK=16, V=4096)
PAGE_RTOL = 3e-5
# NVIDIA H100 SXM data sheet: HBM3 rate and dense f32 rate outside the
# tensor cores (the rates the kernels' bounds are taken against)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
NW = 2048                    # u32 words (32-doc buckets) per 64K-doc block


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuses jax and the JAX package: the port must run without both."""

    def find_spec(self, name, path=None, target=None):
        if (name in ("jax", "seekstorm_tpu")
                or name.startswith(("jax.", "jaxlib", "seekstorm_tpu."))):
            raise ImportError(f"{name} is blocked: the port must not use it")
        return None


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase_card(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from seekstorm_tpu_torch import native_library

    t0 = time.perf_counter()
    lib = native_library()
    print(f"[card] native host library: "
          f"{'loaded' if lib is not None else 'MISSING'} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(lib is not None, "the native library is needed to ingest 1M docs")
    return card


def phase_build():
    from seekstorm_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load("wand_scan")
    secs = time.perf_counter() - t0
    names = ", ".join(p.name for p in _build.build().values())
    print(f"[build] K1, K2, K3, K4 libraries {names}: {secs:.2f} s (nvcc, one "
          f"process per source, {_build.BUILD_SECONDS})")
    for line in (_build.BUILD_LOG or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def _k1_inputs(torch, rng, *, Bq, NBLK, V, T, S=1, with_filter,
               device="cuda"):
    """Random pools and a random batch at the given shapes (numpy rng for
    the batch, a seeded torch generator for the pools)."""
    import numpy as np

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    present = rng.random((NBLK, V)) < 0.8
    PR = int(present.sum()) + 1
    prow = np.full((NBLK, V), -1, np.int32)
    prow[present] = np.arange(PR - 1, dtype=np.int32)

    def words(shape):
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                          dtype=torch.int32)
        for _ in range(2):   # sparsify so matches are not trivial
            x &= torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                               device=dev, dtype=torch.int32)
        return x

    NW = 2048
    ppool = words((PR, NW))
    vpool = torch.rand((PR, NW), generator=g, device=dev) * 3.0
    delw = words((NBLK, NW)) & words((NBLK, NW))
    filtw = words((NBLK, NW)) if with_filter else None
    tslot = np.full((Bq, T), -1, np.int32)
    treq = np.zeros((Bq, T), bool)
    tneg = np.zeros((Bq, T), bool)
    wsh = np.zeros((S, Bq, T), np.float32)
    for q in range(Bq - 1):          # the last row stays all padding
        npos = int(rng.integers(1, T + 1))
        sl = rng.choice(V, size=npos, replace=False)
        pos = sorted(sl[:-1]) if npos > 1 and rng.random() < 0.3 \
            else sorted(sl)
        negs = [s for s in sl if s not in pos]
        for j, s in enumerate(pos):
            tslot[q, j] = s
            treq[q, j] = rng.random() < 0.3
            wsh[:, q, j] = rng.random(S).astype(np.float32) + 0.1
        for j, s in enumerate(negs):
            tslot[q, len(pos) + j] = s
            tneg[q, len(pos) + j] = True
    sid = np.zeros(NBLK, np.int32)

    def put(a):
        return torch.from_numpy(a).to(dev)

    return (ppool, vpool, put(prow), delw, filtw, put(tslot), put(treq),
            put(tneg), put(wsh), put(sid))


def _median_ms(torch, fn, n=20, rounds=5):
    """Device ms per call of fn: CUDA events around n calls in a row (the
    host queues them ahead of the card, so the wrappers' host work does
    not count while the card is the slower side), the median of `rounds`
    such windows, after 3 calls to warm up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def k1_bound(torch, args, with_maxima=True):
    """K1's least time on an H100 for these inputs, in ms, and what sets
    it: each input byte it must read once (the presence row of every
    (block, slot) the batch's columns name, the bucket-max row of every
    one a positive column names, the delete and filter words, the tables)
    and each output byte written once (allub, ub4, ub16, g1 unless
    with_maxima is False, cnt), over the HBM rate; against the f32
    operations of the UB chains (per query and bucket: T products, then
    per presence class of the first min(T, 3) columns its sums and a max)
    over the f32 peak."""
    ppool, vpool, prow, delw, filtw, tslot, treq, tneg, wshard, sid = args
    NBLK, _ = prow.shape
    Bq, T = tslot.shape
    used = tslot >= 0

    def rows(mask):
        slots = torch.unique(tslot[mask]).long()
        return int((prow[:, slots] >= 0).sum())

    words = NBLK * NW
    read = ((rows(used) + rows(used & ~tneg)) * NW * 4
            + words * 4 * (1 if filtw is None else 2)
            + sum(x.numel() * x.element_size()
                  for x in (prow, tslot, treq, tneg, wshard, sid)))
    write = (Bq * words * 4 * (1 + (1 / 4 + 1 / 16 + 1 / 128) * with_maxima)
             + Bq * 4)
    nc = min(T, 3)
    ops = Bq * words * (T + ((1 << nc) - 1) * T)
    return _bound(read + write, ops)


def check_k1(torch, args, tag):
    """K1 against its plain version on args: counts equal, allub, the rung
    maxima and the matched words bitwise equal, and the five outputs the
    same whether or not the matched words are asked for.  Returns (max abs
    err, finite UBs, UBs)."""
    from seekstorm_tpu_torch.ops import wand_scan as ws

    got = ws.wand_scan_cuda(*args, with_matched=True)
    want = ws.scan_blocks_ref(*args, with_matched=True)
    five = ws.wand_scan_cuda(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("allub", "cnt", "ub4", "ub16", "g1"), five, got):
        check(torch.equal(x.view(torch.int32), y.view(torch.int32)),
              f"K1 {name} changes with the matched-words output ({tag})")
    del five
    check(torch.equal(got[1], want[1]), f"K1 counts differ ({tag})")
    fin = torch.isfinite(want[0])
    check(torch.equal(fin, torch.isfinite(got[0])),
          f"K1 -inf pattern differs ({tag})")
    err = float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    for name, x, y in zip(("allub", "cnt", "ub4", "ub16", "g1", "mwords"),
                          got, want):
        check(torch.equal(x.view(torch.int32), y.view(torch.int32)),
              f"K1 {name} not bitwise equal ({tag}, max abs err of allub "
              f"{err})")
    return err, int(fin.sum()), fin.numel()


def time_k1(torch, args):
    """(K1 ms, plain ms, bound ms, bound_by) on args."""
    from seekstorm_tpu_torch.ops import wand_scan as ws

    ms = _median_ms(torch, lambda: ws.wand_scan_cuda(*args))
    plain_ms = _median_ms(torch, lambda: ws.scan_blocks_ref(*args), n=2,
                          rounds=3)
    bound, by = k1_bound(torch, args)
    return ms, plain_ms, bound, by


def phase_k1(torch):
    import numpy as np

    from seekstorm_tpu_torch.ops import wand_scan as ws

    rng = np.random.default_rng(1)
    rows = []
    for T in ws.T_TIERS:
        for with_filter in (False, True):
            args = _k1_inputs(torch, rng, T=T, with_filter=with_filter,
                              **K1_SHAPES)
            tag = f"T={T} filter={with_filter}"
            err, n_fin, n = check_k1(torch, args, tag)
            ms, plain_ms, bound, by = time_k1(torch, args)
            print(f"[K1] {tag}: counts equal, UBs, ub4, ub16, g1 and matched "
                  f"words bitwise equal ({n_fin} finite of {n}); K1 "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound:.3f} ms ({by}), {100 * bound / ms:.1f}% of bound")
            rows.append(dict(T=T, filter=with_filter, err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by))
            del args
            torch.cuda.empty_cache()
    return rows


BRANDS = [f"brand{i:02d}" for i in range(24)]


def _add_facets(docs, rng):
    """bench_facet.py's facet fields (its lines 53-63): brand from 24
    values, price 1-499 and a location, drawn in its order from rng."""
    n = len(docs)
    bi = rng.integers(0, len(BRANDS), size=n)
    price = rng.integers(1, 500, size=n)
    lat = rng.uniform(-60, 60, size=n)
    lon = rng.uniform(-170, 170, size=n)
    for i, d in enumerate(docs):
        d["brand"] = BRANDS[int(bi[i])]
        d["price"] = int(price[i])
        d["loc"] = [float(lat[i]), float(lon[i])]
    return docs


def phase_index(st, n_docs=N_DOCS, n_tail=N_TAIL, path=WORK / "index"):
    import numpy as np

    import bench

    t0 = time.perf_counter()
    docs = _add_facets(
        bench.make_corpus(n_docs, 30_000, np.random.default_rng(7)),
        np.random.default_rng(8))
    tail = _add_facets(
        bench.make_corpus(n_tail, 30_000, np.random.default_rng(8)),
        np.random.default_rng(9))
    t1 = time.perf_counter()
    shutil.rmtree(path, ignore_errors=True)
    schema = [
        st.SchemaField("title", st.FieldType.Text, indexed=True, boost=10.0),
        st.SchemaField("body", st.FieldType.Text, indexed=True),
        st.SchemaField("brand", st.FieldType.String16, facet=True),
        st.SchemaField("price", st.FieldType.U16, facet=True),
        st.SchemaField("loc", st.FieldType.Point, facet=True),
    ]
    idx = st.create_index(path, schema, shard_count=1)
    idx.index_documents(docs)
    idx.commit()
    t2 = time.perf_counter()
    idx.index_documents(tail)
    sh = idx.shards[0]
    print(f"[index] {n_docs} docs committed in {sh.lexical.n_blocks} blocks "
          f"+ {sh.tail_len()} uncommitted (corpus {t1 - t0:.1f} s, ingest "
          f"+ commit {t2 - t1:.1f} s)")
    check(sh.committed_doc_count == n_docs and sh.tail_len() == n_tail,
          "index holds the expected docs")
    return idx


def _pages_equal(a, b, rtol=PAGE_RTOL):
    """Same count, same ids in the same order, scores within rtol."""
    if a.result_count_total != b.result_count_total:
        return False, "count"
    ia = [r.doc_id for r in a.results]
    ib = [r.doc_id for r in b.results]
    if ia != ib:
        return False, "ids"
    for x, y in zip(a.results, b.results):
        if abs(x.score - y.score) > rtol * max(abs(x.score), abs(y.score),
                                               1e-9):
            return False, "score"
    return True, ""


def _profile(fn, top=12):
    """Run fn once under cProfile; print the host seconds of the named
    stages of a batch and the top functions by own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    cum = {}
    for (_, _, name), (_, _, _, ct, _) in stats.stats.items():
        cum[name] = max(cum.get(name, 0.0), ct)
    stages = ("_build_specs", "_shard_idf", "run_batch", "plan_batch",
              "wand_scan", "_apply_slim", "_rescore_many", "_exact_fallback",
              "_merge_tail", "_finalize_lexical")
    print(f"[profile] one warm batch under cProfile, {wall:.3f} s wall; "
          f"cumulative seconds: " + ", ".join(
              f"{n} {cum.get(n, 0.0):.3f}" for n in stages))
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    for (path, line, name), (_, nc, tt, ct, _) in rows:
        where = f"{Path(path).name}:{line}" if line else path
        print(f"[profile]   own {tt:.3f} s  cum {ct:.3f} s  calls {nc}  "
              f"{name} ({where})")


def phase_serve(torch, st, idx, n_queries=N_QUERIES, n_cpu=256, n_exact=64,
                device="cuda"):
    import numpy as np

    import bench
    from seekstorm_tpu_torch import METRICS
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import wand as W
    from seekstorm_tpu_torch.ops import wand_scan as ws

    queries = bench.make_queries(n_queries, np.random.default_rng(100))

    def reqs(rtype, realtime=True, qs=queries):
        return [st.SearchRequest(query=q, length=10, result_type=rtype,
                                 realtime=realtime,
                                 query_type_default=st.QueryType(t))
                for q, t in qs]

    fb0 = METRICS.snapshot().get("wand_fallbacks_total", 0.0)
    ws.LAUNCHES = 0
    ds.LAUNCHES = 0
    t0 = time.perf_counter()
    topk = st.search_batch(idx, reqs(st.ResultType.Topk), device=device)
    t1 = time.perf_counter()
    topkc = st.search_batch(idx, reqs(st.ResultType.TopkCount),
                            device=device)
    t2 = time.perf_counter()
    launches = ws.LAUNCHES
    k2_launches = ds.LAUNCHES
    fallbacks = METRICS.snapshot().get("wand_fallbacks_total", 0.0) - fb0
    print(f"[serve] {n_queries} queries: Topk batch {t1 - t0:.3f} s (cold: "
          f"builds the term rows), TopkCount batch {t2 - t1:.3f} s; K1 "
          f"launches {launches}; WAND stragglers {fallbacks:.0f}, deferred "
          f"to the dense path: K2 launches {k2_launches}")
    check(launches > 0, "the serve phase did not launch K1")
    check(k2_launches > 0 if fallbacks else k2_launches == 0,
          "WAND stragglers at batch 2048 must run on K2, and only they")
    check(len(topk) == n_queries and len(topkc) == n_queries,
          "one result set per query")
    check(all(len(r.results) <= 10 and all(np.isfinite(x.score)
                                            for x in r.results)
              for r in topkc), "finite scores, at most 10 per page")
    check(sum(r.result_count_total > 0 for r in topkc) > n_queries // 2,
          "most queries match")
    for a, b in zip(topk, topkc):
        check([r.doc_id for r in a.results] == [r.doc_id for r in b.results],
              "Topk and TopkCount pages agree")

    lat = []
    snap0 = METRICS.snapshot()
    for _ in range(3):
        t0 = time.perf_counter()
        st.search_batch(idx, reqs(st.ResultType.TopkCount), device=device)
        lat.append(time.perf_counter() - t0)
    snap1 = METRICS.snapshot()
    state = W.get_state(idx, device)
    print(f"[serve] warm TopkCount batch of {n_queries}: "
          f"{[round(x * 1e3, 1) for x in lat]} ms; device pools "
          f"(ppool+vpool+rpool+ipool) {state.pool_bytes()} bytes")
    _print_split("serve", lat, snap0, snap1)
    _profile(lambda: st.search_batch(idx, reqs(st.ResultType.TopkCount),
                                     device=device))
    with _recording_scans() as stragglers:
        device_kernels(torch, "serve", lambda: st.search_batch(
            idx, reqs(st.ResultType.TopkCount), device=device), top=16)

    # K1 at this batch's own shapes (pools, rows and tables of the serve
    # path); these launches come after the count above was read
    args = st.wand_inputs(idx, reqs(st.ResultType.TopkCount), device)
    err, n_fin, n = check_k1(torch, args, "serve batch")
    ms, plain_ms, bound, by = time_k1(torch, args)
    Bq, T = args[5].shape
    print(f"[serve] K1 at the batch's shapes (Bq={Bq}, T={T}, "
          f"NBLK={args[2].shape[0]}, V={args[2].shape[1]}): counts equal, "
          f"UBs, ub4, ub16, g1 and matched words bitwise equal ({n_fin} "
          f"finite of {n}); "
          f"K1 {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
          f"({by}), {100 * bound / ms:.1f}% of bound")
    k1_serve = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by)
    del args

    # the CPU batch is under 512: defer its stragglers to the dense path
    # too, as the card's batch of 2048 does, so both take one route
    os.environ["SEEKSTORM_TPU_WAND_DEFER_DENSE"] = "1"
    try:
        cpu = st.search_batch(idx, reqs(st.ResultType.TopkCount,
                                        qs=queries[:n_cpu]), device="cpu")
    finally:
        del os.environ["SEEKSTORM_TPU_WAND_DEFER_DENSE"]
    bad = [(i, why) for i, (a, b) in enumerate(zip(topkc[:n_cpu], cpu))
           for ok, why in [_pages_equal(a, b)] if not ok]
    print(f"[serve] cuda vs cpu pages on {n_cpu} queries (stragglers on "
          f"the dense path on both): {n_cpu - len(bad)} equal (ids and "
          f"order), first mismatches {bad[:5]}")
    check(not bad, "cuda and cpu pages differ")

    rq = reqs(st.ResultType.TopkCount, realtime=False,
              qs=queries[:n_exact])
    dev_pages = st.search_batch(idx, rq, device=device)
    exact = st.exact_pages(idx, rq, device)
    bad = []
    for i, (rs, (count, gids, scores)) in enumerate(zip(dev_pages, exact)):
        ids = [r.doc_id for r in rs.results]
        sc = [r.score for r in rs.results]
        if rs.result_count_total != count or ids != gids or any(
                abs(x - y) > PAGE_RTOL * max(abs(x), abs(y), 1e-9)
                for x, y in zip(sc, scores)):
            bad.append(i)
    print(f"[serve] device vs host exact pages (realtime=False) on "
          f"{n_exact} queries: {n_exact - len(bad)} equal, mismatches "
          f"{bad[:5]}")
    check(not bad, "device pages differ from the host exact evaluation")
    return dict(k1_launches=launches, k1=k1_serve, topk=topk, topkc=topkc,
                queries=queries, stragglers=stragglers)


class _recording_scans:
    """Within the block, keeps the (arrays, pairs, k, n_queries) of every
    dense scan the batch makes (ops/lexical.scan_pairs), as a list."""

    def __enter__(self):
        from seekstorm_tpu_torch.ops import lexical as lx

        self.lx, self.orig, self.calls = lx, lx.scan_pairs, []

        def rec(arrays, pairs, k, n_queries, **kw):
            self.calls.append((arrays, pairs, k, n_queries))
            return self.orig(arrays, pairs, k, n_queries, **kw)

        lx.scan_pairs = rec
        return self.calls

    def __exit__(self, *exc):
        self.lx.scan_pairs = self.orig


def _print_split(tag, lat, snap0, snap1):
    """Where warm batches' host-clock seconds went, by METRICS timer."""
    spent = {k: snap1.get(f"{k}_seconds_total", 0.0)
             - snap0.get(f"{k}_seconds_total", 0.0)
             for k in ("lex_device", "lex_plan", "wand_rescore",
                       "wand_exact_fallback")}
    print(f"[{tag}] warm batches, seconds of {sum(lat):.3f} in all: device "
          f"dispatch to fetch {spent['lex_device']:.3f} (WAND scan and "
          f"dense scan), dense planning {spent['lex_plan']:.3f}, host rung "
          f"rescore {spent['wand_rescore']:.3f}, host exact evaluation "
          f"{spent['wand_exact_fallback']:.3f}, other host work (parse, "
          f"WAND tables, tail merge, assembly) "
          f"{sum(lat) - sum(spent.values()):.3f}")


def _same_pages(a, b, rtol=PAGE_RTOL):
    """tests/test_wand.py's _Page equality: counts equal, scores within
    rtol position by position, doc membership equal in every cluster of
    tied scores but the page's last (two arithmetic paths may split a tie
    class cut by the page end differently)."""
    if a.result_count_total != b.result_count_total:
        return False, "count"
    if len(a.results) != len(b.results):
        return False, "length"

    def close(x, y):
        return abs(x - y) <= rtol * max(abs(x), abs(y), 1e-9)

    def clusters(rs):
        out = []
        for r in rs.results:
            if out and close(r.score, out[-1][0]):
                out[-1][1].add(r.doc_id)
            else:
                out.append((r.score, {r.doc_id}))
        return out

    if not all(close(x.score, y.score) for x, y in zip(a.results, b.results)):
        return False, "score"
    ca, cb = clusters(a), clusters(b)
    if len(ca) != len(cb) or any(x[1] != y[1] for x, y in
                                 zip(ca[:-1], cb[:-1])):
        return False, "ids"
    return True, ""


def k2_bound(torch, part, n_queries):
    """K2's unfused mode's least time on an H100 for these pairs, in ms,
    and what sets it: the bytes it must move once (the distinct
    CSR-remainder segments the pairs name, 2-byte docid and 4-byte impact
    a posting, the distinct bitmap rows, sat1 and the delete words of each
    distinct block, the pair tables; the masked scores written, 4 bytes a
    doc of every pair, and the counts) over the HBM rate, against its f32
    operations (an fma a CSR posting, an add a bitmap slot and doc, the
    final fma a doc) over the f32 peak."""
    p_blk, _, _, s_off, s_len, s_bm = part[:6]
    doc = 1 << 16
    n_bm = len(torch.unique(s_bm[s_bm >= 0]))
    n_blk = len(torch.unique(p_blk))
    P = p_blk.shape[0]
    read = (_segment_postings(torch, s_off, s_len) * 6 + n_bm * NW * 4
            + n_blk * (doc * 4 + NW * 4)
            + sum(x.numel() * x.element_size() for x in part))
    write = P * doc * 4 + n_queries * 4
    ops = int(s_len.sum()) * 2 + int((s_bm >= 0).sum()) * doc + P * doc * 2
    return _bound(read + write, ops)


def _segment_postings(torch, s_off, s_len):
    """Postings in the distinct CSR segments the pairs name."""
    seg = s_len > 0
    offs, first = torch.unique(s_off[seg], return_inverse=True)
    seg_len = torch.zeros(len(offs), dtype=torch.int64, device=s_len.device)
    seg_len.scatter_reduce_(0, first, s_len[seg].long(), "amax")
    return int(seg_len.sum())


def _bound(n_bytes, ops):
    """The least time in ms for n_bytes moved once and ops f32 operations,
    and which of the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rank_bound(torch, st, idx, reqs, k=10):
    """The least time on an H100, in ms, of a sorted batch's dense scan
    with the sort-key rank (the reference's lexical_scan_imp 486-565 with
    the rank at 535-543): over the batch's full-coverage plan, each input
    byte read once (the CSR segments the pairs name, 6 bytes a posting;
    the distinct bitmap rows; sat1, the delete words and the sort key of
    each distinct block; the pair tables) and the page of k (key, doc)
    entries a query written, against the scan's f32 operations."""
    import numpy as np

    plans, stacked = st.dense_plans(idx, reqs, device="cuda")
    part = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in stacked.pair_tables(plans)[:8]]
    p_blk, _, _, s_off, s_len, s_bm = part[:6]
    doc = 1 << 16
    n_bm = len(torch.unique(s_bm[s_bm >= 0]))
    n_blk = len(torch.unique(p_blk))
    P = p_blk.shape[0]
    read = (_segment_postings(torch, s_off, s_len) * 6 + n_bm * NW * 4
            + n_blk * (doc * 8 + NW * 4)
            + sum(x.numel() * x.element_size() for x in part))
    ops = int(s_len.sum()) * 2 + int((s_bm >= 0).sum()) * doc + P * doc * 2
    return (*_bound(read + len(reqs) * k * 8, ops), P)


def k2_fused_bound(torch, arrays, part, n_queries, kk):
    """K2's fused mode's least time on an H100 for these pairs, in ms, and
    what sets it.  Bytes moved once: the distinct CSR segments (6 bytes a
    posting), the distinct bitmap rows, the delete words of each distinct
    block, sat1 of each distinct block that some pair's bitmap slot needs,
    the pair tables; written, kk values and docs (4 + 8 bytes) a pair and
    the counts.  Operations: an fma a CSR posting, an add a set bit of a
    pair's bitmap slots, and one operation a doc of every pair (the match
    test and the key, the selection counted in it)."""
    from seekstorm_tpu_torch.ops import dense_scan as ds

    bitmaps = arrays[2]
    p_blk, _, _, s_off, s_len, s_bm = part[:6]
    doc = 1 << 16
    rows = torch.unique(s_bm[s_bm >= 0])
    bits = torch.zeros(bitmaps.shape[0], dtype=torch.int64,
                       device=bitmaps.device)
    for a in range(0, len(rows), 256):
        r = rows[a:a + 256].long()
        bits[r] = ds.unpack_words(bitmaps[r]).sum(dim=1)
    set_bits = int(bits[s_bm[s_bm >= 0].long()].sum())
    n_blk = len(torch.unique(p_blk))
    n_blk_bm = len(torch.unique(p_blk[(s_bm >= 0).any(dim=1)]))
    P = p_blk.shape[0]
    read = (_segment_postings(torch, s_off, s_len) * 6 + len(rows) * NW * 4
            + n_blk * NW * 4 + n_blk_bm * doc * 4
            + sum(x.numel() * x.element_size() for x in part))
    write = P * kk * 12 + n_queries * 4
    ops = int(s_len.sum()) * 2 + set_bits + P * doc
    return _bound(read + write, ops)


def _check_fused(torch, got, want, tag):
    """K2's fused outputs against the plain version's: the -inf pattern
    equal, finite values bitwise equal, docs equal at every finite entry
    (-1 past the last match in both), counts equal."""
    (v, d, c), (vr, dr, cr) = got, want
    fin = torch.isfinite(vr)
    check(torch.equal(fin, torch.isfinite(v)), f"K2 -inf pattern ({tag})")
    err = float((v[fin] - vr[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(torch.equal(v[fin].view(torch.int32), vr[fin].view(torch.int32)),
          f"K2 fused values not bitwise equal ({tag}, max abs err {err})")
    check(torch.equal(d[fin], dr[fin]), f"K2 fused docs differ ({tag})")
    check(bool((d[~fin] == -1).all()) and bool((dr[~fin] == -1).all()),
          f"K2 fill docs ({tag})")
    check(torch.equal(c, cr), f"K2 fused counts differ ({tag})")
    return err, int(fin.sum())


def phase_k2(torch, st, idx, queries, stragglers):
    """K2 against its plain versions on every pair of the batch's dense
    plan, in both modes; times and bounds at three shapes."""
    import numpy as np

    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import lexical as lx

    plans, stacked = st.dense_plans(
        idx, [st.SearchRequest(query=q, result_type=st.ResultType.TopkCount,
                               realtime=True,
                               query_type_default=st.QueryType(t))
              for q, t in queries], device="cuda")
    tables = stacked.pair_tables(plans)
    pairs = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
             for x in tables[:8]]
    arrays = stacked.arrays
    P, T = pairs[3].shape
    tile = ds.TILE_PAIRS
    B = len(queries)

    # unfused mode, tile by tile, bitwise
    err_u, cnt_k, finite = 0.0, 0, 0
    for a in range(0, P, tile):
        part = [x[a:a + tile] for x in pairs]
        out_k, ck, mw_k = ds.dense_scan_cuda(*arrays, *part, B,
                                             with_matched=True)
        out_r, cr, mw_r = ds.dense_scan_ref(*arrays, *part, B,
                                            with_matched=True)
        torch.cuda.synchronize()
        check(torch.equal(mw_k, mw_r),
              f"K2 matched words differ in pairs {a}..{a + tile}")
        fin = torch.isfinite(out_r)
        check(torch.equal(fin, torch.isfinite(out_k)),
              f"K2 match pattern differs in pairs {a}..{a + tile}")
        if bool(fin.any()):
            err_u = max(err_u, float((out_k[fin] - out_r[fin]).abs().max()))
        check(torch.equal(out_k.view(torch.int32), out_r.view(torch.int32)),
              f"K2 scores not bitwise equal in pairs {a}..{a + tile} "
              f"(max abs err {err_u})")
        check(torch.equal(ck, cr), f"K2 counts differ in pairs {a}..")
        cnt_k += int(ck.sum())
        finite += int(fin.sum())
        del out_k, out_r
    print(f"[K2] unfused mode, {P} pairs (T={T}) of the {B}-query TopkCount "
          f"plan ({len(plans[0].block_ids)} blocks), tiles of {tile}: "
          f"scores bitwise equal ({finite} matched docs), matched words "
          f"and counts equal ({cnt_k} matches)")

    # fused mode, one launch for every pair, at each split
    err = 0.0
    for kk in (10, 128):
        want = ds.dense_topk_ref(*arrays, *pairs, B, kk, with_matched=True)
        for split in ds.SPLITS:
            got = ds.dense_topk_cuda(*arrays, *pairs, B, kk, split=split)
            torch.cuda.synchronize()
            e, n_fin = _check_fused(torch, got, want[:3],
                                    f"kk={kk} split={split}")
            err = max(err, e)
            # the same launch with the matched words: they equal the plain
            # version's and nothing else changes
            got = ds.dense_topk_cuda(*arrays, *pairs, B, kk, split=split,
                                     with_matched=True)
            torch.cuda.synchronize()
            _check_fused(torch, got[:3], want[:3],
                         f"kk={kk} split={split} with matched words")
            check(torch.equal(got[3], want[3]),
                  f"K2 fused matched words differ (kk={kk} split={split})")
        del want, got
        print(f"[K2] fused mode, kk={kk}, all {P} pairs in one launch at "
              f"splits {ds.SPLITS}, without and with the matched words: "
              f"values bitwise equal, docs equal ({n_fin} finite entries), "
              f"-inf pattern, counts and matched words equal")

    # times: 1,024 pairs, the whole plan, the serve batch's stragglers
    shapes = [("1,024 pairs", arrays, [x[:tile] for x in pairs], B),
              (f"all {P} pairs", arrays, pairs, B)]
    for arr, spairs, _, n_q in stragglers[:1]:
        shapes.append((f"stragglers ({spairs[0].shape[0]} pairs)", arr,
                       spairs, n_q))
    kk = 16
    rows = {}
    for name, arr, part, n_q in shapes:
        n_p = part[0].shape[0]
        if n_p:
            for split in ds.SPLITS:  # one CTA a pair, or a cluster
                got = ds.dense_topk_cuda(*arr, *part, n_q, kk, split=split)
                _check_fused(torch, got, ds.dense_topk_ref(*arr, *part, n_q,
                                                           kk),
                             f"{name} split={split}")

        def yardstick(arr=arr, part=part, n_q=n_q, with_topk=True):
            for a in range(0, part[0].shape[0], tile):
                sc, _ = ds.dense_scan_cuda(*arr, *[x[a:a + tile]
                                                   for x in part], n_q)
                if with_topk:
                    ds.topk_block(sc, kk)

        by_split = {
            split: _median_ms(torch, lambda s=split: ds.dense_topk_cuda(
                *arr, *part, n_q, kk, split=s))
            for split in ds.SPLITS}
        ms = _median_ms(torch, lambda: ds.dense_topk_cuda(*arr, *part, n_q,
                                                          kk))
        yard = _median_ms(torch, yardstick, n=5)
        unfused = _median_ms(torch, lambda: yardstick(with_topk=False), n=5)
        plain = _median_ms(torch, lambda: ds.dense_topk_ref(*arr, *part,
                                                            n_q, kk),
                           n=1, rounds=3)
        bound, by = k2_fused_bound(torch, arr, part, n_q, kk)
        ubound, _ = k2_bound(torch, part, n_q)
        print(f"[K2] {name}, kk={kk}: fused K2 {ms:.4f} ms (splits "
              + ", ".join(f"{k}: {v:.4f}" for k, v in by_split.items())
              + f"), unfused K2 + topk_block(16) {yard:.4f} ms (unfused "
              f"K2 alone {unfused:.4f} ms), plain "
              f"{plain:.3f} ms; fused bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of bound (the unfused mode's "
              f"bound {ubound:.4f} ms)")
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=by)
    # the torch top-k the fused mode replaces, alone on one tile's scores
    sc, _ = ds.dense_scan_cuda(*arrays, *[x[:tile] for x in pairs], B)
    topk_ms = _median_ms(torch, lambda: ds.topk_block(sc, kk))
    n_p = sc.shape[0]
    topk_bound, topk_by = _bound(sc.numel() * 4 + n_p * kk * 12,
                                 sc.numel())
    # the library call for the same function (its tie order differs)
    lib_topk_ms = _median_ms(torch, lambda: torch.topk(sc, kk, dim=1))
    print(f"[K2] topk_block({kk}) of {n_p} pairs' masked scores: "
          f"{topk_ms:.4f} ms, bound {topk_bound:.4f} ms ({topk_by}: each "
          f"score read once, values and docs written), "
          f"{100 * topk_bound / topk_ms:.1f}% of bound; torch.topk on the "
          f"same scores {lib_topk_ms:.4f} ms")
    del sc
    full = rows[f"all {P} pairs"]
    return dict(err=max(err, err_u), pairs=P, T=T, **full)


def _long_queries(n, rng):
    """n queries of 10-12 mid-frequency terms, a few with + and -."""
    out = []
    for i in range(n):
        terms = [f"w{int(t):05d}" for t in
                 rng.integers(20, 3000, size=int(rng.integers(10, 13)))]
        if i % 4 == 1:
            terms[0] = "+" + terms[0]
        if i % 4 == 2:
            terms[-1] = "-" + terms[-1]
        out.append(" ".join(terms))
    return out


def device_kernels(torch, tag, fn, top=6):
    """Device time by kernel name over one call of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    print(f"[{tag}] profiled warm batch: {wall:.3f} s wall (profiler on), "
          f"device kernels {busy:.4f} s in all ({len(rows)} names), device "
          f"idle {100 * max(wall - busy, 0.0) / wall:.1f}% of the wall")
    for name, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[{tag}]   {us / 1e3:.3f} ms  x{n}  {name[:90]}")


def phase_dense(torch, st, idx, served, n_cpu=256, n_deep=256, n_long=64):
    import numpy as np

    from seekstorm_tpu_torch import METRICS
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import wand_scan as ws

    queries = served["queries"]

    def reqs(rtype, qs=queries, **kw):
        return [st.SearchRequest(query=q, result_type=rtype, realtime=True,
                                 query_type_default=st.QueryType(t),
                                 **{"length": 10, **kw})
                for q, t in qs]

    os.environ["SEEKSTORM_TPU_NO_WAND"] = "1"
    try:
        ws.LAUNCHES = 0
        ds.LAUNCHES = 0
        t0 = time.perf_counter()
        topk = st.search_batch(idx, reqs(st.ResultType.Topk), device="cuda")
        t1 = time.perf_counter()
        topk_launches = ds.LAUNCHES
        ds.LAUNCHES = 0
        topkc = st.search_batch(idx, reqs(st.ResultType.TopkCount),
                                device="cuda")
        t2 = time.perf_counter()
        launches, k1 = ds.LAUNCHES, ws.LAUNCHES
        print(f"[dense] {len(queries)} queries, SEEKSTORM_TPU_NO_WAND=1: "
              f"Topk batch {t1 - t0:.3f} s (cold: uploads the dense "
              f"arrays), K2 launches {topk_launches}; TopkCount batch "
              f"{t2 - t1:.3f} s, K2 launches {launches} (fused, kk=16); "
              f"K1 launches {k1}")
        check(topk_launches > 0 and k1 == 0,
              "the dense route did not run on K2")
        check(launches == 1, "a kk <= 128 dense batch is one K2 launch")
        for tag, mine, ref in (("Topk", topk, served["topk"]),
                               ("TopkCount", topkc, served["topkc"])):
            bad = [(i, why) for i, (a, b) in enumerate(zip(mine, ref))
                   for ok, why in [_same_pages(a, b)] if not ok]
            print(f"[dense] {tag} pages vs the WAND route's: "
                  f"{len(mine) - len(bad)} of {len(mine)} equal, first "
                  f"mismatches {bad[:5]}")
            check(not bad, f"dense and WAND {tag} pages differ")

        lat = []
        snap0 = METRICS.snapshot()
        for _ in range(3):
            t0 = time.perf_counter()
            st.search_batch(idx, reqs(st.ResultType.TopkCount),
                            device="cuda")
            lat.append(time.perf_counter() - t0)
        snap1 = METRICS.snapshot()
        print(f"[dense] warm TopkCount batch of {len(queries)}: "
              f"{[round(x * 1e3, 1) for x in lat]} ms")
        _print_split("dense", lat, snap0, snap1)
        device_kernels(torch, "dense", lambda: st.search_batch(
            idx, reqs(st.ResultType.TopkCount), device="cuda"))

        cpu = st.search_batch(idx, reqs(st.ResultType.TopkCount,
                                        qs=queries[:n_cpu]), device="cpu")
        bad = [(i, why) for i, (a, b) in enumerate(zip(topkc[:n_cpu], cpu))
               for ok, why in [_pages_equal(a, b, rtol=0.0)] if not ok]
        print(f"[dense] cuda vs cpu pages on {n_cpu} queries: "
              f"{n_cpu - len(bad)} equal (ids, order and scores exactly), "
              f"first mismatches {bad[:5]}")
        check(not bad, "dense cuda and cpu pages differ")

        longq = [(q, "Union") for q in
                 _long_queries(n_long, np.random.default_rng(5))]
        for tag, rq, n_page in (
                ("pages 1990-2009", reqs(st.ResultType.TopkCount,
                                         qs=queries[:n_deep], offset=1990,
                                         length=20), 20),
                ("10-12 terms", reqs(st.ResultType.TopkCount, qs=longq),
                 10)):
            ds.LAUNCHES = 0
            t0 = time.perf_counter()
            got = st.search_batch(idx, rq, device="cuda")
            dt = time.perf_counter() - t0
            full = sum(len(r.results) == n_page for r in got)
            print(f"[dense] {len(rq)} queries, {tag}: {dt:.3f} s, "
                  f"{full} full pages, K2 launches {ds.LAUNCHES} "
                  f"({'unfused' if tag.startswith('pages') else 'fused'})")
            check(ds.LAUNCHES > 0 and full > 0
                  and all(len(r.results) <= n_page
                          and np.isfinite([x.score for x in r.results]).all()
                          for r in got), f"{tag} batch served")
            cpu = st.search_batch(idx, rq[:32], device="cpu")
            bad = [i for i, (a, b) in enumerate(zip(got, cpu))
                   if not _pages_equal(a, b, rtol=0.0)[0]]
            print(f"[dense]   cuda vs cpu on 32: mismatches {bad[:5]}")
            check(not bad, f"{tag}: cuda and cpu pages differ")
    finally:
        del os.environ["SEEKSTORM_TPU_NO_WAND"]
    return launches


def facet_requests(st, kind, n, realtime=True):
    """bench_facet.py's requests (its mk_reqs): n two-term queries from
    np.random.default_rng(100), as facet2 (TopkCount, brand counts and
    price ranges under a brand filter) or geosort (Topk by distance)."""
    import numpy as np

    qrng = np.random.default_rng(100)
    out = []
    for _ in range(n):
        q = (f"w{qrng.integers(20, 3000):05d} "
             f"w{qrng.integers(20, 3000):05d}")
        if kind == "facet2":
            ranges = st.Ranges(field="price", ranges=[
                ("cheap", 0), ("mid", 100), ("lux", 300)])
            out.append(st.SearchRequest(
                query=q, length=10, realtime=realtime,
                result_type=st.ResultType.TopkCount,
                query_facets=[st.QueryFacet(field="brand"),
                              st.QueryFacet(field="price", ranges=ranges)],
                facet_filter=[st.FacetFilter(field="brand",
                                             values=BRANDS[:6])]))
        else:
            out.append(st.SearchRequest(
                query=q, length=10, realtime=realtime,
                result_type=st.ResultType.Topk,
                result_sort=[st.ResultSort(field="loc", order="Ascending",
                                           base=[37.7, -122.4])]))
    return out


def tf_facet_requests(st, n, fields=("body",)):
    """facet2's requests (facets, brand filter) under a field_filter."""
    return [dataclasses.replace(r, field_filter=list(fields))
            for r in facet_requests(st, "facet2", n)]


def k3_bound(torch, mwords, p_blk, codes, fcm, n_rows):
    """K3's least time on an H100 for these inputs, in ms, and what sets
    it.  Bytes moved once: the matched words of every pair, the pair
    tables, the codes (every facet) of each distinct block some pair with
    a matched doc names, and the histogram written.  Operations: one
    integer add a matched doc and facet, taken at the f32 rate."""
    from seekstorm_tpu_torch.ops.wand_scan import popcount32

    NF = codes.shape[0]
    hit = (mwords != 0).any(dim=1)
    n_blk = len(torch.unique(p_blk[hit]))
    matched = 0
    for a in range(0, mwords.shape[0], 4096):
        matched += int(popcount32(mwords[a:a + 4096]).sum())
    n_bytes = (mwords.numel() * 4 + p_blk.numel() * 8
               + n_blk * (1 << 16) * 4 * NF + NF * n_rows * fcm * 4)
    return _bound(n_bytes, matched * NF) + (matched,)


def k3_shapes(torch, st, idx, n_queries=N_QUERIES):
    """K3's inputs at the 2,048-query facet2 batch's own shapes, as
    [(name, mwords, p_blk, p_row, codes, fcm, n_rows)]: K1's matched words
    under the brand filter (the WAND route, row-major pairs), K2's
    fused-mode matched words over the batch's dense plan (block-major
    pairs), the same pairs in a shuffled order, the WAND shape with one wide
    code space (fcm=65,536, global atomics) and with the widest the shared
    histogram takes (NF*fcm = 8,192 bins), the tf scan's matched words of
    the faceted field_filter batch, and a ragged cut of those with three
    facets."""
    import importlib

    import numpy as np

    from seekstorm_tpu_torch import facets as facets_mod
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import facet_hist as fh
    from seekstorm_tpu_torch.ops import lexical as lx
    from seekstorm_tpu_torch.ops import wand as W
    from seekstorm_tpu_torch.ops import wand_scan as ws
    from seekstorm_tpu_torch.utils import ceil_pow2

    sm = importlib.import_module("seekstorm_tpu_torch.search")
    reqs = facet_requests(st, "facet2", n_queries)
    rt = facets_mod.get_runtime(idx)
    coded = [rt.codes_for(qf) for qf in reqs[0].query_facets]
    fcm = ceil_pow2(max(nc for _, _, nc in coded), 16)
    mask = rt.filter_mask(reqs[0].facet_filter)
    wstate = W.get_state(idx, "cuda")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    codes = put(sm._wand_facet_codes(idx, wstate, [c for c, _, _ in coded]))
    filt = sm._wand_filter_words(idx, wstate, mask)

    # the WAND route's shape: K1's matched words under the filter
    args = list(st.wand_inputs(idx, reqs, "cuda"))
    args[4] = put(filt.view(np.int32))
    mw = ws.wand_scan_cuda(*args, with_matched=True)[5]
    Bq, NBLK = mw.shape[0], args[2].shape[0]
    shapes = [("WAND route", mw.view(Bq * NBLK, NW),
               *fh.wand_pairs(Bq, NBLK, mw.device), codes, fcm, Bq)]
    del args

    # the dense route's shape: K2's fused-mode matched words over the plan
    plans, stacked = st.dense_plans(idx, reqs, device="cuda")
    pairs = [put(x) for x in stacked.pair_tables(plans)[:8]]
    arrays = (*stacked.arrays[:4],
              put((stacked.delw_host | filt).view(np.int32)))
    dmw = ds.dense_topk_cuda(*arrays, *pairs, n_queries, 16,
                             with_matched=True)[3]
    shapes.append(("dense route", dmw, pairs[0], pairs[1], codes, fcm,
                   n_queries))

    # the same pairs in a shuffled order: K3 assumes nothing of it
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    perm = torch.randperm(dmw.shape[0], generator=g, device="cuda")
    shapes.append(("dense route, shuffled pairs", dmw[perm],
                   pairs[0][perm].contiguous(), pairs[1][perm].contiguous(),
                   codes, fcm, n_queries))

    # one wide code space (a numeric facet without ranges): global atomics
    wide = torch.randint(-5, 65_541, (1, codes.shape[1]), generator=g,
                         device="cuda", dtype=torch.int32)
    shapes.append(("WAND route, wide codes", *shapes[0][1:4], wide, 65_536,
                   Bq))
    # the widest code space the shared histogram takes: 8,192 bins, one copy
    mid = torch.randint(-5, 4_101, (2, codes.shape[1]), generator=g,
                        device="cuda", dtype=torch.int32)
    shapes.append(("WAND route, 8,192 bins", *shapes[0][1:4], mid, 4_096, Bq))

    # the tf scan's matched words: the faceted field_filter batch of phase 9
    treqs = tf_facet_requests(st, N_TF)
    plans, stacked = st.dense_plans(idx, treqs, device="cuda", mode="tf")
    tpairs = [put(x) for x in stacked.pair_tables(plans)[:8]]
    boosts = idx.boosts_or_default().copy()
    boosts[[sf.indexed_field_id for sf in idx.indexed_fields
            if sf.field not in treqs[0].field_filter]] = 0.0
    tmw = ds.topk_tiles(
        functools.partial(lx.tf_scan, boosts=put(boosts)),
        *stacked.ensure_tf(), arrays[4], *tpairs, N_TF, 16,
        with_matched=True)[3]
    shapes.append(("tf scan", tmw, tpairs[0], tpairs[1], codes, fcm, N_TF))
    # a pair count that is no multiple of K3's chunk, fewer chunks than the
    # card holds CTAs, and an odd number of facets
    odd = torch.randint(-2, 19, (3, codes.shape[1]), generator=g,
                        device="cuda", dtype=torch.int32)
    shapes.append(("tf scan, 1,021 pairs, 3 facets", tmw[:1021],
                   tpairs[0][:1021], tpairs[1][:1021], odd, 16, N_TF))
    return shapes


def phase_k3(torch, st, idx, n_queries=N_QUERIES):
    """K3 against its plain version at the faceted batch's own shapes on
    both routes, in a shuffled pair order, at one wide code space and at
    the tf scan's shape; times, bound and share."""
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import facet_hist as fh
    from seekstorm_tpu_torch.ops.wand_scan import popcount32

    shapes = k3_shapes(torch, st, idx, n_queries)
    rows = {}
    for name, mwords, p_blk, p_row, cod, f, R in shapes:
        got = fh.facet_hist_cuda(mwords, p_blk, p_row, cod, f, R)
        want = fh.facet_hist_ref(mwords, p_blk, p_row, cod, f, R)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K3 counts differ ({name})")
        err = int((got - want).abs().max())
        ms = _median_ms(torch, lambda: fh.facet_hist_cuda(
            mwords, p_blk, p_row, cod, f, R))
        plain = _median_ms(torch, lambda: fh.facet_hist_ref(
            mwords, p_blk, p_row, cod, f, R), n=1, rounds=3)
        bound, by, matched = k3_bound(torch, mwords, p_blk, cod, f, R)
        check(int(got.sum()) == matched * cod.shape[0],
              f"K3 counts every matched doc once a facet ({name})")
        # the library yardstick: one torch.bincount over the (facet, row,
        # code) index of every matched doc, the unpacking done beforehand
        lib_ms = None
        try:
            flat = []
            for a in range(0, mwords.shape[0], 2048):
                pi, di = torch.nonzero(ds.unpack_words(mwords[a:a + 2048]),
                                       as_tuple=True)
                at = p_blk[a + pi].long() * (1 << 16) + di
                for fi in range(cod.shape[0]):
                    flat.append((fi * R + p_row[a + pi].long()) * f
                                + cod[fi, at].clamp(0, f - 1).long())
            flat = torch.cat(flat)
            n_bins = cod.shape[0] * R * f
            lib = torch.bincount(flat, minlength=n_bins)
            check(torch.equal(lib.view(got.shape).to(torch.int32), got),
                  f"torch.bincount disagrees ({name})")
            lib_ms = _median_ms(torch, lambda: torch.bincount(
                flat, minlength=n_bins), n=5)
            del flat, lib
        except torch.cuda.OutOfMemoryError as e:
            print(f"[K3] {name}: no library time, the unpacked indices do "
                  f"not fit ({e})")
        # what the walk meets: matched docs a pair, and one pass over the
        # words alone (a max over them as int64), the stream's own time
        per_pair = torch.cat([popcount32(mwords[a:a + 4096]).sum(dim=1)
                              for a in range(0, mwords.shape[0], 4096)])
        heavy = per_pair > 1000
        read_ms = _median_ms(torch,
                             lambda: mwords.view(torch.int64).amax(), n=5)
        print(f"[K3] {name}: docs a pair: {int((per_pair == 0).sum())} pairs "
              f"empty, median {int(per_pair.median())}, 99th percentile "
              f"{int(per_pair.float().quantile(0.99))}, most "
              f"{int(per_pair.max())}; {int(heavy.sum())} pairs above 1,000 "
              f"hold {100 * int(per_pair[heavy].sum()) / max(matched, 1):.1f}% "
              f"of the docs; one torch pass over the words {read_ms:.4f} ms")
        print(f"[K3] {name}: {mwords.shape[0]} pairs, NF={cod.shape[0]}, "
              f"fcm={f}, {matched} matched docs: counts equal; K3 {ms:.4f} "
              f"ms, plain {plain:.3f} ms, bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of bound; torch.bincount on indices "
              f"unpacked beforehand "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"))
        rows[name] = dict(err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
        torch.cuda.empty_cache()
    return dict(rows["WAND route"],
                err=max(r["err"] for r in rows.values()))


def _facets_equal(a, b, how):
    """Counts and facet lists equal, and pages equal by `how`: "exact" (ids
    in order, scores or sort keys exactly), "order" (ids in order, scores
    within PAGE_RTOL) or "cluster" (_same_pages, between two routes)."""
    if a.facets != b.facets:
        return False, "facets"
    if how == "cluster":
        return _same_pages(a, b)
    return _pages_equal(a, b, rtol=0.0 if how == "exact" else PAGE_RTOL)


def phase_facets(torch, st, idx, n_big=N_QUERIES, n_small=64):
    import numpy as np

    from seekstorm_tpu_torch import METRICS
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import facet_hist as fh
    from seekstorm_tpu_torch.ops import wand_scan as ws

    # each doc's brand, drawn as phase_index drew it (one shard: doc id =
    # position; the uncommitted docs follow the committed ones)
    brand_of = np.concatenate([
        np.random.default_rng(8).integers(0, len(BRANDS), size=N_DOCS),
        np.random.default_rng(9).integers(0, len(BRANDS), size=N_TAIL)])
    batches = [("facet2", n_small), ("geosort", n_small), ("facet2", n_big)]

    def run(kind, n, device="cuda"):
        ws.LAUNCHES = ds.LAUNCHES = fh.LAUNCHES = 0
        t0 = time.perf_counter()
        out = st.search_batch(idx, facet_requests(st, kind, n),
                              device=device)
        return out, time.perf_counter() - t0, (ws.LAUNCHES, ds.LAUNCHES,
                                               fh.LAUNCHES)

    def check_facet2(tag, rs_list):
        for rs in rs_list:
            check(all(brand_of[r.doc_id] < 6 for r in rs.results),
                  f"{tag}: a filtered page holds a disallowed brand")
            check(sum(c for _, c in rs.facets["brand"])
                  == rs.result_count_total,
                  f"{tag}: brand counts do not sum to the match count")
            check(sum(c for _, c in rs.facets["price"])
                  == rs.result_count_total,
                  f"{tag}: price ranges do not sum to the match count")
            check(all(lbl in BRANDS[:6] for lbl, _ in rs.facets["brand"]),
                  f"{tag}: a disallowed brand is counted")
        check(sum(rs.result_count_total > 0 for rs in rs_list)
              > len(rs_list) // 2, f"{tag}: most queries match")

    def check_geosort(tag, rs_list):
        for rs in rs_list:
            keys = [r.score for r in rs.results]
            check(keys == sorted(keys) and all(np.isfinite(keys)),
                  f"{tag}: a page is not in ascending distance")
        check(sum(len(rs.results) == 10 for rs in rs_list)
              > len(rs_list) // 2, f"{tag}: most pages are full")

    served = {}
    launches = {}
    # the default route: WAND at 16 blocks for facet2; a sorted batch takes
    # the dense path unless SEEKSTORM_TPU_WAND_SORT is set
    for kind, n in batches:
        fb0 = METRICS.snapshot().get("wand_fallbacks_total", 0.0)
        out, dt, (k1, k2, k3) = run(kind, n)
        fb = METRICS.snapshot().get("wand_fallbacks_total", 0.0) - fb0
        served[kind, n] = out
        launches[kind, n] = (k1, k2, k3)
        print(f"[facets] default route, {kind} x {n}: {dt:.3f} s (first "
              f"batch); K1 launches {k1}, K2 {k2}, K3 {k3}; WAND "
              f"stragglers {fb:.0f}")
        if kind == "facet2":
            check(k1 == 1 and k3 >= 1, "facet2 rides WAND: K1 and K3")
            check((k2 > 0) == (fb > 0 and n >= 512) and k3 == 1 + (k2 > 0),
                  "deferred stragglers take K2 and K3 with their facets, "
                  "and only they")
            check_facet2(f"default {kind} x {n}", out)
        else:
            check(k1 == 0 and k2 > 0 and k3 == 0,
                  "a sorted batch takes the dense path's unfused scan")
            check_geosort(f"default {kind} x {n}", out)

    lat = {}
    for kind, n in batches:
        snap0 = METRICS.snapshot()
        lat[kind, n] = [run(kind, n)[1] for _ in range(3)]
        snap1 = METRICS.snapshot()
        print(f"[facets] default route, warm {kind} batch of {n}: "
              f"{[round(x * 1e3, 1) for x in lat[kind, n]]} ms")
        _print_split("facets", lat[kind, n], snap0, snap1)
    for kind, n in (("facet2", n_big), ("geosort", n_small)):
        device_kernels(torch, f"facets {kind} x {n}", lambda: run(kind, n),
                       top=10)
    _profile(lambda: run("facet2", n_big))

    # cpu: the first 64 queries of each batch (the batch of 2,048 defers
    # its stragglers to the dense path; so does the cpu's batch of 64)
    os.environ["SEEKSTORM_TPU_WAND_DEFER_DENSE"] = "1"
    try:
        for kind, n in batches:
            cpu, _, _ = run(kind, n_small, device="cpu")
            bad = [(i, why) for i, (a, b) in
                   enumerate(zip(served[kind, n], cpu))
                   for ok, why in [_facets_equal(
                       a, b, "exact" if kind == "geosort" else "order")]
                   if not ok]
            print(f"[facets] default route, {kind} x {n}: cuda vs cpu on "
                  f"{n_small} queries: {n_small - len(bad)} equal (counts, "
                  f"facet lists, ids and order), first mismatches {bad[:5]}")
            check(not bad, f"{kind} x {n}: cuda and cpu differ")
    finally:
        del os.environ["SEEKSTORM_TPU_WAND_DEFER_DENSE"]

    # the dense route
    os.environ["SEEKSTORM_TPU_NO_WAND"] = "1"
    try:
        for kind, n in batches:
            out, dt, (k1, k2, k3) = run(kind, n)
            warm = [run(kind, n)[1] for _ in range(2)]
            print(f"[facets] dense route, {kind} x {n}: {dt:.3f} s, warm "
                  f"{[round(x * 1e3, 1) for x in warm]} ms; K1 launches "
                  f"{k1}, K2 {k2}, K3 {k3}")
            check(k1 == 0 and k2 > 0 and k3 == (kind == "facet2"),
                  "the dense route: K2, and one K3 launch a faceted batch")
            if kind == "facet2":
                check(k2 == 1, "a faceted top-10 batch is one K2 launch")
            bad = [(i, why) for i, (a, b) in
                   enumerate(zip(out, served[kind, n]))
                   for ok, why in [_facets_equal(
                       a, b, "exact" if kind == "geosort" else "cluster")]
                   if not ok]
            print(f"[facets]   vs the default route's: {n - len(bad)} of "
                  f"{n} equal, first mismatches {bad[:5]}")
            check(not bad, f"{kind} x {n}: the routes differ")
            cpu, _, _ = run(kind, n_small, device="cpu")
            bad = [(i, why) for i, (a, b) in enumerate(zip(out, cpu))
                   for ok, why in [_facets_equal(a, b, "exact")] if not ok]
            print(f"[facets]   cuda vs cpu on {n_small}: "
                  f"{n_small - len(bad)} equal (scores exactly), first "
                  f"mismatches {bad[:5]}")
            check(not bad, f"dense {kind} x {n}: cuda and cpu differ")
        device_kernels(torch, f"facets dense facet2 x {n_big}",
                       lambda: run("facet2", n_big), top=8)
        bound, by, P = rank_bound(torch, st, idx,
                                  facet_requests(st, "geosort", n_small))
        print(f"[facets] geosort x {n_small}, the dense scan with the "
              f"sort-key rank: {P} pairs, bound {bound:.4f} ms ({by})")
    finally:
        del os.environ["SEEKSTORM_TPU_NO_WAND"]

    # WAND rank-by-key
    os.environ["SEEKSTORM_TPU_WAND_SORT"] = "1"
    try:
        fb0 = METRICS.snapshot().get("wand_fallbacks_total", 0.0)
        out, dt, (k1, k2, k3) = run("geosort", n_small)
        fb = METRICS.snapshot().get("wand_fallbacks_total", 0.0) - fb0
        print(f"[facets] SEEKSTORM_TPU_WAND_SORT=1, geosort x {n_small}: "
              f"{dt:.3f} s; K1 launches {k1}, K2 {k2}, K3 {k3}; {fb:.0f} "
              f"queries fell through every rung to the host exact "
              f"evaluation")
        check(k1 == 1 and k3 == 0, "rank-by-key rides K1")
        check_geosort("WAND rank-by-key", out)
        bad = [(i, why) for i, (a, b) in
               enumerate(zip(out, served["geosort", n_small]))
               for ok, why in [_facets_equal(a, b, "exact")] if not ok]
        print(f"[facets]   vs the dense route's: {n_small - len(bad)} of "
              f"{n_small} equal (ids, order and keys exactly), first "
              f"mismatches {bad[:5]}")
        check(not bad, "rank-by-key pages differ from the dense route's")
        cpu, _, _ = run("geosort", n_small, device="cpu")
        bad = [i for i, (a, b) in enumerate(zip(out, cpu))
               if not _facets_equal(a, b, "exact")[0]]
        check(not bad, f"rank-by-key: cuda and cpu differ at {bad[:5]}")
    finally:
        del os.environ["SEEKSTORM_TPU_WAND_SORT"]
    return dict(k3_launches=launches["facet2", n_big][2],
                launches=launches)


def phase_tf(torch, st, idx, n=N_TF, n_cpu=64):
    """field_filter batches: the tf path through search_batch."""
    import numpy as np

    import bench
    from seekstorm_tpu_torch import METRICS
    from seekstorm_tpu_torch.ops import dense_scan as ds
    from seekstorm_tpu_torch.ops import facet_hist as fh
    from seekstorm_tpu_torch.ops import wand_scan as ws

    queries = bench.make_queries(n, np.random.default_rng(100))

    def plain(fields):
        return [st.SearchRequest(query=q, length=10, realtime=True,
                                 result_type=st.ResultType.TopkCount,
                                 query_type_default=st.QueryType(t),
                                 field_filter=list(fields))
                for q, t in queries]

    batches = [("title", plain(["title"])), ("body", plain(["body"])),
               ("facet2 under body", tf_facet_requests(st, n))]

    def run(reqs, device="cuda"):
        ws.LAUNCHES = ds.LAUNCHES = fh.LAUNCHES = 0
        t0 = time.perf_counter()
        out = st.search_batch(idx, reqs, device=device)
        return out, time.perf_counter() - t0, (ws.LAUNCHES, ds.LAUNCHES,
                                               fh.LAUNCHES)

    served = {}
    k3_launches = 0
    for tag, reqs in batches:
        out, dt, (k1, k2, k3) = run(reqs)
        faceted = bool(reqs[0].query_facets)
        snap0 = METRICS.snapshot()
        lat = [run(reqs)[1] for _ in range(3)]
        snap1 = METRICS.snapshot()
        print(f"[tf] field_filter {tag} x {len(reqs)}: {dt:.3f} s (first "
              f"batch: uploads the tf arrays), warm "
              f"{[round(x * 1e3, 1) for x in lat]} ms; K1 launches {k1}, K2 "
              f"{k2}, K3 {k3}")
        _print_split("tf", lat, snap0, snap1)
        check(k1 == 0 and k2 == 0,
              "a tf batch takes neither the WAND route nor K2")
        check(k3 == (1 if faceted else 0),
              "a faceted tf batch counts its facets in one K3 launch")
        k3_launches += k3
        check(sum(r.result_count_total > 0 for r in out) > len(out) // 2
              and all(len(r.results) <= 10
                      and np.isfinite([x.score for x in r.results]).all()
                      for r in out), f"tf {tag}: most queries match")
        if faceted:
            for rs in out:
                check(sum(c for _, c in rs.facets["brand"])
                      == rs.result_count_total
                      and all(lbl in BRANDS[:6]
                              for lbl, _ in rs.facets["brand"]),
                      f"tf {tag}: brand counts sum to the match count")
        served[tag] = out
        cpu, _, _ = run(reqs[:n_cpu], device="cpu")
        bad = [(i, why) for i, (a, b) in enumerate(zip(out, cpu))
               for ok, why in [_facets_equal(a, b, "exact")] if not ok]
        print(f"[tf]   cuda vs cpu on {n_cpu}: {n_cpu - len(bad)} equal "
              f"(counts, facet lists, ids, order and scores exactly), first "
              f"mismatches {bad[:5]}")
        check(not bad, f"tf {tag}: cuda and cpu differ")
    # what a tf plan holds: pairs, postings in its ranges, dense-term rows
    plans, stacked = st.dense_plans(idx, batches[1][1], device="cuda",
                                    mode="tf")
    tables = stacked.pair_tables(plans)
    n_post = int(tables[4].sum())
    n_dense = len(np.unique(tables[5][tables[5] >= 0]))
    F = len(idx.indexed_fields)
    # the tf scan's least time (the reference's lexical_scan, 184-267):
    # each posting in the ranges read once (a 2-byte doc id, F 2-byte tfs
    # and its doc's F 4-byte norms), each dense-term row (65,536 docs of F
    # 2-byte tfs), the delete words of each block, the pair tables; the
    # page (10 entries of 8 bytes) and the count written a query
    tf_bound, tf_by = _bound(
        n_post * (2 + 6 * F) + n_dense * (1 << 16) * 2 * F
        + len(np.unique(tables[0])) * NW * 4
        + sum(x.nbytes for x in tables[:8]) + n * (10 * 8 + 4),
        (n_post + n_dense * (1 << 16)) * (6 * F + 2))
    print(f"[tf] the body batch's plan: {len(tables[0])} pairs, "
          f"{n_post} postings in their ranges, "
          f"{int((tables[5] >= 0).sum())} dense-term rows "
          f"({n_dense} distinct); the tf scan's bound {tf_bound:.4f} ms "
          f"({tf_by})")
    device_kernels(torch, f"tf body x {n}", lambda: run(batches[1][1]),
                   top=10)
    device_kernels(torch, f"tf facet2 under body x {n}",
                   lambda: run(batches[2][1]), top=10)

    # terms dense enough for the dense-term store (32,768 postings of a
    # block and up: the corpus's most frequent words), which the tf scan
    # scores from whole rows of per-field tf, not from posting ranges
    dense_q = ["w00000 w00100", "+w00001 w00200", "w00002 -w00000", "w00003",
               "w00000 w00001", "+w00000 +w00002", "w00001 w00350 w00002",
               "w00150 -w00003"]
    reqs = [st.SearchRequest(query=q, length=10, realtime=True,
                             result_type=st.ResultType.TopkCount,
                             field_filter=["body"]) for q in dense_q]
    plans, stacked = st.dense_plans(idx, reqs, device="cuda", mode="tf")
    n_dense = int((stacked.pair_tables(plans)[5] >= 0).sum())
    out, dt, _ = run(reqs)
    cpu, _, _ = run(reqs, device="cpu")
    bad = [(i, why) for i, (a, b) in enumerate(zip(out, cpu))
           for ok, why in [_facets_equal(a, b, "exact")] if not ok]
    print(f"[tf] {len(reqs)} queries on dense terms under body: {dt:.3f} s, "
          f"{n_dense} dense-term rows in the plan; cuda vs cpu: "
          f"{len(reqs) - len(bad)} equal exactly, first mismatches {bad[:5]}")
    check(n_dense > 0 and all(r.result_count_total > 0 for r in out),
          "the dense-term batch reaches the dense-term rows and matches")
    check(not bad, "tf dense terms: cuda and cpu differ")

    # naming every indexed field is no filter: the impact routes, and the
    # unfiltered batch's results
    both, _, (k1, k2, _) = run(plain(["title", "body"]))
    none, _, _ = run(plain([]))
    check(k1 + k2 > 0, "field_filter of every field takes the impact routes")
    bad = [i for i, (a, b) in enumerate(zip(both, none))
           if not _facets_equal(a, b, "exact")[0]]
    print(f"[tf] field_filter of both fields vs none: {n - len(bad)} of {n} "
          f"equal, first mismatches {bad[:5]}")
    check(not bad, "field_filter of every field differs from no filter")
    for tag in ("title", "body"):
        check(all(a.result_count_total <= b.result_count_total
                  for a, b in zip(served[tag], none)),
              f"a {tag}-only count exceeds the unfiltered count")
    return dict(k3_launches=k3_launches)


# ---------------------------------------------------------------------------
# phases 10 and 11: the vector scan (K4) and vector / hybrid serving

I8_OPS_S = 1979e12          # H100 SXM dense int8 tensor-core rate
N_VEC = 1 << 20             # committed vectors of phase 11's index
N_VEC_TAIL = 5_000
N_VEC_QUERIES = 256
VEC_BATCH = 64              # bench_vector.py --batch
# recall@10 at All: the exhaustive scan ranks by the i8 scores, which the
# reference computes bit for bit the same; on this proxy they find 97% of
# the exact top 10 (0.9738 in this phase on an NVIDIA H100 80GB HBM3), so
# the check holds the port just under that, not to 0.99, which the i8
# scores of this index cannot reach
RECALL_ALL_MIN = 0.97
F32_EPS = 2.0 ** -24


def _k4_pool(torch, g, n_tiles, d, quantized, n_fields=3, p_del=0.1):
    """Random committed vectors on g's device: data, the per-row stats and
    metadata as IndexVectors.device lays them out, a deleted mask with
    about p_del of the docs set, and the last tile's second half padding."""
    dev = g.device
    T = 256
    if quantized:
        data = torch.randint(-128, 128, (n_tiles, T, d), generator=g,
                             device=dev, dtype=torch.int8)
        qsum = data.float().sum(-1)
        scale = torch.rand((n_tiles, T), generator=g, device=dev) * 0.02 \
            + 1e-3
        zp = torch.randn((n_tiles, T), generator=g, device=dev)
        norm2 = ((data.float() + 128.0) * scale[..., None]
                 + zp[..., None]).square().sum(-1)
    else:
        data = torch.randn((n_tiles, T, d), generator=g, device=dev)
        qsum = torch.zeros((n_tiles, T), device=dev)
        scale = torch.ones((n_tiles, T), device=dev)
        zp = torch.zeros((n_tiles, T), device=dev)
        norm2 = data.square().sum(-1)
    n = n_tiles * T
    docid = torch.arange(n, dtype=torch.int32, device=dev).view(n_tiles, T)
    docid[-1, T // 2:] = -1
    fieldid = torch.randint(0, n_fields, (n_tiles, T), generator=g,
                            device=dev, dtype=torch.int32)
    deleted = torch.rand(n + 64, generator=g, device=dev) < p_del
    return dict(data=data, scale=scale, zp=zp, qsum=qsum, norm2=norm2,
                docid=docid, fieldid=fieldid, deleted=deleted)


def _k4_queries(torch, g, B, d, quantized):
    dev = g.device
    if quantized:
        q = torch.randint(-128, 128, (B, d), generator=g, device=dev,
                          dtype=torch.int8)
        qs = torch.rand(B, generator=g, device=dev) * 0.02 + 1e-3
        qz = torch.randn(B, generator=g, device=dev)
        qq = q.float().sum(-1)
        qn = ((q.float() + 128.0) * qs[:, None] + qz[:, None]).square().sum(-1)
    else:
        q = torch.randn((B, d), generator=g, device=dev)
        qs = torch.ones(B, device=dev)
        qz = torch.zeros(B, device=dev)
        qq = torch.zeros(B, device=dev)
        qn = q.square().sum(-1)
    return q, qs, qz, qq, qn


def _k4_args(pool, tile_ids, field_ok, qargs, score_min):
    return (pool["data"], pool["scale"], pool["zp"], pool["qsum"],
            pool["norm2"], pool["docid"], pool["fieldid"], pool["deleted"],
            tile_ids, field_ok, *qargs, score_min)


def _f32_tol(torch, pool, qargs, euclidean):
    """Per-query bound on |K4 - plain| in the f32 mode: the two dots differ
    only by the sum order, each within d*eps*sum|q_i r_i| of the exact
    value (eps = 2^-24), so they differ by at most 2.1*d*eps*sum|q_i r_i|;
    the Euclidean form doubles it and adds a rounding of the result (4 eps
    of the largest score).  The largest over the pool's rows."""
    data = pool["data"].reshape(-1, pool["data"].shape[-1])
    d = data.shape[1]
    with torch.no_grad():
        A = (qargs[0].abs() @ data.abs().T).amax(dim=1)
    tol = 2.1 * d * F32_EPS * A
    if euclidean:
        smax = qargs[4] + pool["norm2"].amax() + 2 * A
        tol = 2 * tol + 4 * F32_EPS * smax
    return tol


def _check_k4(torch, got, want, tol, band, smin, kk, tag):
    """i8 (tol None): scores, rows and counts bitwise equal.  f32: counts
    within `band` (the rows scoring within tol of the threshold), finite
    scores within tol, rows equal where a score stands further than 2*tol
    from its neighbours and from the threshold.  Returns the largest score
    difference."""
    (gs, gr, gc), (ws, wr, wc) = got, want
    if tol is None:
        check(torch.equal(gs.view(torch.int32), ws.view(torch.int32))
              and torch.equal(gr, wr) and torch.equal(gc, wc),
              f"K4 differs from vector_scan_ref bitwise ({tag})")
        return 0.0
    t = tol[:, None]
    fin = torch.isfinite(ws) & torch.isfinite(gs)
    diff = torch.where(fin, (gs - ws).abs(), torch.zeros_like(gs))
    check(bool((diff <= t).all()), f"K4 f32 scores outside the bound ({tag})")
    check(bool(((gc - wc).abs() <= band).all()),
          f"K4 f32 counts differ beyond the rows at the threshold ({tag})")
    w = torch.where(torch.isfinite(ws), ws, torch.full_like(ws, -1e30))
    inf = torch.full_like(w[:, :1], float("inf"))
    gap_up = torch.cat([inf, w[:, :-1] - w[:, 1:]], 1)
    gap_dn = torch.cat([w[:, :-1] - w[:, 1:], torch.zeros_like(inf)], 1)
    iso = fin & (gap_up > 2 * t) & (gap_dn > 2 * t) \
        & ((ws - smin[:, None]).abs() > 2 * t)
    iso[:, kk - 1:] = False
    check(bool((gr[iso] == wr[iso]).all()),
          f"K4 f32 rows differ where scores stand apart ({tag})")
    return float(diff.max())


def k4_bound(n_rows, d, B, k, quantized, n_deleted, use_field_filter):
    """K4's least time on an H100, in ms, and what sets it: every scanned
    row's vector (d bytes i8, 4d f32), stats (16 bytes), docid (4 bytes),
    field id (4 bytes, read only under a field filter) and deleted flag
    (one byte a row, at most the mask's n_deleted) read once, the queries
    read and the [B, k] result and counts written once; or the dots'
    2*B*n*d operations at the int8 tensor-core rate (f32: the f32 rate)."""
    per_row = d * (1 if quantized else 4) + 20 + (4 if use_field_filter
                                                  else 0)
    n_bytes = (n_rows * per_row + min(n_deleted, n_rows)
               + B * (d * (1 if quantized else 4) + 20) + B * (k * 8 + 4))
    ops = 2.0 * B * n_rows * d
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / (I8_OPS_S if quantized else F32_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k4(torch):
    """K4 against vector_scan_ref on random pools, every mode, and at the
    serving shape with its time, bound and share."""
    import numpy as np

    from seekstorm_tpu_torch.ops import vector as V
    from seekstorm_tpu_torch.ops import vector_scan as vs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    rng = np.random.default_rng(10)
    n_tiles, d, B = 40, 128, 40        # B: one full and one partial block
    max_err = 0.0
    n_cases = 0
    for quantized in (True, False):
        pool = _k4_pool(torch, g, n_tiles, d, quantized)
        qargs = _k4_queries(torch, g, B, d, quantized)
        for euclidean in (False, True):
            tol = None if quantized else _f32_tol(torch, pool, qargs,
                                                  euclidean)
            for exhaustive in (True, False):
                sel = np.sort(rng.choice(n_tiles, 13, replace=False))
                tid = torch.from_numpy(np.concatenate(
                    [sel, [-1, -1, -1]]).astype(np.int32)).to(dev)
                small = torch.from_numpy(
                    np.array([2, 7, -1, -1], np.int32)).to(dev)
                for use_ff in (False, True):
                    field_ok = torch.tensor([True, False, True, False],
                                            device=dev)
                    for k in (32, 256, 2048):
                        tiles = tid if k < 2048 or exhaustive else small
                        # a threshold that cuts: the 100th best unmasked
                        # score for half the queries, none for the rest
                        base = V.vector_scan_ref(*_k4_args(
                            pool, tiles, field_ok, qargs,
                            torch.full((B,), float("-inf"), device=dev)),
                            k=100, quantized=quantized, euclidean=euclidean,
                            with_counts=False, exhaustive=exhaustive,
                            use_field_filter=use_ff)[0][:, -1]
                        smin = torch.where(
                            torch.arange(B, device=dev) % 2 == 0, base,
                            torch.full_like(base, float("-inf")))
                        args = _k4_args(pool, tiles, field_ok, qargs, smin)
                        kw = dict(k=k, quantized=quantized,
                                  euclidean=euclidean, with_counts=True,
                                  exhaustive=exhaustive,
                                  use_field_filter=use_ff)
                        got = vs.vector_scan_cuda(*args, **kw)
                        want = V.vector_scan_ref(*args, **kw)
                        torch.cuda.synchronize()
                        NT = n_tiles if exhaustive else tiles.shape[0]
                        tag = (f"{'i8' if quantized else 'f32'} "
                               f"{'euclid' if euclidean else 'dot'} "
                               f"{'all' if exhaustive else 'sel'} "
                               f"ff={use_ff} k={k} NT={NT}")
                        band = None
                        if tol is not None:
                            every = V.vector_scan_ref(*_k4_args(
                                pool, tiles, field_ok, qargs,
                                torch.full_like(smin, float("-inf"))),
                                **dict(kw, k=NT * 256))[0]
                            band = ((every - smin[:, None]).abs()
                                    <= tol[:, None]).sum(1)
                        err = _check_k4(torch, got, want, tol, band, smin,
                                        min(k, NT * 256), tag)
                        check(bool((want[2] > 0).any()),
                              f"K4 case matches nothing ({tag})")
                        max_err = max(max_err, err)
                        n_cases += 1
    print(f"[K4] {n_cases} cases (i8 and f32, dot and Euclidean, all tiles "
          f"and selected tiles with -1 padding, field filter off and on, "
          f"k in 32/256/2048 with one NT*256 < k, 10% deleted, a threshold "
          f"that cuts): i8 bitwise equal to vector_scan_ref (scores, rows, "
          f"counts); f32 within the sum-order bound, max |diff| "
          f"{max_err:.3g}")

    # the serving shape: B=64, 1,048,576 rows, d=128, i8, all tiles, k=32
    B, n_tiles, k = 64, (1 << 20) // 256, 32
    pool = _k4_pool(torch, g, n_tiles, d, True, n_fields=1, p_del=0.01)
    qargs = _k4_queries(torch, g, B, d, True)
    field_ok = torch.ones(4, dtype=torch.bool, device=dev)
    smin = torch.full((B,), float("-inf"), device=dev)
    args = _k4_args(pool, None, field_ok, qargs, smin)
    kw = dict(k=k, quantized=True, euclidean=True, with_counts=True,
              exhaustive=True, use_field_filter=False)
    got = vs.vector_scan_cuda(*args, **kw)
    want = V.vector_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    _check_k4(torch, got, want, None, None, smin, k, "serving shape")
    ms = _median_ms(torch, lambda: vs.vector_scan_cuda(*args, **kw))
    plain = _median_ms(torch, lambda: V.vector_scan_ref(*args, **kw), n=1,
                       rounds=3)
    n_rows = n_tiles * 256
    bound, by = k4_bound(n_rows, d, B, k, True, pool["deleted"].shape[0],
                         use_field_filter=False)
    # the yardstick: one f32 matmul of the same shapes (TF32 off) and
    # torch.topk, no corrections or masks
    xf = pool["data"].reshape(-1, d).float()
    qf = qargs[0].float()
    with V.full_f32():
        lib = _median_ms(torch, lambda: torch.topk(qf @ xf.T, k, dim=1),
                         n=5)
    del xf
    print(f"[K4] serving shape (B={B}, {n_rows} rows, d={d}, i8, Euclidean, "
          f"all tiles, k={k}): bitwise equal; K4 + merge {ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of it; plain "
          f"{plain:.3f} ms; f32 matmul + torch.topk {lib:.4f} ms")
    device_kernels(torch, "K4 serving shape",
                   lambda: vs.vector_scan_cuda(*args, **kw))
    return dict(err=max_err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib)


class _recording_vector_scans:
    """Within the block, keeps the (args, kw, result) of every vector scan
    the serving path makes (ops/vector.vector_scan_topk), as a list."""

    def __enter__(self):
        from seekstorm_tpu_torch.ops import vector as V

        self.V, self.orig, self.calls = V, V.vector_scan_topk, []

        def rec(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        V.vector_scan_topk = rec
        return self.calls

    def __exit__(self, *exc):
        self.V.vector_scan_topk = self.orig


def _vec_reqs(st, vecs, mode="All", nprobe=0, thr=None, queries=None):
    """Vector requests (Hybrid where `queries` gives the text), top-10
    TopkCount pages with the realtime tail."""
    out = []
    for i, v in enumerate(vecs):
        kw = {}
        if queries is not None:
            q, t = queries[i]
            kw = dict(search_mode=st.SearchMode.Hybrid, query=q,
                      query_type_default=st.QueryType(t))
        else:
            kw = dict(search_mode=st.SearchMode.Vector)
        out.append(st.SearchRequest(
            query_vector=v.tolist(), length=10, top_n=10, ann_mode=mode,
            nprobe=nprobe, similarity_threshold=thr, realtime=True,
            result_type=st.ResultType.TopkCount, **kw))
    return out


def _exact_pages(a, b):
    return (a.result_count_total == b.result_count_total
            and [(r.doc_id, r.score) for r in a.results]
            == [(r.doc_id, r.score) for r in b.results])


def phase_vector(torch, st, n_vec=N_VEC, n_tail=N_VEC_TAIL,
                 n_queries=N_VEC_QUERIES, batch=VEC_BATCH, n_cpu=64):
    """Vector and hybrid search through search_batch on bench_vector.py's
    SIFT proxy with a text field from bench.make_corpus."""
    import numpy as np

    import bench
    import bench_vector
    from seekstorm_tpu_torch.ops import vector as V
    from seekstorm_tpu_torch.ops import vector_scan as vs

    t0 = time.perf_counter()
    base, queries = bench_vector.make_proxy("sift", n_vec,
                                            np.random.default_rng(11))
    tail = bench_vector.make_proxy("sift", n_tail,
                                   np.random.default_rng(12))[0]
    queries = queries[:n_queries]
    corpus = bench.make_corpus(n_vec + n_tail, 30_000,
                               np.random.default_rng(7))
    t1 = time.perf_counter()
    path = WORK / "vindex"
    shutil.rmtree(path, ignore_errors=True)
    meta = st.IndexMeta(vector=st.VectorConfig(     # bench_vector.py:118-135
        enabled=True, dim=base.shape[1],
        similarity=st.VectorSimilarity.Euclidean,
        precision=st.Precision.I8,
        quantization=st.Quantization.ScalarQuantizationI8,
        inference=st.InferenceType.External,
        clustering=st.ClusteringConfig(mode=st.ClusteringMode.Auto)))
    schema = [st.SchemaField("vector", st.FieldType.Json, index_vector=True),
              st.SchemaField("body", st.FieldType.Text, indexed=True)]
    idx = st.create_index(path, schema, meta=meta, shard_count=1)
    for a in range(0, n_vec, 8192):
        idx.index_documents([{"vector": base[i], "body": corpus[i]["body"]}
                             for i in range(a, min(a + 8192, n_vec))])
    t2 = time.perf_counter()
    idx.commit()
    t3 = time.perf_counter()
    idx.index_documents([{"vector": tail[i],
                          "body": corpus[n_vec + i]["body"]}
                         for i in range(n_tail)])
    t4 = time.perf_counter()
    shard = idx.shards[0]
    dev = idx.vectors.device(shard, "cuda")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    print(f"[vector] SIFT proxy {n_vec} x {base.shape[1]} committed + "
          f"{n_tail} uncommitted, one text field: data {t1 - t0:.1f} s, "
          f"ingest {t2 - t1:.1f} s, commit {t3 - t2:.1f} s, tail ingest "
          f"{t4 - t3:.1f} s, first upload (global re-cluster + copy) "
          f"{t5 - t4:.1f} s; {len(idx.vectors.shards[0].levels)} levels, "
          f"{dev['n_clusters']} clusters, {dev['n_tiles']} tiles")
    check(sum(lv.n for lv in idx.vectors.shards[0].levels) == n_vec
          and len(idx.vectors.tail_rows(shard)[1]) == n_tail,
          "the index holds every vector, committed and in the tail")

    # exact f32 ground truth on the card (the proxy is integer-valued, so
    # every distance is an exact integer in f32): each query's 10th nearest
    # distance over committed and tail vectors; a returned doc is a hit
    # when its distance is at most that (ties count)
    X = torch.from_numpy(np.concatenate([base, tail])).cuda()
    xn = X.square().sum(1)
    Qd = torch.from_numpy(queries).cuda()
    qn = Qd.square().sum(1)
    with V.full_f32():
        d10 = torch.cat([torch.topk(qn[a:a + 64, None] + xn[None] - 2.0
                                    * (Qd[a:a + 64] @ X.T), 10, dim=1,
                                    largest=False).values[:, -1]
                         for a in range(0, n_queries, 64)])

    def recall(out, first=0):
        hits = 0
        for qi, rs in enumerate(out):
            ids = torch.tensor([r.doc_id for r in rs.results],
                               dtype=torch.int64, device="cuda")
            if len(ids):
                dist = (X[ids] - Qd[first + qi]).square().sum(1)
                hits += int((dist <= d10[first + qi]).sum())
        return hits / (10 * len(out))

    def serve(reqs, on="cuda"):
        vs.LAUNCHES = 0
        out, lat = [], []
        for a in range(0, len(reqs), batch):
            t = time.perf_counter()
            out += st.search_batch(idx, reqs[a:a + batch], device=on)
            lat.append(time.perf_counter() - t)
        return out, lat, vs.LAUNCHES

    n_batches = -(-n_queries // batch)
    sq = d10.sqrt().cpu().numpy()
    thr = float(np.median(sq))
    modes = [("All", _vec_reqs(st, queries)),
             ("Nprobe 16", _vec_reqs(st, queries, "Nprobe", 16)),
             ("Nprobe 33", _vec_reqs(st, queries, "Nprobe", 33)),
             (f"SimilarityThreshold {thr:.1f}",
              _vec_reqs(st, queries, "SimilarityThreshold", thr=thr))]
    results, launches = {}, 0
    for tag, reqs in modes:
        out, lat, k4 = serve(reqs)
        _, warm, _ = serve(reqs)
        check(k4 == n_batches, f"{tag}: K4 launches once a batch of the "
              f"one shard ({k4} in {n_batches} batches)")
        launches += k4
        r = recall(out)
        obs = np.array([rs.observed_vector_count for rs in out])
        ocl = np.array([rs.observed_cluster_count for rs in out])
        print(f"[vector] {tag} x {n_queries} in batches of {batch}: "
              f"recall@10 {r:.4f}; batches {[round(x * 1e3, 1) for x in lat]}"
              f" ms, warm {[round(x * 1e3, 1) for x in warm]} ms; K4 "
              f"launches {k4}; observed vectors a query mean "
              f"{obs.mean():.0f} min {obs.min()} max {obs.max()}, clusters "
              f"mean {ocl.mean():.1f}")
        check(all(len(rs.results) <= 10
                  and np.isfinite([x.score for x in rs.results]).all()
                  for rs in out), f"{tag}: finite pages of at most 10")
        results[tag] = (out, r)
    # K4 at the shapes the Nprobe path gives it (the gathered mode over the
    # selected tiles with -1 padding): a warm batch's own K4 results held
    # bitwise against vector_scan_ref on the same device tensors
    for tag in ("Nprobe 16", "Nprobe 33"):
        with _recording_vector_scans() as calls:
            st.search_batch(idx, dict(modes)[tag][:batch], device="cuda")
        check(len(calls) == 1, f"{tag}: one vector scan a batch")
        args, kw, got = calls[0]
        check(not kw["exhaustive"] and args[8].device.type == "cuda",
              f"{tag}: the batch scans selected tiles on the card")
        want = V.vector_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        _check_k4(torch, got, want, None, None, args[15], kw["k"],
                  f"{tag} batch")
        tids = args[8]
        print(f"[vector] {tag}: the batch's K4 result (B={len(args[15])}, "
              f"{int((tids >= 0).sum())} selected tiles padded to "
              f"{tids.shape[0]} of {dev['n_tiles']}, k={kw['k']}, counts "
              f"{'on' if kw['with_counts'] else 'off'}) bitwise equal to "
              f"vector_scan_ref (scores, rows, counts)")
    out_all, r_all = results["All"]
    check(r_all >= RECALL_ALL_MIN,
          f"recall@10 at All is {r_all:.4f}, below {RECALL_ALL_MIN}")
    check(all(rs.result_count_total == n_vec + n_tail
              and len(rs.results) == 10 for rs in out_all),
          "at All every vector is counted and every page is full")
    out_thr, _ = results[modes[3][0]]
    check(all(x.score <= thr * (1 + 1e-5) for rs in out_thr
              for x in rs.results)
          and any(len(rs.results) < 10 for rs in out_thr),
          "SimilarityThreshold keeps results within the distance and cuts")

    # where the time of a warm batch goes (device kernels by name)
    device_kernels(torch, "vector All x 64",
                   lambda: st.search_batch(idx, modes[0][1][:batch]))
    device_kernels(torch, "vector Nprobe 16 x 64",
                   lambda: st.search_batch(idx, modes[1][1][:batch]))

    # the same requests on "cpu": exact pages at All, recall at nprobe
    t = time.perf_counter()
    idx.vectors.device(shard, "cpu")
    cpu_up = time.perf_counter() - t
    cpu_all, _, _ = serve(modes[0][1][:n_cpu], on="cpu")
    bad = [i for i, (a, b) in enumerate(zip(out_all, cpu_all))
           if not _exact_pages(a, b)]
    print(f"[vector] cpu build (global re-cluster on the host's cores) "
          f"{cpu_up:.1f} s; All, cuda vs cpu on {n_cpu}: {n_cpu - len(bad)} "
          f"equal exactly (ids, scores, counts), first mismatches {bad[:5]}")
    check(not bad, "vector All: cuda and cpu differ")
    for tag in ("Nprobe 16", "Nprobe 33"):
        reqs = dict(modes)[tag][:n_cpu]
        cpu_out, _, _ = serve(reqs, on="cpu")
        rc, rg = recall(cpu_out), recall(results[tag][0][:n_cpu])
        print(f"[vector] {tag}, recall@10 on {n_cpu}: cuda {rg:.4f}, cpu "
              f"{rc:.4f}")
        check(abs(rc - rg) <= 0.02, f"{tag}: cpu and cuda recall differ")

    # hybrid: bench.make_queries text with the proxy's vectors (RRF)
    hq = bench.make_queries(n_cpu, np.random.default_rng(100))
    hreqs = _vec_reqs(st, queries[:n_cpu], queries=hq)
    vs.LAUNCHES = 0
    t = time.perf_counter()
    hyb = st.search_batch(idx, hreqs, device="cuda")
    dt = time.perf_counter() - t
    k4 = vs.LAUNCHES
    hyb_cpu = st.search_batch(idx, hreqs, device="cpu")
    bad = [i for i, (a, b) in enumerate(zip(hyb, hyb_cpu))
           if not _exact_pages(a, b)]
    print(f"[vector] hybrid x {n_cpu}: {dt:.3f} s (K4 launches {k4}); cuda "
          f"vs cpu: {n_cpu - len(bad)} equal exactly, first mismatches "
          f"{bad[:5]}")
    check(k4 == 1 and not bad and all(rs.results for rs in hyb),
          "hybrid: one K4 launch, full pages, cuda equal to cpu")
    del X, Qd
    shutil.rmtree(path, ignore_errors=True)
    return dict(k4_launches=launches, recall={
        tag: results[tag][1] for tag in ("All", "Nprobe 16", "Nprobe 33")},
        n_queries=n_queries)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "seekstorm_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, str(ROOT))
    WORK.mkdir(parents=True, exist_ok=True)
    import seekstorm_tpu_torch as st

    phase_card(torch)
    phase_build()
    k1 = phase_k1(torch)
    idx = phase_index(st)
    served = phase_serve(torch, st, idx)
    k2 = phase_k2(torch, st, idx, served["queries"],
                  served["stragglers"])
    k2_launches = phase_dense(torch, st, idx, served)
    k3 = phase_k3(torch, st, idx)
    faceted = phase_facets(torch, st, idx)
    tf = phase_tf(torch, st, idx)
    shutil.rmtree(WORK / "index", ignore_errors=True)
    del idx
    gc.collect()
    torch.cuda.empty_cache()
    k4 = phase_k4(torch)
    vec = phase_vector(torch, st)
    check(not [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "seekstorm_tpu")],
          "jax or the JAX package was imported")

    # K1's times are those at the serve batch's own shapes, K3's those at
    # the facet2 batch's on the WAND route, and K3's launches those of the
    # default-route facet2 batch of 2,048 plus the faceted tf batch's, each
    # read right after its batch; K4's times are those at the serving shape
    # (B=64, 1M rows, i8) and its launches those of phase 11's vector
    # batches on the card; no single PyTorch call computes K1's or K2's
    # function (library_ms null), K4's yardstick is a matmul and topk
    k1_main = served["k1"]
    print(f"[summary] vector recall@10 on {vec['n_queries']} queries: "
          + ", ".join(f"{tag} {r:.4f}" for tag, r in vec["recall"].items())
          + f" (floor at All {RECALL_ALL_MIN})")
    print(json.dumps({"kernels": [{
        "name": "wand_scan_cuda",
        "route": "cuda",
        "source": "seekstorm_tpu_torch/csrc/wand_scan.cu",
        "replaces": "seekstorm_tpu/ops/wand_pallas.py:247",
        "launches": served["k1_launches"],
        "max_abs_err": max([k1_main["err"]] + [r["err"] for r in k1]),
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
    }, {
        "name": "dense_scan_cuda",
        "route": "cuda",
        "source": "seekstorm_tpu_torch/csrc/dense_scan.cu",
        "replaces": "seekstorm_tpu/ops/lexical.py:363, "
                    "seekstorm_tpu/ops/lexical.py:327",
        "launches": k2_launches,
        "max_abs_err": k2["err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "facet_hist_cuda",
        "route": "cuda",
        "source": "seekstorm_tpu_torch/csrc/facet_hist.cu",
        "replaces": "seekstorm_tpu/ops/wand.py:247, "
                    "seekstorm_tpu/ops/lexical.py:297",
        "launches": faceted["k3_launches"] + tf["k3_launches"],
        "max_abs_err": k3["err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }, {
        "name": "vector_scan_cuda",
        "route": "cuda",
        "source": "seekstorm_tpu_torch/csrc/vector_scan.cu",
        "replaces": "seekstorm_tpu/ops/vector.py:74",
        "launches": vec["k4_launches"],
        "max_abs_err": k4["err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
