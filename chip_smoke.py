#!/usr/bin/env python3
"""Run the PyTorch port (seekstorm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found:

  1. card:   nvidia-smi name and power limit, torch's device name, and
             whether the native host library loaded (ingesting the corpus
             below needs it);
  2. build:  nvcc builds kernel K1 (csrc/wand_scan.cu) from the sources;
  3. K1:     K1 against its plain PyTorch version on random pools at the
             serving shapes (Bq=2048, NBLK=16, V=4096, T in {2,4,8}, filter
             off and on): counts equal and UBs bitwise equal, with both
             times (CUDA events, median of 20);
  4. index:  1,048,576 docs of bench.make_corpus (seed 7, vocab 30,000,
             title boost 10, 1 shard), committed, plus 5,000 uncommitted;
  5. serve:  bench.make_queries(2048, seed 100) as Topk and TopkCount with
             realtime=True through seekstorm_tpu_torch.search_batch on
             "cuda"; K1 must have launched; the warm batch latency and a
             cProfile of one warm batch (where the host's time goes);
             256 queries must give the same pages on "cpu", and 64
             queries with realtime=False the same pages as the host exact
             evaluation.

The script imports the port (seekstorm_tpu_torch), bench.py and torch;
jax is blocked.

Any failed check raises, so the exit code is not 0 and no result line is
printed.  Without CUDA, or without the repository beside it, the script
exits 1 at once.  The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
K1_SHAPES = dict(Bq=2048, NBLK=16, V=4096)
PAGE_RTOL = 3e-5


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuses every jax import: the port must run without it."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"{name} is blocked: the port must not use jax")
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
    if shutil.which("python") is None:
        # native/Makefile runs `python` to generate its tables
        shim = WORK / "bin"
        shim.mkdir(parents=True, exist_ok=True)
        if not (shim / "python").exists():
            (shim / "python").symlink_to(sys.executable)
        os.environ["PATH"] = f"{shim}{os.pathsep}{os.environ['PATH']}"
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
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] K1 library {_build.library_path().name}: {secs:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS})")
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


def _median_ms(torch, fn, n=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_k1(torch):
    import numpy as np

    from seekstorm_tpu_torch.ops import wand_scan as ws

    rng = np.random.default_rng(1)
    rows = []
    for T in ws.T_TIERS:
        for with_filter in (False, True):
            args = _k1_inputs(torch, rng, T=T, with_filter=with_filter,
                              **K1_SHAPES)
            ub_k, cnt_k = ws.wand_scan_cuda(*args)
            ub_r, cnt_r = ws.scan_blocks_ref(*args)
            torch.cuda.synchronize()
            check(torch.equal(cnt_k, cnt_r), f"K1 counts differ at T={T}")
            same_bits = torch.equal(ub_k.view(torch.int32),
                                    ub_r.view(torch.int32))
            fin = torch.isfinite(ub_r)
            check(torch.equal(fin, torch.isfinite(ub_k)),
                  f"K1 -inf pattern differs at T={T}")
            err = float((ub_k[fin] - ub_r[fin]).abs().max()) \
                if bool(fin.any()) else 0.0
            check(same_bits, f"K1 UBs not bitwise equal at T={T} "
                             f"(max abs err {err})")
            ms = _median_ms(torch, lambda: ws.wand_scan_cuda(*args))
            plain_ms = _median_ms(torch, lambda: ws.scan_blocks_ref(*args))
            print(f"[K1] T={T} filter={with_filter}: counts equal, UBs "
                  f"bitwise equal ({int(fin.sum())} finite of "
                  f"{fin.numel()}), K1 {ms:.3f} ms, plain {plain_ms:.3f} ms")
            rows.append(dict(T=T, filter=with_filter, err=err, ms=ms,
                             plain_ms=plain_ms))
            del args, ub_k, ub_r
            torch.cuda.empty_cache()
    return rows


def phase_index(st, n_docs=N_DOCS, n_tail=N_TAIL):
    import numpy as np

    import bench

    t0 = time.perf_counter()
    docs = bench.make_corpus(n_docs, 30_000, np.random.default_rng(7))
    tail = bench.make_corpus(n_tail, 30_000, np.random.default_rng(8))
    t1 = time.perf_counter()
    path = WORK / "index"
    shutil.rmtree(path, ignore_errors=True)
    schema = [
        st.SchemaField("title", st.FieldType.Text, indexed=True, boost=10.0),
        st.SchemaField("body", st.FieldType.Text, indexed=True),
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
    t0 = time.perf_counter()
    topk = st.search_batch(idx, reqs(st.ResultType.Topk), device=device)
    t1 = time.perf_counter()
    topkc = st.search_batch(idx, reqs(st.ResultType.TopkCount),
                            device=device)
    t2 = time.perf_counter()
    launches = ws.LAUNCHES
    fallbacks = METRICS.snapshot().get("wand_fallbacks_total", 0.0) - fb0
    print(f"[serve] {n_queries} queries: Topk batch {t1 - t0:.3f} s (cold: "
          f"builds the term rows), TopkCount batch {t2 - t1:.3f} s; K1 "
          f"launches {launches}; host exact fallbacks {fallbacks:.0f}")
    check(launches > 0 or device != "cuda",
          "the serve phase did not launch K1")
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
    spent = {k: snap1.get(f"{k}_seconds_total", 0.0)
             - snap0.get(f"{k}_seconds_total", 0.0)
             for k in ("lex_device", "wand_rescore", "wand_exact_fallback")}
    print(f"[serve] warm batches, seconds of {sum(lat):.3f} in all: device "
          f"dispatch to fetch {spent['lex_device']:.3f}, host rung rescore "
          f"{spent['wand_rescore']:.3f}, host exact evaluation "
          f"{spent['wand_exact_fallback']:.3f}, other host work (parse, "
          f"plan, tail merge, assembly) "
          f"{sum(lat) - sum(spent.values()):.3f}")
    _profile(lambda: st.search_batch(idx, reqs(st.ResultType.TopkCount),
                                     device=device))

    cpu = st.search_batch(idx, reqs(st.ResultType.TopkCount,
                                    qs=queries[:n_cpu]), device="cpu")
    bad = [(i, why) for i, (a, b) in enumerate(zip(topkc[:n_cpu], cpu))
           for ok, why in [_pages_equal(a, b)] if not ok]
    print(f"[serve] cuda vs cpu pages on {n_cpu} queries: "
          f"{n_cpu - len(bad)} equal, first mismatches {bad[:5]}")
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
    return launches


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
    launches = phase_serve(torch, st, idx)
    shutil.rmtree(WORK / "index", ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")

    main_row = next(r for r in k1 if r["T"] == 2 and not r["filter"])
    print(json.dumps({"kernels": [{
        "name": "wand_scan_cuda",
        "route": "cuda",
        "source": "seekstorm_tpu_torch/csrc/wand_scan.cu",
        "replaces": "seekstorm_tpu/ops/wand_pallas.py:247",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in k1),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
