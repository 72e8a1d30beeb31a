#!/usr/bin/env python3
"""Time an earlier commit's kernel K1, K3, K4 or K5 and K6 against the
current one on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 k1_compare.py build/parent
    python3 k1_compare.py --k3 build/parent
    python3 k1_compare.py --k4 build/parent
    python3 k1_compare.py --k56 build/parent

Both kernels run in this process on the same inputs, in turns (earlier,
current, current, earlier; each turn the median of 20 CUDA-event launches),
and their UBs and counts must be bitwise equal:

  * chip_smoke.py's random pools at T in {2, 4, 8}, filter off and on;
  * the pools, rows and tables of chip_smoke.py's 2,048-query serve batch
    (bench.make_queries, seed 100) at 1,048,576 docs.

Each line gives both times, each kernel's bound (chip_smoke.k1_bound: the
earlier K1 does not write the rung maxima) and the card's name and power
limit.  Then the device's kernel time by name over one warm default-route
2,048-query TopkCount batch (torch.profiler) of each tree: the current
tree's in this process, the earlier tree's in a subprocess that imports
that tree's package and loads the native library built here
(SEEKSTORM_TPU_NATIVE_LIB).

With --k3 the two facet histograms (csrc/facet_hist.cu of each tree; the C
entry point facet_hist_launch has not changed) run in the same turns at the
shapes of chip_smoke.k3_shapes, their counts must equal the plain version's,
and each line gives both times beside chip_smoke.k3_bound.

With --k4 the earlier tree's K4 (its csrc/vector_scan.cu, whose C entry
point vector_scan_launch has not changed, called through its own wrapper,
ops/vector_scan.py, which picks its route) and the current one run in the
same turns on chip_smoke.py's K4 pools (i8, d=128, Euclidean): the hybrid
cell's shape (128 queries, k=64 and k=32, 10,700 selected tiles of 13,203
padded with -1 to 16,384 slots) and the vector cell's (64 queries at k=32
over 1,024 selected tiles and over all 4,096 tiles of 1,048,576 rows), and
64 queries at k=64 over all 4,096 tiles.  Where the current running scan
serves a page of 33-64 two variants of it run in the same turns: built
with -DK4_BUCKETS=0 (no buckets: the shared threshold is gthr alone beside
each CTA's own kk-th), and with G capped at 128 ranges so that 64-entry
lists fit the merge's 8,192-entry pass (at 64 queries G is 132 and the
merge takes its 16,384-entry pass).  Every run must equal vector_scan_ref
bitwise, and each line gives the times beside chip_smoke.k4_bound.

With --k56 the earlier tree's K6 (csrc/wand_rungs.cu) and K5
(csrc/wand_rescore.cu) and the current ones are built side by side from
their sources (their C entry points wand_rungs_launch, rescore_page_launch
and exact_fold_launch have not changed), and ptxas's registers, shared
memory and spills of every K5/K6 kernel of both trees are printed.  Both
trees then run in the same turns, each timed twice: as launches on tensors
the current wrapper's launcher prepared (wand_rungs.rungs_launcher,
wand_rescore.page_launcher, fold_launcher), and through the wrapper's host
work (a launcher made and called each time: the earlier tree's wrappers
did the same host work).  They run K6 and K5 at rung 1 (K=64) and rung 2
(K=256) at the 2,048-query TopkCount serve batch's shapes and on facet2's
filtered batch (chip_smoke._ladder_inputs on phase 4's index), K5's fold
mode at one 4-query dispatch of the serve batch's pools, and K6 on
synthetic UBs at 77 blocks (bench.py's 5M docs) for 2,048 queries.  Each
must equal its plain version bit for bit; each line gives both times
beside chip_smoke.k6_bound, k5_bound or exact_scan_bound, and the
yardstick torch.topk(allub, 65) for K6 or, for K5, torch.topk of the
[Bq, K*32] rescored scores (the selection only: no one PyTorch call
computes K5's function).  Each batch's traffic is printed from the numpy
restatements (which must give the same result): per rung, K6's queries
with a finite cut, the lanes under it and the stage-2 path each takes;
K5's matched docs a query.  The current K6 is also timed against a build
of itself whose list tier is gone (LIST = 128), on the serve and facet2
batches and on a synthetic batch whose rung-1 queries all keep 129 to 512
lanes under their cut.  The device's kernel time by name over one warm
TopkCount batch of each tree comes last (as the K1 mode does).

The earlier K1 is the one whose C entry point is wand_scan_launch(ppool,
vpool, prow, V, delw, filtw, tcode, wshard, sid, Bq, nblk, T, with_counts,
allub, cnt, stream), as at commit 992e480.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_old(src: Path) -> ctypes.CDLL:
    """The earlier K1 from its source, built as the current ones are."""
    from seekstorm_tpu_torch import _build

    out = _build.BUILD_DIR / "libwand_scan_earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wand_scan_launch.argtypes = [P, P, P, I, P, P, P, P, P, I, I, I, I,
                                     P, P, P]
    lib.wand_scan_launch.restype = I
    return lib


def old_k1(torch, lib, args):
    """(allub, cnt) of the earlier K1 on chip_smoke's K1 arguments."""
    from seekstorm_tpu_torch.ops import wand_scan as ws

    ppool, vpool, prow, delw, filtw, tslot, treq, tneg, wshard, sid = args
    NBLK, V = prow.shape
    Bq, T = tslot.shape
    dev = ppool.device
    tcode = ws.tcodes(tslot, treq, tneg).to(torch.int32).contiguous()
    allub = torch.empty((Bq, NBLK * ws.NW), dtype=torch.float32, device=dev)
    cnt = torch.zeros(Bq, dtype=torch.int32, device=dev)
    err = lib.wand_scan_launch(
        ppool.data_ptr(), vpool.data_ptr(), prow.data_ptr(), V,
        delw.data_ptr(), filtw.data_ptr() if filtw is not None else None,
        tcode.data_ptr(), wshard.data_ptr(), sid.data_ptr(), Bq, NBLK, T, 1,
        allub.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"earlier K1 launch failed (error {err})")
    return allub, cnt


def compare(torch, lib, args, tag, card):
    from seekstorm_tpu_torch.ops import wand_scan as ws

    new = ws.wand_scan_cuda(*args)
    old = old_k1(torch, lib, args)
    torch.cuda.synchronize()
    for name, a, b in (("allub", old[0], new[0]), ("cnt", old[1], new[1])):
        cs.check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                 f"earlier and current K1 {name} differ ({tag})")
    del new, old
    turns = [cs._median_ms(torch, fn) for fn in (
        lambda: old_k1(torch, lib, args), lambda: ws.wand_scan_cuda(*args),
        lambda: ws.wand_scan_cuda(*args), lambda: old_k1(torch, lib, args))]
    old_b, old_by = cs.k1_bound(torch, args, with_maxima=False)
    new_b, new_by = cs.k1_bound(torch, args)
    row = dict(tag=tag, earlier_ms=[turns[0], turns[3]],
               current_ms=[turns[1], turns[2]], earlier_bound_ms=old_b,
               earlier_bound_by=old_by, current_bound_ms=new_b,
               current_bound_by=new_by, card=card)
    print(f"[compare] {tag}: allub and counts bitwise equal; earlier "
          f"{turns[0]:.3f} / {turns[3]:.3f} ms (bound {old_b:.3f}, "
          f"{100 * old_b * 2 / (turns[0] + turns[3]):.1f}%), current "
          f"{turns[1]:.3f} / {turns[2]:.3f} ms (bound {new_b:.3f}, "
          f"{100 * new_b * 2 / (turns[1] + turns[2]):.1f}%)")
    return row


def compare_k3(torch, tree: Path, card) -> list:
    """Earlier and current K3 at chip_smoke's K3 shapes, in turns."""
    import seekstorm_tpu_torch as st
    from seekstorm_tpu_torch import _build
    from seekstorm_tpu_torch.ops import facet_hist as fh

    current = _build.load("facet_hist")
    out = _build.BUILD_DIR / "libfacet_hist_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(tree / "seekstorm_tpu_torch" / "csrc"
                        / "facet_hist.cu")],
                   check=True, capture_output=True, text=True)
    earlier = ctypes.CDLL(str(out))
    earlier.facet_hist_launch.argtypes = \
        _build._SIGNATURES["facet_hist"]["facet_hist_launch"]
    earlier.facet_hist_launch.restype = ctypes.c_int

    def run(lib, args):
        _build._LIBS["facet_hist"] = lib     # the wrapper loads it from here
        return fh.facet_hist_cuda(*args)

    idx = cs.phase_index(st)
    rows = []
    for name, *args in cs.k3_shapes(torch, st, idx):
        want = fh.facet_hist_ref(*args)
        for tag, lib in (("earlier", earlier), ("current", current)):
            got = run(lib, args)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"{tag} K3 counts ({name})")
        turns = [cs._median_ms(torch, lambda lib=lib: run(lib, args))
                 for lib in (earlier, current, current, earlier)]
        bound, by, matched = cs.k3_bound(torch, args[0], args[1], args[3],
                                         args[4], args[5])
        rows.append(dict(tag=name, earlier_ms=[turns[0], turns[3]],
                         current_ms=[turns[1], turns[2]], bound_ms=bound,
                         bound_by=by, matched=matched, card=card))
        print(f"[compare] K3 {name}: {args[0].shape[0]} pairs, {matched} "
              f"matched docs, counts equal; earlier {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms ({100 * bound * 2 / (turns[0] + turns[3]):.1f}"
              f"% of the bound), current {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"({100 * bound * 2 / (turns[1] + turns[2]):.1f}%), bound "
              f"{bound:.4f} ms ({by})")
        del want
        torch.cuda.empty_cache()
    _build._LIBS["facet_hist"] = current
    return rows


def compare_k4(torch, tree: Path, card) -> list:
    """The earlier tree's K4 (source and wrapper) and the current one at
    the hybrid and vector cells' shapes, in turns, with two variants of the
    current running scan at pages of 33-64: built without its buckets, and
    with G capped at 128."""
    import importlib.util

    import numpy as np

    from seekstorm_tpu_torch import _build
    from seekstorm_tpu_torch.ops import vector_scan as vs

    current = _build.load("vector_scan")

    def build(name, source, *flags):
        out = _build.BUILD_DIR / f"libvector_scan_{name}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-Xptxas", "-v", *flags, "-o", str(out),
                              str(source)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc {source}: {res.stderr[-4000:]}")
        print_ptxas(res.stderr, f"K4 {name}", K4_KERNELS)
        lib = ctypes.CDLL(str(out))
        lib.vector_scan_launch.argtypes = \
            _build._SIGNATURES["vector_scan"]["vector_scan_launch"]
        lib.vector_scan_launch.restype = ctypes.c_int
        return lib

    csrc = tree / "seekstorm_tpu_torch" / "csrc" / "vector_scan.cu"
    earlier = build("earlier", csrc)
    build("current", _build.CSRC / "vector_scan.cu")
    no_buckets = build("no_buckets", _build.CSRC / "vector_scan.cu",
                       "-DK4_BUCKETS=0")
    # the earlier wrapper, as a module of the current package (its relative
    # imports resolve here; its kernel library is the earlier build)
    spec = importlib.util.spec_from_file_location(
        "seekstorm_tpu_torch.ops._earlier_vector_scan",
        tree / "seekstorm_tpu_torch" / "ops" / "vector_scan.py")
    earlier_vs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(earlier_vs)
    n_ranges = vs.n_ranges

    def run_with(wrapper, lib, ranges=None):
        def run(args, kw):
            _build._LIBS["vector_scan"] = lib   # the wrapper loads it here
            if ranges is not None:
                vs.n_ranges = ranges
            try:
                return wrapper.vector_scan_cuda(*args, **kw)
            finally:
                _build._LIBS["vector_scan"] = current
                vs.n_ranges = n_ranges
        return run

    runs = {"earlier": run_with(earlier_vs, earlier),
            "current": run_with(vs, current),
            "no buckets": run_with(vs, no_buckets),
            "G <= 128": run_with(vs, current, lambda *a: min(
                128, n_ranges(*a)))}

    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    d = 128
    rng = np.random.default_rng(10)
    rows = []
    # the hybrid cell: 3.38M rows in 13,203 tiles; a batch of 128 at nprobe
    # 48 probes about 81% of its 3,677 clusters, padded to a power of two
    n_hyb = 13_203
    pool = cs._k4_pool(torch, g, n_hyb, d, True, n_fields=1, p_del=0.01)
    qargs = cs._k4_queries(torch, g, 128, d, True)
    sel = np.sort(rng.choice(n_hyb, 10_700, replace=False))
    tid = torch.from_numpy(np.concatenate(
        [sel, np.full(16_384 - len(sel), -1)]).astype(np.int32)).cuda()
    shapes = [("hybrid cell", pool, qargs, 128, tid, 64),
              ("hybrid cell", pool, qargs, 128, tid, 32)]
    rows += _k4_turns(torch, runs, shapes, len(sel), card)
    del pool, qargs, tid, shapes
    torch.cuda.empty_cache()
    # the vector cell's pool and the 1,048,576-row serving shape
    n_tiles = (1 << 20) // 256
    pool = cs._k4_pool(torch, g, n_tiles, d, True, n_fields=1, p_del=0.01)
    qargs = cs._k4_queries(torch, g, 64, d, True)
    sel = np.sort(rng.choice(n_tiles, 1024, replace=False))
    tid = torch.from_numpy(sel.astype(np.int32)).cuda()
    rows += _k4_turns(torch, runs, [
        ("vector cell", pool, qargs, 64, tid, 32),
        ("serving shape", pool, qargs, 64, None, 32)], len(sel), card)
    rows += _k4_turns(torch, runs, [
        ("serving shape", pool, qargs, 64, None, 64)], n_tiles, card)
    return rows


def _k4_turns(torch, runs, shapes, n_sel, card) -> list:
    """Each shape (tag, pool, queries, B, tile ids or None, k): every run
    held bitwise to vector_scan_ref, then timed in turns (the variants of
    the running scan only at pages of 33-64)."""
    from seekstorm_tpu_torch.ops import vector as V

    rows = []
    for what, pool, qargs, B, tiles, k in shapes:
        n_tiles = pool["data"].shape[0]
        NT = n_tiles if tiles is None else tiles.shape[0]
        name = (f"{what}, {'all tiles' if tiles is None else f'{n_sel:,} selected tiles in {NT:,} slots'}"
                f", B={B}, k={k}")
        kw = dict(k=k, quantized=True, euclidean=True, with_counts=True,
                  exhaustive=tiles is None, use_field_filter=False)
        smin = torch.full((B,), float("-inf"), device="cuda")
        field_ok = torch.ones(4, dtype=torch.bool, device="cuda")
        args = cs._k4_args(pool, tiles, field_ok, [q[:B] for q in qargs],
                           smin)
        want = V.vector_scan_ref(*args, **kw)
        tags = [t for t in runs if k > 32 or t in ("earlier", "current")]
        for tag in tags:
            got = runs[tag](args, kw)
            torch.cuda.synchronize()
            cs._check_k4(torch, got, want, None, None, smin, k,
                         f"{tag} K4, {name}")
        del want
        order = tags + tags[::-1]
        turns = [cs._median_ms(torch, lambda run=runs[tag]: run(args, kw))
                 for tag in order]
        ms = {tag: [turns[i], turns[len(order) - 1 - i]]
              for i, tag in enumerate(tags)}
        n_rows = (n_tiles if tiles is None else n_sel) * 256
        bound, by = cs.k4_bound(n_rows, pool["data"].shape[2], B, k, True,
                                pool["deleted"].shape[0],
                                use_field_filter=False)
        rows.append(dict(tag=name, B=B, k=k, ms=ms, bound_ms=bound,
                         bound_by=by, card=card))
        print(f"[compare] K4 {name}: bitwise equal; " + ", ".join(
            f"{tag} {a:.4f} / {b:.4f} ms" for tag, (a, b) in ms.items())
            + f"; bound {bound:.4f} ms ({by}), current "
            f"{100 * bound / min(ms['current']):.2f}% of it")
        for tag in ("earlier", "current"):
            cs.device_kernels(torch, f"K4 {tag}, {name}",
                              lambda run=runs[tag]: run(args, kw))
    return rows


K4_KERNELS = ("running_scan", "tile_scan", "merge_lists", "select_threshold")
K56_KERNELS = ("rungs_kernel", "rescore_page_kernel", "exact_fold_kernel",
                "fold_merge_kernel")
K56_NAMES = ("wand_rungs", "wand_rescore")


def print_ptxas(log: str, tag: str, kernels=None) -> None:
    """What ptxas -v said of each kernel of `kernels` (K5/K6's by default)
    in `log` (registers, shared memory, spills)."""
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels or K56_KERNELS)
        if keep and ("Compiling entry" in line or "Used" in line
                     or "spill" in line):
            print(f"[ptxas {tag}] {line.strip()}")


def no_list_source(tree: Path) -> Path:
    """A copy of `tree`'s csrc/ whose K6 keeps no list past topk::KEPT
    (LIST = 128): a finite cut that leaves more lanes goes straight to the
    select over every lane, as it would with two paths."""
    src = tree / "seekstorm_tpu_torch" / "csrc"
    from seekstorm_tpu_torch import _build

    out = _build.BUILD_DIR / "k6_no_list"
    out.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    text = (src / "wand_rungs.cu").read_text()
    line = "constexpr int LIST = 512;"
    cs.check(text.count(line) == 1, "K6's LIST is not where it was")
    (out / "wand_rungs.cu").write_text(text.replace(
        line, "constexpr int LIST = 128;"))
    return out


def build_libs(jobs: dict) -> dict:
    """Libraries built side by side, as the package builds its own, from
    jobs {(tag, name): csrc dir}; ptxas's report of each K5/K6 kernel is
    printed under its tag.  Returns {tag: {name: library}}, each with the
    current C signatures."""
    from seekstorm_tpu_torch import _build

    procs, libs = {}, {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for (tag, name), src in jobs.items():
        out = _build.BUILD_DIR / f"lib{name}_{tag.replace(' ', '_')}.so"
        procs[tag, name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(src / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (tag, name), (out, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{tag} {name} build: {log[-2000:]}")
        print_ptxas(log, tag)
        lib = ctypes.CDLL(str(out))
        for fn, types in _build._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(tag, {})[name] = lib
    return libs


def _quantiles(v) -> str:
    import numpy as np

    if len(v) == 0:
        return "none"
    q = np.percentile(v, [50, 90, 99])
    return (f"median {q[0]:g}, p90 {q[1]:g}, p99 {q[2]:g}, max "
            f"{int(np.max(v))} of {len(v)}")


def k6_traffic(tag, allub, maxima, want) -> None:
    """K6's stage-2 paths over a batch, from ops/wand_rungs.rung_select_ref
    (the kernel's procedure in numpy; its result must equal `want`): per
    rung, the queries with a finite cut, the lanes under it, and the
    queries that sort them (<= 128), select from the list (<= 512) or
    select over every lane."""
    import numpy as np

    from seekstorm_tpu_torch.ops import wand_rungs as wg

    trace = []
    got = wg.rung_select_ref(allub.cpu().numpy(),
                             [m.cpu().numpy() for m in maxima], trace)
    for r, (vals, ids) in enumerate(got):
        cs.check(np.array_equal(vals.view(np.uint32),
                                want[2 * r].cpu().numpy().view(np.uint32))
                 and np.array_equal(ids, want[2 * r + 1].cpu().numpy()),
                 f"{tag}: rung_select_ref differs from _rung_topks")
    for r in range(3):
        t = [x for x in trace if x["rung"] == r]
        fin = [x["kept"] for x in t if x["finite"]]
        paths = {p: sum(x["path"] == p for x in t)
                 for p in ("sort", "list", "select")}
        print(f"[traffic] {tag} K6 rung {r + 1}: finite cut "
              f"{len(fin)}/{len(t)} queries; lanes under it: "
              f"{_quantiles(fin)}; paths {paths}")


def k5_traffic(tag, pools, q, ids, vals, filtw, want) -> None:
    """K5's page paths over a batch, from ops/wand_rescore.page_select_ref
    (its result must equal `want`): the matched docs a query (found), and
    the queries whose page needs no select (found <= 64), is sorted whole
    (<= SORTED) or selected from the list."""
    import numpy as np

    from seekstorm_tpu_torch.ops import wand_rescore as wr

    sc, ln, _ = wr._rescore_regions(*pools, *q, ids, vals, filtw)
    trace = []
    got = wr.page_select_ref(sc.cpu().numpy(), ln.cpu().numpy(), trace)
    for g, w in zip(got, want[:3]):
        w = w.cpu().numpy()
        cs.check(g.dtype == w.dtype and np.array_equal(
            g.view(np.uint32) if g.dtype == np.float32 else g,
            w.view(np.uint32) if w.dtype == np.float32 else w),
            f"{tag}: page_select_ref differs from _page_topk")
    found = np.array([x["found"] for x in trace])
    print(f"[traffic] {tag}: found {_quantiles(found)}; found <= 64: "
          f"{int((found <= 64).sum())}, <= {wr.SORTED}: "
          f"{int((found <= wr.SORTED).sum())}, selected: "
          f"{int((found > wr.SORTED).sum())}")


def compare_k56(torch, tree: Path, card) -> tuple:
    """The earlier tree's K5 and K6 against the current ones, in turns, at
    the serve batch's and facet2's shapes, on synthetic UBs at 77 blocks
    and in the fold mode at a 4-query dispatch; then the current K6
    against itself without its list tier.  Each must equal its plain
    version bit for bit.  Returns the rows and phase 4's index."""
    import bench
    import numpy as np
    import seekstorm_tpu_torch as st
    from seekstorm_tpu_torch.ops import wand_rescore as wr
    from seekstorm_tpu_torch.ops import wand_rungs as wg
    from seekstorm_tpu_torch.ops import wand_scan as ws

    current = ROOT / "seekstorm_tpu_torch" / "csrc"
    jobs = {("earlier", n): tree / "seekstorm_tpu_torch" / "csrc"
            for n in K56_NAMES}
    jobs.update({("current", n): current for n in K56_NAMES})
    jobs["no list", "wand_rungs"] = no_list_source(ROOT)
    libs = build_libs(jobs)
    idx = cs.phase_index(st)
    queries = bench.make_queries(cs.N_QUERIES, np.random.default_rng(100))
    batches = {"serve": (serve_requests(st, queries), False),
               "facet2": (cs.facet_requests(st, "facet2", cs.N_QUERIES),
                          True)}
    rows = []

    def turns(tag, make, want, bound, library_ms=None,
              trees=("earlier", "current")):
        """Both trees' launches held against `want` bit for bit, then
        timed in turns (a, b, b, a): as launches on tensors a launcher
        prepared, and through the wrapper's host work (a launcher made and
        called each time)."""
        a, b = trees
        launch = {}
        for t in trees:
            launch[t] = make(libs[t])
            got = [y for x in launch[t]()
                   for y in (x if isinstance(x, tuple) else (x,))]
            torch.cuda.synchronize()
            cs._same_bits(torch, got, want, f"{t} tree", tag)
        order = (a, b, b, a)
        ms = [cs._median_ms(torch, launch[t]) for t in order]
        wrap = [cs._median_ms(torch, lambda t=t: make(libs[t])())
                for t in order]
        bnd, by = bound
        row = dict(tag=tag, card=card, bound_ms=bnd, bound_by=by,
                   library_ms=library_ms)
        for t in trees:
            row[f"{t}_ms"] = [m for m, u in zip(ms, order) if u == t]
            row[f"{t}_wrapper_ms"] = [m for m, u in zip(wrap, order)
                                      if u == t]
        rows.append(row)
        print(f"[compare] {tag}: {a} and {b} bitwise equal to the plain "
              f"version; launches {a} {ms[0]:.4f} / {ms[3]:.4f} ms, {b} "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms "
              f"({100 * bnd / ((ms[1] + ms[2]) / 2):.1f}% of the bound "
              f"{bnd:.4f} ms, {by}); through the wrapper {a} "
              f"{wrap[0]:.4f} / {wrap[3]:.4f} ms, {b} {wrap[1]:.4f} / "
              f"{wrap[2]:.4f} ms"
              + ("" if library_ms is None else
                 f"; yardstick {library_ms:.4f} ms")
              + f" ({card})")

    def k6_rows(tag, x, mx, want, library=True):
        turns(tag, lambda lib: wg.rungs_launcher(x, mx, lib["wand_rungs"]),
              want, cs.k6_bound(*x.shape),
              library_ms=cs._median_ms(
                  torch, lambda: torch.topk(x, wg.KP, dim=1))
              if library else None)

    for name, (reqs, filt) in batches.items():
        inp = cs._ladder_inputs(torch, st, idx, reqs, with_filter=filt)
        allub, maxima = inp["allub"], inp["maxima"]
        Bq, L1 = allub.shape
        want6 = [x for r in wg._rung_topks(allub, 0, maxima) for x in r]
        k6_traffic(name, allub, maxima, want6)
        k6_rows(f"{name} K6 (Bq={Bq}, L1={L1})", allub, maxima, want6)
        turns(f"{name} K6 without its list tier", lambda lib: wg.rungs_launcher(
            allub, maxima, lib["wand_rungs"]), want6, cs.k6_bound(Bq, L1),
            trees=("no list", "current"))
        rungs = wg.wand_rungs_cuda(allub, maxima)
        vals1, ids1 = [x[:, :wg.K_SEL].contiguous() for x in rungs[0]]
        vals2, ids2 = rungs[1]
        idsb = (ids2[:, :wg.K_SEL, None] * 4 + torch.arange(
            4, dtype=torch.int32, device="cuda")).reshape(Bq, -1)
        valsb = torch.repeat_interleave(vals2[:, :wg.K_SEL], 4, dim=1)
        for rung, (ids, vals) in (("rung 1", (ids1, vals1)),
                                  ("rung 2", (idsb.contiguous(),
                                              valsb.contiguous()))):
            args = (*inp["pools"], *inp["q"], ids, vals, inp["filtw"])
            want5 = wr.rescore_page_ref(*args)
            k5_traffic(f"{name} K5 {rung}", inp["pools"], inp["q"], ids,
                       vals, inp["filtw"], want5)
            sc = wr._rescore_regions(*args)[0]
            turns(f"{name} K5 {rung} (K={ids.shape[1]})",
                  lambda lib, args=args: wr.page_launcher(
                      *args, lib=lib["wand_rescore"]),
                  want5, cs.k5_bound(torch, inp["pools"], inp["q"], ids,
                                     vals, inp["filtw"]),
                  library_ms=cs._median_ms(
                      torch, lambda sc=sc: torch.topk(sc, 64, dim=1)))
            del sc, want5
        if name == "serve":
            # the fold mode at one 4-query dispatch of the same pools
            q4 = [inp["q"][0]] + [x[:4] for x in inp["q"][1:4]] \
                + [inp["q"][4][:, :4]]
            nsplit = wr.split_count(
                inp["pools"][3].shape[1] * cs.NW, 4,
                torch.cuda.get_device_properties(0).multi_processor_count)
            want = wr.exact_scan_ref(*inp["pools"], *q4)
            turns(f"fold mode, 4 queries, nsplit={nsplit}",
                  lambda lib: wr.fold_launcher(
                      *inp["pools"], *q4, nsplit=nsplit,
                      lib=lib["wand_rescore"]),
                  want, cs.exact_scan_bound(inp["state"], inp["slots"],
                                            inp["specs"][:4]))
        del inp, rungs, allub, maxima
        torch.cuda.empty_cache()

    g = torch.Generator(device="cuda")
    # K6 where every rung-1 query keeps 129 to 512 lanes under its cut
    # (UBs of 11 levels, 60% unmatched): the list tier's own traffic
    g.manual_seed(11)
    x = cs._k6_ties(torch, g, cs.N_QUERIES, 16 * cs.NW, levels=11)
    mx = ws.rung_maxima(x)
    want6 = [y for r in wg._rung_topks(x, 0, mx) for y in r]
    k6_traffic("list tier", x, mx, want6)
    turns("synthetic K6, rung 1 in the list tier, without it",
          lambda lib: wg.rungs_launcher(x, mx, lib["wand_rungs"]), want6,
          cs.k6_bound(*x.shape), trees=("no list", "current"))
    # K6 at bench.py's 5M docs: 77 blocks, allub 1.29 GB at Bq=2,048
    g.manual_seed(77)
    x = cs._k6_ties(torch, g, cs.N_QUERIES, 77 * cs.NW, levels=1 << 22)
    mx = ws.rung_maxima(x)
    want6 = [y for r in wg._rung_topks(x, 0, mx) for y in r]
    k6_rows(f"synthetic K6 at 77 blocks (Bq={cs.N_QUERIES}, "
            f"L1={77 * cs.NW})", x, mx, want6)
    del x, mx, want6
    torch.cuda.empty_cache()
    return rows, idx


def serve_requests(st, queries):
    return [st.SearchRequest(query=q, length=10, realtime=True,
                             result_type=st.ResultType.TopkCount,
                             query_type_default=st.QueryType(t))
            for q, t in queries]


def profile_tree(torch, tree: Path) -> int:
    """One warm default-route batch of `tree`'s package, profiled."""
    import numpy as np

    import bench

    sys.path.insert(0, str(tree))
    import seekstorm_tpu_torch as st

    print(f"[profile] package {Path(st.__file__).parent}")
    idx = cs.phase_index(st, path=cs.WORK / "index_earlier")
    reqs = serve_requests(st, bench.make_queries(cs.N_QUERIES,
                                                 np.random.default_rng(100)))
    for _ in range(2):
        st.search_batch(idx, reqs, device="cuda")
    cs.device_kernels(torch, "profile earlier", lambda: st.search_batch(
        idx, reqs, device="cuda"), top=20)
    return 0


def profile_both(torch, tree: Path, idx=None):
    """The device's kernel time by name over one warm default-route
    TopkCount batch of each tree: the earlier tree's in a subprocess that
    imports its package (and loads the native library built here), then
    this tree's here, on `idx` (phase 4's index, built if None).  Returns
    this tree's index and requests."""
    import numpy as np

    import bench
    import seekstorm_tpu_torch as st

    env = dict(os.environ, SEEKSTORM_TPU_NATIVE_LIB=str(
        ROOT / "native" / "libseekstorm_native.so"))
    out = subprocess.run([sys.executable, __file__, "--profile", str(tree)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    print(out.stdout, end="")
    cs.check(out.returncode == 0, f"earlier tree's profile failed: "
                                  f"{out.stderr[-2000:]}")
    if idx is None:
        idx = cs.phase_index(st)
    reqs = serve_requests(st, bench.make_queries(cs.N_QUERIES,
                                                 np.random.default_rng(100)))
    for _ in range(2):
        st.search_batch(idx, reqs, device="cuda")
    cs.device_kernels(torch, "profile current", lambda: st.search_batch(
        idx, reqs, device="cuda"), top=20)
    return idx, reqs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_compare: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1] == "--profile":
        return profile_tree(torch, Path(sys.argv[2]).resolve())
    if sys.argv[1] == "--k4":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(card)
        rows = compare_k4(torch, Path(sys.argv[2]).resolve(), card)
        print(json.dumps({"k4_compare": rows}))
        return 0
    if sys.argv[1] == "--k56":
        sys.meta_path.insert(0, cs._NoJax())
        cs.WORK.mkdir(parents=True, exist_ok=True)
        tree = Path(sys.argv[2]).resolve()
        card = cs.phase_card(torch)
        rows, idx = compare_k56(torch, tree, card)
        profile_both(torch, tree, idx)
        print(json.dumps({"k56_compare": rows}))
        return 0
    if sys.argv[1] == "--k3":
        sys.meta_path.insert(0, cs._NoJax())
        cs.WORK.mkdir(parents=True, exist_ok=True)
        rows = compare_k3(torch, Path(sys.argv[2]).resolve(),
                          cs.phase_card(torch))
        print(json.dumps({"k3_compare": rows}))
        return 0
    tree = Path(sys.argv[1]).resolve()
    import numpy as np

    import seekstorm_tpu_torch as st
    from seekstorm_tpu_torch import _build
    from seekstorm_tpu_torch.ops import wand_scan as ws

    card = cs.phase_card(torch)
    _build.load("wand_scan")
    lib = build_old(tree / "seekstorm_tpu_torch" / "csrc" / "wand_scan.cu")
    rows = []
    rng = np.random.default_rng(1)
    for T in ws.T_TIERS:
        for with_filter in (False, True):
            args = cs._k1_inputs(torch, rng, T=T, with_filter=with_filter,
                                 **cs.K1_SHAPES)
            rows.append(compare(torch, lib, args,
                                f"T={T} filter={with_filter}", card))
            del args
            torch.cuda.empty_cache()

    idx, reqs = profile_both(torch, tree)
    rows.append(compare(torch, lib, st.wand_inputs(idx, reqs, "cuda"),
                        "serve batch", card))
    print(json.dumps({"k1_compare": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
