#!/usr/bin/env python3
"""Time an earlier commit's kernel K1, K3 or K4 against the current one on
one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 k1_compare.py build/parent
    python3 k1_compare.py --k3 build/parent
    python3 k1_compare.py --k4 build/parent/seekstorm_tpu_torch/csrc/vector_scan.cu

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

With --k4 an earlier K4 source (a csrc/vector_scan.cu with the current C
entry point, vector_scan_launch) and the current one run in the same turns
at chip_smoke.py's K4 serving shape (64 queries, 1,048,576 i8 rows, d=128,
Euclidean): all tiles at k=32, 1,024 selected tiles at k=32 and all tiles
at k=256; both must equal vector_scan_ref bitwise, and each line gives both
times beside chip_smoke.k4_bound.

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


def compare_k4(torch, src: Path, card) -> list:
    """An earlier K4 source and the current one at chip_smoke's K4 serving
    shape, in turns."""
    import numpy as np

    from seekstorm_tpu_torch import _build
    from seekstorm_tpu_torch.ops import vector as V
    from seekstorm_tpu_torch.ops import vector_scan as vs

    current = _build.load("vector_scan")
    out = _build.BUILD_DIR / "libvector_scan_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    earlier = ctypes.CDLL(str(out))
    earlier.vector_scan_launch.argtypes = \
        _build._SIGNATURES["vector_scan"]["vector_scan_launch"]
    earlier.vector_scan_launch.restype = ctypes.c_int

    def run(lib, args, kw):
        _build._LIBS["vector_scan"] = lib    # the wrapper loads it from here
        return vs.vector_scan_cuda(*args, **kw)

    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    n_tiles, d, B = (1 << 20) // 256, 128, 64
    pool = cs._k4_pool(torch, g, n_tiles, d, True, n_fields=1, p_del=0.01)
    qargs = cs._k4_queries(torch, g, B, d, True)
    field_ok = torch.ones(4, dtype=torch.bool, device="cuda")
    smin = torch.full((B,), float("-inf"), device="cuda")
    sel = np.sort(np.random.default_rng(10).choice(n_tiles, 1024,
                                                   replace=False))
    tid = torch.from_numpy(sel.astype(np.int32)).cuda()
    rows = []
    for name, tiles, k in (("all tiles, k=32", None, 32),
                           ("1,024 selected tiles, k=32", tid, 32),
                           ("all tiles, k=256", None, 256)):
        kw = dict(k=k, quantized=True, euclidean=True, with_counts=True,
                  exhaustive=tiles is None, use_field_filter=False)
        args = cs._k4_args(pool, tiles, field_ok, qargs, smin)
        want = V.vector_scan_ref(*args, **kw)
        for tag, lib in (("earlier", earlier), ("current", current)):
            got = run(lib, args, kw)
            torch.cuda.synchronize()
            cs._check_k4(torch, got, want, None, None, smin, k,
                         f"{tag} K4, {name}")
        turns = [cs._median_ms(torch, lambda lib=lib: run(lib, args, kw))
                 for lib in (earlier, current, current, earlier)]
        n_rows = (n_tiles if tiles is None else len(sel)) * 256
        bound, by = cs.k4_bound(n_rows, d, B, k, True,
                                pool["deleted"].shape[0],
                                use_field_filter=False)
        rows.append(dict(tag=name, earlier_ms=[turns[0], turns[3]],
                         current_ms=[turns[1], turns[2]], bound_ms=bound,
                         bound_by=by, card=card))
        print(f"[compare] K4 {name}: bitwise equal; earlier {turns[0]:.4f} "
              f"/ {turns[3]:.4f} ms, current {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms, bound {bound:.4f} ms ({by})")
        del want
    _build._LIBS["vector_scan"] = current
    return rows


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
    if sys.argv[1] == "--k3":
        sys.meta_path.insert(0, cs._NoJax())
        cs.WORK.mkdir(parents=True, exist_ok=True)
        rows = compare_k3(torch, Path(sys.argv[2]).resolve(),
                          cs.phase_card(torch))
        print(json.dumps({"k3_compare": rows}))
        return 0
    tree = Path(sys.argv[1]).resolve()
    import numpy as np

    import bench
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

    env = dict(os.environ, SEEKSTORM_TPU_NATIVE_LIB=str(
        ROOT / "native" / "libseekstorm_native.so"))
    out = subprocess.run([sys.executable, __file__, "--profile", str(tree)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    print(out.stdout, end="")
    cs.check(out.returncode == 0, f"earlier tree's profile failed: "
                                  f"{out.stderr[-2000:]}")

    idx = cs.phase_index(st)
    reqs = serve_requests(st, bench.make_queries(cs.N_QUERIES,
                                                 np.random.default_rng(100)))
    for _ in range(2):
        st.search_batch(idx, reqs, device="cuda")
    cs.device_kernels(torch, "profile current", lambda: st.search_batch(
        idx, reqs, device="cuda"), top=20)
    rows.append(compare(torch, lib, st.wand_inputs(idx, reqs, "cuda"),
                        "serve batch", card))
    print(json.dumps({"k1_compare": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
