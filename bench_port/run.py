"""The benchmark of seekstorm_tpu_torch, the PyTorch and CUDA port.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cell's cards.  It opens
the cell's committed index (built once per checkout under bench_port/cache/
from the configuration's own data seed), ingests the tail that --seed draws,
warms every query of the pool, and then drives the port for --seconds.  The
last line of standard output is one JSON object: correct, attempted, failed,
metrics, device (and, with --trace 1, breakdown), index_build_s (the
seconds a run that found no cached index spent building it, left out of
setup_s; 0 otherwise), and last the numbers the check compared with their
limits, which also end standard error.

--trace 0 reports the cell's end-to-end metrics (with torch.profiler
recording the card alone where one of them reads the device trace); --trace
1 runs the window under torch.profiler with host spans and reports the
per-layer metrics that BENCHMARK.json lists for the cell.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse          # noqa: E402
import contextlib        # noqa: E402
import gc                # noqa: E402
import hashlib           # noqa: E402
import json              # noqa: E402
import os                # noqa: E402
import shutil            # noqa: E402
import subprocess        # noqa: E402
import sys               # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import files                 # noqa: E402

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "seekstorm_tpu")
# one thread each for the native math libraries: two client threads (or the
# server's request threads) each running an 8-way BLAS call on the 8 cores of
# a one-card machine oversubscribe it, and the runs spread far wider
HOST_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# the port's sources: a change to any of them builds the index anew
PORT_SOURCES = ("seekstorm_tpu_torch/**/*.py", "seekstorm_tpu_torch/csrc/*",
                "native/*.cpp", "native/*.h", "native/Makefile")


def pin_host_threads() -> None:
    """Before numpy and torch load: one thread a native math library."""
    for var in HOST_THREADS:
        os.environ[var] = "1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``seekstorm_tpu_torch`` is not ``seekstorm_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def io_counts() -> str:
    """This process's write counters (wchar: bytes handed to write();
    write_bytes: bytes sent to storage), as /proc/self/io gives them."""
    try:
        with open("/proc/self/io") as f:
            got = dict(line.split(":") for line in f if ":" in line)
    except OSError:
        return "unknown"
    return ", ".join(f"{k} {got[k].strip()}" for k in ("wchar", "write_bytes")
                     if k in got)


def cache_key(config: dict) -> str:
    """Hash of the configuration, the generators, the index build (its
    kind's file), the plain references (the build saves what they read) and
    the port's sources: a tree never opens an index another tree built."""
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    paths = set()
    for pat in PORT_SOURCES + ("bench_port/gen/*.py",
                               f"bench_port/kinds/{config['kind']}.py",
                               "bench_port/reference/*.py"):
        paths.update(p for p in ROOT.glob(pat) if p.is_file()
                     and "__pycache__" not in p.parts)
    for p in sorted(paths):
        h.update(str(p.relative_to(ROOT)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def snapshot(path: Path) -> dict:
    return {str(p.relative_to(path)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


def cached_index(config: dict, device: str, cache: Path):
    """The cache directory of the committed index and the seconds this run
    spent building it (0.0 where it was found).  The build runs in a
    process of its own, so that the run's window finds the same process
    state whether it built or not; its seconds are left out of setup_s and
    reported apart."""
    where = cache / f"{config['name']}-{cache_key(config)}"
    if (where / "ready").is_file():
        return where, 0.0
    for old in cache.glob(f"{config['name']}-*"):
        shutil.rmtree(old, ignore_errors=True)
    where.mkdir(parents=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--build", json.dumps(config), "--device", device,
                    "--cache-dir", str(where)], check=True)
    return where, time.perf_counter() - t0


def build(config: dict, device: str, where: Path) -> int:
    """The build process: the committed index into `where`; fails, and
    leaves the cache unready, where it loaded JAX or the JAX package."""
    import seekstorm_tpu_torch as st

    t0 = time.perf_counter()
    files.load_kind(config["kind"]).System(config, None, 0).build(
        st, where, device)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded by the build: {', '.join(bad)}")
        return 3
    (where / "ready").write_text(
        f"built in {time.perf_counter() - t0:.1f} s\n")
    log(f"[io] the build process wrote: {io_counts()} (/proc/self/io)")
    return 0


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi failed"


def run_cell(cell: dict, config: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", cache: Path = files.CACHE,
             start_age: float = 0.0, t_import: float = T_IMPORT,
             fault=None, control: bool = False) -> dict:
    """One run of a cell; returns the result object (and its check).

    `fault`, if given, wraps the search call (the tests break the timed
    path with it); `control` judges the reference at the lower precision
    in the program's place instead of the served answers."""
    import torch

    import seekstorm_tpu_torch as st
    from harness.loop import closed_loop
    from harness.trace import DeviceTrace, Trace

    system = files.load_kind(config["kind"]).System(config, cell, seed)
    where, build_s = cached_index(config, device, cache)
    log(f"[setup] cache {where.name}: " + (
        f"built in {build_s:.1f} s, reported apart as index_build_s and "
        f"left out of setup_s" if build_s else "found"))
    before = snapshot(where / "index")
    idx = system.open(st, where, device)
    n_tail = system.ingest_tail(idx)
    reqs = system.requests(st)
    batch = int(cell["batch"])

    def search(rs):
        return st.search_batch(idx, rs, device=device)
    if fault is not None:
        search = fault(search)
    # an untraced run of a cell with an end-to-end metric read from the
    # device trace records the card alone, from the window's first request
    # on (the control's runs report no metric that counts)
    mods = files.metric_modules()
    dtr = (DeviceTrace(torch) if not (trace or control) and any(
        mods[n].SOURCE == "device_trace" for n in cell["end_to_end"])
        else None)
    if dtr is not None:
        search = dtr.counting(search)

    # warm every query of the pool, in batches of the cell's size
    t_w = time.perf_counter()
    n_warm = max(2, -(-len(reqs) // batch))
    for w in range(n_warm):
        a = (w * batch) % len(reqs)
        st.search_batch(idx, (reqs + reqs)[a:a + batch], device=device)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    extra = system.readings(idx, device)
    log(f"[setup] tail {n_tail}, pool {len(reqs)}, warm-up {n_warm} batches "
        f"in {time.perf_counter() - t_w:.1f} s")

    snap0 = st.METRICS.snapshot()
    tr = Trace(torch, st.METRICS) if trace else None
    if tr is not None:
        tr.start()
    run = closed_loop(search, reqs, cell, seed, seconds, system.recorder,
                      tr.span if tr is not None
                      else lambda name: contextlib.nullcontext())
    if tr is not None:
        tr.stop()
    if dtr is not None:
        dtr.stop()
    snap1 = st.METRICS.snapshot()
    log(f"[window] {run['done']} queries answered in {run['elapsed_s']:.3f}"
        f" s: {run['done'] / max(run['elapsed_s'], 1e-9):.1f} queries/s" + (
            f"; the device trace counted {dtr.queries}, from "
            f"{dtr.t0 - run['t_start']:.1f} s on" if dtr is not None
            and dtr.marked else ""))
    setup_s = start_age + (run["t_start"] - t_import) - build_s
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in range(int(cell["chips"])))
            if device != "cpu" else 0)
    trace_sum = tr.summary() if tr is not None else None
    device_sum = dtr.summary() if dtr is not None else trace_sum
    del idx, search, tr, dtr
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    for e in run["errors"][:5]:
        log(f"[window] request failed: {e}")

    t_c = time.perf_counter()
    numbers, check = system.judge(run["recorder"], device, control=control)
    after = snapshot(where / "index")
    check["cache_changed"] = {"value": int(after != before), "limit": 0}
    check["failed"] = {"value": run["failed"], "limit": 0}
    log(f"[check] reference and comparison in "
        f"{time.perf_counter() - t_c:.1f} s over {numbers['checked']} "
        f"answers")

    rec = RunRecord(cell=cell, config=config, seconds=seconds,
                    setup_s=setup_s, run=run, snap0=snap0, snap1=snap1,
                    trace=trace_sum, device_trace=device_sum,
                    system=system, extra=extra)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if device != "cpu":
        dev["power_limit"] = power_limit()
    return _result(rec, cell, trace, trace_sum, numbers, check, dev, run,
                   build_s)


def _result(record, cell, trace, trace_sum, numbers, check, dev, run,
            build_s):
    mods = files.metric_modules()
    names = (files.per_layer_names(cell["name"], files.benchmark_json(),
                                   mods, cell["end_to_end"])
             if trace else cell["end_to_end"])
    metrics = {}
    for name in names:
        v = mods[name].read(record)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": mods[name].UNIT}
    if trace_sum is not None:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["window_s"]
    out = {"correct": all(v["value"] <= v["limit"] for v in check.values())
           and numbers["checked"] > 0,
           "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": dev}
    if trace_sum is not None:
        out["breakdown"] = {k: [[n, s] for n, s in trace_sum[k]]
                            for k in ("device_ops", "idle_gaps")}
    # the building run's extra set-up, apart from setup_s (0.0 where the
    # cache was found)
    out["index_build_s"] = build_s
    out["check"] = check
    return out


class RunRecord:
    """What a metric's ``read`` sees: the cell and configuration, the
    window's requests (``run``), the program's METRICS before and after the
    window, the trace summary (``trace``: traced runs), the device trace's
    summary (``device_trace``: traced runs, and untraced runs of a cell
    with an end-to-end metric read from it), the served work."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def delta(self, name: str) -> float:
        return float(self.snap1.get(name, 0.0) - self.snap0.get(name, 0.0))

    @property
    def work(self) -> dict:
        if not hasattr(self, "_work"):
            self._work = self.system.work(self.run["served"])
            self._work.update(self.extra)
        return self._work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the cache's build, in a process of its own (cached_index)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--device", help=argparse.SUPPRESS)
    ap.add_argument("--cache-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    pin_host_threads()
    if args.build:
        return build(json.loads(args.build), args.device,
                     Path(args.cache_dir))
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    start_age = process_age()
    cell = files.load_cell(args.workload)
    config = files.load_config(cell["config"])

    # every cache of the program and of torch inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(files.CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
            f"{cell['chips']}")
        return 2
    out = run_cell(cell, config, args.seed, args.seconds, bool(args.trace),
                   start_age=start_age)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    log(f"[io] this process wrote: {io_counts()} (/proc/self/io; the "
        f"index build, where this run made it, ran in a child)")
    for name, v in out["check"].items():
        log(f"[check] {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
