"""What a trace session of the port (``metrics.start_trace`` ...
``stop_trace``) costs a batch, on the card.

    python3 trace_cost.py [--cell wiki1m.topkcount_b512] [--batches 20]
                          [--block 5] [--seed N] [--out DIR] [--device cuda]

Opens the cell's committed index through the benchmark's cache
(``bench_port/cache/``, built on first use), ingests the tail its seed
draws and warms every query of the pool.  Then, in rounds, it runs blocks
of `--block` batches of the cell's size in three ways, their order turning
each round: without a trace, under a trace session of their own, and with
the program's spans kept but no profiler; `--batches` batches each way in
all.  The host's speed drifts over a run, so the three ways take turns.

Prints the median batch time of each way, the sessions' start and stop
times, the share of ``search_batch``'s seconds each METRICS timer took in
the untraced batches and the counters they moved, the spans a batch in
the written traces, the share of the card's kernels that lie inside a
``search_batch`` span (the spans and the device events on one clock), and
a check of the clock pairing: ``record_function`` markers read against
``time.time_ns()``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "bench_port"), str(ROOT)]
WAYS = ("without", "traced", "spans")


def clock_check(torch) -> list[tuple[float, float]]:
    """(marker start - time_ns before it, time_ns after - marker end), in
    us, for five markers after a warm one: both at or above 0 where the
    profiler stamps its events on time.time_ns()'s clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    with record_function("warm"):
        pass
    reads = []
    for i in range(5):
        a = time.time_ns()
        with record_function(f"mark{i}"):
            pass
        reads.append((a, time.time_ns()))
    prof.stop()
    ev = {e.name(): (e.start_ns(), e.duration_ns())
          for e in prof.profiler.kineto_results.events()}
    return [((ev[f"mark{i}"][0] - a) / 1e3,
             (b - sum(ev[f"mark{i}"])) / 1e3)
            for i, (a, b) in enumerate(reads)]


def read_traces(paths) -> dict:
    """Spans by name, search_batch spans, kernels and kernels inside a
    search_batch span, over the written traces."""
    out = dict(by_name={}, batches=0, kernels=0, inside=0)
    for path in paths:
        events = json.loads(path.read_text())["traceEvents"]
        spans = [e for e in events if e.get("cat") == "seekstorm"]
        outer = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                       if e["name"] == "search_batch")
        kernels = [e for e in events if e.get("cat") == "kernel"]
        for e in spans:
            out["by_name"][e["name"]] = out["by_name"].get(e["name"], 0) + 1
        out["batches"] += len(outer)
        out["kernels"] += len(kernels)
        out["inside"] += sum(any(a <= k["ts"] and k["ts"] + k["dur"] <= b
                                 for a, b in outer) for k in kernels)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="wiki1m.topkcount_b512")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--block", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2**31 + 1601)
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_cost"))
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script; its times mean nothing")
    args = ap.parse_args(argv)

    import run
    run.pin_host_threads()
    import torch

    import seekstorm_tpu_torch as st
    from harness import files
    from seekstorm_tpu_torch import metrics

    dev = args.device
    if dev != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: this measures the card", file=sys.stderr)
        return 2
    card = (f"{torch.cuda.get_device_name(0)}, {run.power_limit()}"
            if dev != "cpu" else "cpu")
    print(f"device {card}, torch {torch.__version__}")
    print("clock check (us: marker start after the time_ns before it, "
          "time_ns after it after the marker's end):",
          [(round(a, 3), round(b, 3)) for a, b in clock_check(torch)])

    cell = files.load_cell(args.cell)
    config = files.load_config(cell["config"])
    system = files.load_kind(config["kind"]).System(config, cell,
                                                     args.seed)
    where, _ = run.cached_index(config, dev, files.CACHE)
    idx = system.open(st, where, dev)
    system.ingest_tail(idx)
    reqs = system.requests(st)
    B = int(cell["batch"])
    n_pool = -(-len(reqs) // B)
    batches = [(reqs + reqs)[(i * B) % len(reqs):][:B]
               for i in range(max(n_pool, 3 * args.batches))]
    for b in batches[:n_pool]:
        st.search_batch(idx, b, device=dev)

    times = {w: [] for w in WAYS}
    t_start, t_stop, paths = [], [], []
    shares, total, counts = {}, 0.0, {}
    nxt = 0
    for r in range(-(-args.batches // args.block)):
        for way in WAYS[r % 3:] + WAYS[:r % 3]:
            out = Path(args.out) / f"{way}{r}"
            if way == "traced":
                t0 = time.perf_counter()
                if metrics.start_trace(str(out)) is not True:
                    raise RuntimeError("start_trace failed")
                t_start.append(time.perf_counter() - t0)
            elif way == "spans":
                # the spans alone, as a trace keeps them, no profiler
                st.METRICS._spans = []
            s0 = st.METRICS.snapshot()
            for b in batches[nxt:nxt + args.block]:
                t0 = time.perf_counter()
                st.search_batch(idx, b, device=dev)
                times[way].append(time.perf_counter() - t0)
            s1 = st.METRICS.snapshot()
            nxt += args.block
            if way == "traced":
                t0 = time.perf_counter()
                if metrics.stop_trace() is not True:
                    raise RuntimeError("stop_trace failed")
                t_stop.append(time.perf_counter() - t0)
                paths += list(out.glob("*.pt.trace.json"))
            elif way == "spans":
                st.METRICS._spans = None
            else:
                total += (s1["search_batch_seconds_total"]
                          - s0["search_batch_seconds_total"])
                for k, v in s1.items():
                    if (k.endswith("_seconds_total") and v > s0.get(k, 0.0)
                            and k != "search_batch_seconds_total"):
                        name = k[:-len("_seconds_total")]
                        shares[name] = (shares.get(name, 0.0) + v
                                        - s0.get(k, 0.0))
                    elif k.endswith("_total") and not k.endswith(
                            "_seconds_total"):
                        counts[k] = counts.get(k, 0.0) + v - s0.get(k, 0.0)

    med = {w: statistics.median(v) * 1e3 for w, v in times.items()}
    tr = read_traces(paths)
    n = len(times["traced"])
    print(f"cell {args.cell}, {n} batches of {B} each way in blocks of "
          f"{args.block}, seed {args.seed}; median batch ms: without "
          f"{med['without']:.3f}, traced {med['traced']:.3f}, spans alone "
          f"{med['spans']:.3f}; over without: traced "
          f"{med['traced'] / med['without']:.4f}, spans alone "
          f"{med['spans'] / med['without']:.4f}")
    print(f"start_trace ms {[round(x * 1e3, 1) for x in t_start]}, "
          f"stop_trace (stop, export, spans written) ms "
          f"{[round(x * 1e3, 1) for x in t_stop]}, trace files MB "
          f"{[round(p.stat().st_size / 1e6, 2) for p in paths]}")
    n_spans = sum(tr["by_name"].values())
    print(f"spans {n_spans} ({n_spans / n:.2f} a batch), by name "
          f"{tr['by_name']}; search_batch spans {tr['batches']}")
    print(f"kernels {tr['kernels']}, inside a search_batch span "
          f"{tr['inside']} "
          f"({100.0 * tr['inside'] / max(tr['kernels'], 1):.2f}%)")
    print(f"% of search_batch ({total:.3f} s) by timer, untraced batches:",
          {k: round(100 * v / total, 2) for k, v in shares.items()})
    print("counters over the untraced batches:",
          {k: v for k, v in counts.items() if v})
    for w in WAYS:
        print(f"batch ms {w}:", [round(x * 1e3, 2) for x in times[w]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
