"""Runs of one cell in a row, each a process of its own, for measuring the
spread of its metrics and the readings its limits are set from:

    python3 bench_port/series.py --workload <cell> --seeds 11,12,13 \\
        --seconds 30 [--trace 0|1] [--repeat 2] [--out chiprun_out/bench]

Each run's last line and the end of its standard error are written to
``<out>/<cell>.<seed>.<trace>.<n>.json`` / ``.err``; the summary prints every
run's metrics and check numbers, and for each metric the spread (distance
between the quartiles of statistics.quantiles(n=4), over the median) of
each set of seeds (``--repeat`` runs the whole list again).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/bench")
    ap.add_argument("--timeout", type=float, default=1300)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for rep in range(args.repeat):
        rows = []
        for seed in seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                rc, so, se = p.returncode, p.stdout, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, so, se = 124, e.stdout or "", e.stderr or ""
                so = so.decode() if isinstance(so, bytes) else so
                se = se.decode() if isinstance(se, bytes) else se
            wall = time.perf_counter() - t0
            stem = f"{args.workload}.{seed}.{args.trace}.{rep}"
            (out / f"{stem}.err").write_text(se[-20000:])
            line = so.strip().splitlines()[-1] if so.strip() else ""
            (out / f"{stem}.json").write_text(line + "\n")
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = None
            rows.append((seed, rc, wall, res))
            m = {k: v["value"] for k, v in (res or {}).get(
                "metrics", {}).items()}
            chk = {k: v["value"] for k, v in (res or {}).get(
                "check", {}).items()}
            print(f"[run] {stem} rc {rc} wall {wall:.1f} s correct "
                  f"{(res or {}).get('correct')} metrics {m} check {chk} "
                  f"device {(res or {}).get('device')}", flush=True)
            if res is None:
                print(se[-3000:], flush=True)
        sets.append(rows)
    names = sorted({k for rows in sets for _, _, _, r in rows if r
                    for k in r["metrics"]})
    for name in names:
        for i, rows in enumerate(sets):
            vals = [r["metrics"][name]["value"] for _, _, _, r in rows
                    if r and name in r["metrics"]]
            s = spread(vals)
            print(f"[spread] {name} set {i}: median "
                  f"{statistics.median(vals) if vals else None} spread "
                  f"{s} values {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
