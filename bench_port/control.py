"""The upper readings of a cell's check: the plain reference put in the
program's place at the precision below the configuration's (bfloat16 BM25F
for the text cells, 4-bit scalar quantization for the vector cells), at the
cell's own size, judged as a run's answers are.  The benchmark's own runs
never run it.

    python3 bench_port/control.py --workload <cell> --seeds 21,22,23 \\
        [--seconds 5] [--device cuda]

Each seed runs a short window at the cell's load (the control answers the
same pool entries the window served) and prints the numbers compared with
the cell's limits.  A control that fails none of them is a check that
cannot tell a lower precision from the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run
from harness import files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.pin_host_threads()
    cell = files.load_cell(args.workload)
    config = files.load_config(cell["config"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run.run_cell(cell, config, seed, args.seconds, False,
                           device=args.device, control=True)
        nums = {k: v["value"] for k, v in out["check"].items()}
        print(f"[control] {args.workload} seed {seed} correct "
              f"{out['correct']} numbers {json.dumps(nums)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        failed_all &= not out["correct"]
    print(f"[control] every seed came out not correct: {failed_all}")
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
