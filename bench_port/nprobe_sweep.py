"""The vector list of a hybrid cell alone, at several nprobe: its recall@10
against the exact top-10 distinct docs by best chunk, on the cell's pool,
so that the cell's nprobe can be the smallest that reaches the published
recall (as the source's nprobe 68 does at 16M vectors).

    python3 bench_port/nprobe_sweep.py --workload <cell> --seed <n> \\
        --nprobe 16,32,64 [--device cuda]

It opens the cell's cached index (building it first where there is none),
ingests the seed's tail, sends the pool's query strings as
``SearchMode.Vector`` requests of the cell's batch, length 10 and
``realtime``, and prints one JSON line an nprobe: recall@10 (ties not
counted), the milliseconds a batch took (host clock, after a warm batch)
and the clusters and rows a query observed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import run
from harness import files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--nprobe", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.pin_host_threads()
    import torch

    import seekstorm_tpu_torch as st

    cell = files.load_cell(args.workload)
    config = files.load_config(cell["config"])
    system = files.load_kind(config["kind"]).System(config, cell, args.seed)
    where, build_s = run.cached_index(config, args.device, files.CACHE)
    run.log(f"[sweep] index {where.name}, built in {build_s:.1f} s")
    idx = system.open(st, where, args.device)
    system.ingest_tail(idx)
    system.requests(st)
    realtime = bool(cell["request"].get("realtime", True))
    entries = range(len(system.pool))
    truth = system.vectors(args.device, "exact", realtime).top(
        system.query_vectors(entries), 10, args.device)
    truth = [set(d.tolist()) for d, _ in truth]
    B = int(cell["batch"])
    for nprobe in (int(n) for n in args.nprobe.split(",")):
        reqs = [st.SearchRequest(
            query=q, search_mode=st.SearchMode.Vector,
            result_type=st.ResultType.Topk, length=10, ann_mode="Nprobe",
            nprobe=nprobe, realtime=realtime) for q, _ in system.pool]
        st.search_batch(idx, reqs[:B], device=args.device)
        found, ms, cl, rows = 0, [], 0, 0
        for a in range(0, len(reqs), B):
            t0 = time.perf_counter()
            res = st.search_batch(idx, reqs[a:a + B], device=args.device)
            if args.device != "cpu":
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            for i, rs in enumerate(res, a):
                found += len(truth[i] & {r.doc_id for r in rs.results})
                cl += rs.observed_cluster_count
                rows += rs.observed_vector_count
        n = len(reqs)
        print(json.dumps({"nprobe": nprobe, "recall_at_10": found / (10 * n),
                          "batch_ms_median": float(np.median(ms)),
                          "clusters_a_query": cl / n, "rows_a_query": rows / n,
                          "queries": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
