"""The closed loop: a fixed number of client threads in the benchmark's
process, each sending its next batch when the last one came back, for the
length of the window.

Every request started inside the window is timed from its send and its
answers are recorded for the check; a request that raised counts as
missing every limit (an infinite latency) and its queries as failed.  The
rate is all of that work over all of its time: the queries answered over the
seconds from the window's start to the last answer.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from gen import traffic


def closed_loop(search, requests: list, cell: dict, seed: int,
                seconds: float, recorder_factory, span) -> dict:
    clients = int(cell["clients"])
    n_pool = len(requests)
    barrier = threading.Barrier(clients + 1)
    window = {}
    out = [dict(lat=[], done=0, last=0.0, attempted=0, failed=0, errors=[],
                served=np.zeros(n_pool, np.int64), rec=recorder_factory())
           for _ in range(clients)]

    def client(c: int) -> None:
        mine = out[c]
        batches = traffic.client_batches(cell, seed, c)
        barrier.wait()
        t_end = window["end"]
        while time.perf_counter() < t_end:
            idx = next(batches)
            batch = [requests[i] for i in idx]
            t0 = time.perf_counter()
            try:
                with span("request"):
                    res = search(batch)
                if len(res) != len(batch):
                    raise RuntimeError(f"{len(res)} answers to "
                                       f"{len(batch)} requests")
            except Exception as e:       # a failed request, counted
                res = None
                mine["errors"].append(f"{type(e).__name__}: {e}")
            t1 = time.perf_counter()
            mine["attempted"] += len(idx)
            if res is None:
                mine["lat"].append(float("inf"))
                mine["failed"] += len(idx)
                continue
            mine["lat"].append(t1 - t0)
            np.add.at(mine["served"], idx, 1)
            mine["done"] += len(idx)
            mine["last"] = t1
            rec = mine["rec"]
            for i, rs in zip(idx.tolist(), res):
                if rec.wants(i):
                    rec.add(i, rs)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    window["end"] = t_start + seconds
    barrier.wait()
    for t in threads:
        t.join()
    rec = out[0]["rec"]
    for o in out[1:]:
        rec.merge(o["rec"])
    return dict(
        t_start=t_start, seconds=seconds,
        latencies=[x for o in out for x in o["lat"]],
        done=sum(o["done"] for o in out),
        elapsed_s=max((o["last"] for o in out), default=t_start) - t_start,
        attempted=sum(o["attempted"] for o in out),
        failed=sum(o["failed"] for o in out),
        errors=[e for o in out for e in o["errors"]],
        served=sum(o["served"] for o in out),
        recorder=rec)
