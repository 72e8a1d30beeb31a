"""The one traffic generator: it reads a cell's parameters (its file under
``bench_port/workloads/``) and draws from ``--seed`` the order in which
clients send the pool's queries and the sample the check compares.  A
deployment kind (``bench_port/kinds/<kind>.py``) draws its query pool from
``pool_rng(cell, seed)`` and its uncommitted tail from ``rng_for(seed,
TAIL)``.  Every draw has its own generator, so one seed gives one pool, one
tail and one schedule whatever the window's length.

Two cell parameters fix the work a run does whatever its seed, where the
seed would otherwise change it: ``pool_seed`` draws the pool from that
number, so every seed serves the same queries, and ``"schedule": "epochs"``
sends each of them once an epoch (a permutation of the pool drawn from the
seed, batch after batch), so every seed serves them equally often, in its
own order.
"""

from __future__ import annotations

import numpy as np

POOL, TAIL, SAMPLE = 1, 2, 3
CLIENT = 100          # + client number: each client's schedule


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def text_queries(n: int, rng, mix: dict) -> list[tuple[str, str]]:
    """(query, type) pairs: a two-term Union below ``union2_below``, a
    two-term Intersection below ``intersection2_below``, else one term, the
    terms uniform over ranks [rank_lo, rank_hi).  With the root bench.py's
    mix (0.55, 0.85, 20, 3000) this is ``bench.make_queries``, draw for
    draw (the tests hold them equal): the repository's own synthetic mix,
    not the search-benchmark-game's query list."""
    lo, hi = int(mix["rank_lo"]), int(mix["rank_hi"])
    u, i = float(mix["union2_below"]), float(mix["intersection2_below"])
    out = []
    for _ in range(n):
        r = rng.random()
        t1 = f"w{rng.integers(lo, hi):05d}"
        t2 = f"w{rng.integers(lo, hi):05d}"
        if r < u:
            out.append((f"{t1} {t2}", "Union"))
        elif r < i:
            out.append((f"{t1} {t2}", "Intersection"))
        else:
            out.append((t1, "Union"))
    return out


def pool_rng(cell: dict, seed: int) -> np.random.Generator:
    """The pool's stream: the cell's ``pool_seed`` where it has one, else
    the run's seed."""
    return rng_for(int(cell.get("pool_seed", seed)), POOL)


def client_batches(cell: dict, seed: int, client: int):
    """An endless sequence of batches of pool indices for one client: drawn
    with replacement, or with ``"schedule": "epochs"`` cut from successive
    permutations of the pool.  The same seed and client give the same
    sequence."""
    rng = rng_for(seed, CLIENT + client)
    n, b = int(cell["pool"]), int(cell["batch"])
    schedule = cell.get("schedule", "replacement")
    if schedule not in ("replacement", "epochs"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "replacement":
        while True:
            yield rng.integers(0, n, size=b)
    queue = np.zeros(0, np.int64)
    while True:
        while len(queue) < b:
            queue = np.concatenate([queue, rng.permutation(n)])
        yield queue[:b]
        queue = queue[b:]


def check_sample(cell: dict, seed: int) -> np.ndarray:
    """The pool indices whose served answers the check compares, sorted."""
    n = int(cell["pool"])
    k = min(int(cell["check"]["sample"]), n)
    return np.sort(rng_for(seed, SAMPLE).choice(n, size=k, replace=False))
