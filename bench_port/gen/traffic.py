"""The one traffic generator: it reads a cell's parameters (its file under
``bench_port/workloads/``) and a configuration's, and draws from ``--seed``
the query pool, the uncommitted tail and the order in which clients send the
pool's queries.  Every draw has its own generator, so one seed gives one
pool, one tail and one schedule whatever the window's length.
"""

from __future__ import annotations

import numpy as np

from . import corpus, vectors

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


def pool(cell: dict, config: dict, seed: int):
    """The cell's query pool: (query, type) pairs, or f32 vectors [n, d]."""
    rng = rng_for(seed, POOL)
    if config["kind"] == "text":
        return text_queries(int(cell["pool"]), rng, cell["mix"])
    centers = vectors.proxy_centers(config["dataset"], config["data_seed"])
    return vectors.rows_near(config["dataset"], centers, int(cell["pool"]),
                             rng)


def tail(cell: dict, config: dict, seed: int):
    """The uncommitted tail every run ingests anew: corpus.corpus_tokens
    arrays for text, f32 rows [n, d] for vectors."""
    rng = rng_for(seed, TAIL)
    if config["kind"] == "text":
        return corpus.corpus_tokens(int(cell["tail"]), int(config["vocab"]),
                                    rng)
    centers = vectors.proxy_centers(config["dataset"], config["data_seed"])
    return vectors.rows_near(config["dataset"], centers, int(cell["tail"]),
                             rng)


def client_batches(cell: dict, seed: int, client: int):
    """An endless sequence of batches of pool indices for one client, drawn
    with replacement: the same seed and client give the same sequence."""
    rng = rng_for(seed, CLIENT + client)
    n, b = int(cell["pool"]), int(cell["batch"])
    while True:
        yield rng.integers(0, n, size=b)


def check_sample(cell: dict, seed: int) -> np.ndarray:
    """The pool indices whose served answers the check compares, sorted."""
    n = int(cell["pool"])
    k = min(int(cell["check"]["sample"]), n)
    return np.sort(rng_for(seed, SAMPLE).choice(n, size=k, replace=False))
