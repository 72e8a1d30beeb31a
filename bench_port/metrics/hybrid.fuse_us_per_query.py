"""Seconds of the program's ``hybrid_fuse`` timer (the reciprocal rank
fusion of each query's lexical and vector lists, its page and its result
set, in ``vector_search.py::hybrid_search_batch``) a query served, in us.
Nothing where the program keeps no such timer."""

NAME = "hybrid.fuse_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "hybrid fusion (vector_search.py::hybrid_search_batch: RRF)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("hybrid_fuse_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
