"""Seconds of the program's ``vector_tail`` timer (the realtime tail's
exact scan on the host in ``vector_search.py::vector_search_batch``) a
query served, in us."""

NAME = "vector.tail_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "vector search (vector_search.py, ops/vector.py host side)"
MOVES = "qps"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("vector_tail_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
