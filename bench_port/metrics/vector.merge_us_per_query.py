"""Seconds of the program's ``vector_merge`` timer (dedup, rank and the
result objects in ``vector_search.py::vector_search_batch``) a query
served, in us."""

NAME = "vector.merge_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "vector search (vector_search.py, ops/vector.py host side)"
MOVES = "qps"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("vector_merge_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
