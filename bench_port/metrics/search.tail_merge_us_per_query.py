"""Seconds of the program's ``tail_merge`` timer (the body of
``search.py::_merge_tail``: the realtime tail's postings, scoring and
selection for every query, once a shard with a tail) a query served, in
us."""

NAME = "search.tail_merge_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("tail_merge_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
