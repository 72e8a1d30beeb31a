"""Seconds of the program's ``search_finalize`` timer (the body of
``search.py::_finalize_lexical``: dedup, order, phrase checks and the
result objects) a query served, in us."""

NAME = "search.finalize_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("search_finalize_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
