"""Seconds of the program's ``search_parse`` timer (the body of
``search.py::_build_specs``: query parsing and the batch's term slots) a
query served, in us."""

NAME = "search.parse_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("search_parse_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
