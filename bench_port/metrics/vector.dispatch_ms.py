"""Mean seconds of a committed vector scan (the program's ``vector_scan``
timer over ``vector_dispatch_total``: uploads, cluster selection, the tile
set, K4 and the fetch, which fences it), in ms."""

NAME = "vector.dispatch_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "vector search (vector_search.py, ops/vector.py host side)"
MOVES = "qps"


def read(run):
    n = run.delta("vector_dispatch_total")
    t = run.delta("vector_scan_seconds_total")
    if n <= 0 or t <= 0:
        return None
    return 1e3 * t / n
