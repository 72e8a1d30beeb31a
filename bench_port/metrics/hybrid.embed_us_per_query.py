"""Seconds of the program's ``vector_embed`` timer (the Model2Vec encode of
the batch's query strings in ``vector_search.py::vector_search_batch``, a
request that carries no query vector) a query served, in us: host work on
the served path of a hybrid batch.  Nothing where the program keeps no such
timer."""

NAME = "hybrid.embed_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Model2Vec inference (inference.py: the query's encode)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    t = run.delta("vector_embed_seconds_total")
    if q <= 0 or t <= 0:
        return None
    return 1e6 * t / q
