"""Chunk rows the vector merge took in (the program's
``vector_candidates_total``) over the distinct docs they held
(``vector_docs_total``): how many rows a doc's best chunk costs the scan's
lists, where documents have several vectors.  1 where every doc has one
row; nothing where the program keeps no such counters."""

NAME = "hybrid.rows_per_doc"
UNIT = "rows/doc"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "vector search (vector_search.py, ops/vector.py host side)"
MOVES = "kernel_us_per_query"


def read(run):
    docs = run.delta("vector_docs_total")
    if docs <= 0:
        return None
    return run.delta("vector_candidates_total") / docs
