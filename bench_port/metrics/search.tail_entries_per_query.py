"""Entries the tail merge appends to the queries' candidate lists (the
program's ``tail_entries_total``) a query served: the work it hands on to
finalize."""

NAME = "search.tail_entries_per_query"
UNIT = "entries/query"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    if q <= 0 or run.delta("tail_merge_count") <= 0:
        return None
    return run.delta("tail_entries_total") / q
