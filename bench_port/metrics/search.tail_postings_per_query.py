"""(query, posting) pairs the realtime tail merge expands (the program's
``tail_postings_total``: the tail postings of each query's slots, scored
for the whole batch in one pass) a query served: the merge's work, where a
dense merge touched every tail doc (5,000 in the wiki1m cell) a query.
Nothing where the program keeps no such counter."""

NAME = "search.tail_postings_per_query"
UNIT = "pairs/query"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    if q <= 0 or "tail_postings_total" not in run.snap1:
        return None
    return run.delta("tail_postings_total") / q
