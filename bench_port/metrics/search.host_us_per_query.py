"""Host time of the lexical search layer a query: the program's
``search_batch`` seconds less its ``lex_device`` (dispatch to fetch) and
``lex_plan`` seconds, over the queries the window served (parse, tail
merge, assembly, routing)."""

NAME = "search.host_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "search (search.py: parse, tail merge, finalize)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    dev = run.delta("lex_device_seconds_total")
    if q <= 0 or dev <= 0:
        return None
    host = (run.delta("search_batch_seconds_total") - dev
            - run.delta("lex_plan_seconds_total"))
    return 1e6 * host / q
