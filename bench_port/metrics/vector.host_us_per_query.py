"""Host time of the vector search layer a query: the program's
``search_batch`` seconds over the queries served, less the profiler's
device kernel time a query (quantization, cluster selection glue, the
tail scan, merging, assembly)."""

NAME = "vector.host_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "vector search (vector_search.py, ops/vector.py host side)"
MOVES = "qps"


def read(run):
    q = run.delta("queries_total")
    if q <= 0 or run.trace is None or run.delta("k4_launches_total") <= 0:
        return None
    return 1e6 * (run.delta("search_batch_seconds_total")
                  - run.trace["kernel_s"]) / q
