"""Queries answered by the requests started in the traced window, over the
seconds from its start to the last answer: ``qps``'s reading, in the lexical
cells, where the host's speed spreads it too widely for an end-to-end
bound.  Read under the profiler, it is lower than an untraced run's (which
prints it on standard error as ``[window]``)."""

NAME = "entry.qps.lex"
UNIT = "queries/s"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "entry (search_batch: one request's batch)"
MOVES = "kernel_us_per_query"


def read(run):
    t = run.run["elapsed_s"]
    return run.run["done"] / t if t > 0 else None
