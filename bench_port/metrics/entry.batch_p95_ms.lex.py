"""95th percentile (nearest rank) of the latency of every request started
in the traced window, from its send; a failed request counts as infinite.
A closed loop keeps its clients busy, so it measures the port at capacity:
there the tail of one batch's latency is a reading of the entry layer, not
an end-to-end metric.  Read under the profiler, it is longer than an
untraced run's.  The lexical cells' reading: their end-to-end metric is
``kernel_us_per_query``, the vector cell's ``entry.batch_p95_ms`` moves
``qps``."""

import math

NAME = "entry.batch_p95_ms.lex"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "entry (search_batch: one request's batch)"
MOVES = "kernel_us_per_query"


def read(run):
    lat = sorted(run.run["latencies"])
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
