"""Mean over the window's queries of the share of the exact top-10 (float64
over the raw vectors, ties counted) found in the served page; the exact
top-10 comes from the benchmark's reference after the window."""

NAME = "recall_at_10"
UNIT = "ratio"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    return getattr(run.system, "recall", None)
