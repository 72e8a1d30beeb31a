"""Queries answered by the requests started in the window, over the seconds
from the window's start to the last answer: all the work over all the
time."""

NAME = "qps"
UNIT = "queries/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    t = run.run["elapsed_s"]
    return run.run["done"] / t if t > 0 else None
