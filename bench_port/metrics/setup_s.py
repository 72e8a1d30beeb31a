"""Process start to the first timed request: opening the cached index,
ingesting the tail, uploading, loading the kernels and warming every query
of the pool.  A run that finds no cached index builds it in a process of
its own first; those seconds are left out and reported apart, as the
line's index_build_s."""

NAME = "setup_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
