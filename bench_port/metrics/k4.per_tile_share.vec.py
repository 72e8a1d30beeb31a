"""Share of the window's K4 calls (the program's ``k4_launches_total``)
that took K4's per-tile scan (``k4_per_tile_total``), not the running scan:
how often a vector list's page is too deep for the running lists.  Nothing
where the program keeps no such counter or made no K4 call."""

NAME = "k4.per_tile_share.vec"
UNIT = "ratio"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "kernels (csrc/*.cu, the card)"
MOVES = "qps"


def read(run):
    calls = run.delta("k4_launches_total")
    if "k4_per_tile_total" not in run.snap1 or calls <= 0:
        return None
    return run.delta("k4_per_tile_total") / calls
