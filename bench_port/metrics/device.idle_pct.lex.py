"""Share of the traced window in which no operation ran on the card
(torch.profiler's device events, merged): the lexical cells' reading, as
``device.idle_pct.batch`` is the vector cell's."""

NAME = "device.idle_pct.lex"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (the card)"
MOVES = "kernel_us_per_query"


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
