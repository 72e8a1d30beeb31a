"""Mean seconds of a lexical device dispatch (the program's ``lex_device``
timer, which ends in a fetch to the host, so it is fenced), in ms."""

NAME = "wand.dispatch_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "WAND dispatch (ops/wand.py: K1, K6, K5, glue, fetch)"
MOVES = "kernel_us_per_query"


def read(run):
    n = run.delta("device_dispatch_total")
    if n <= 0:
        return None
    return 1e3 * run.delta("lex_device_seconds_total") / n
