"""WAND stragglers (queries the device ladder hands on, the program's
``wand_fallbacks_total``) per 1,000 queries served."""

NAME = "wand.fallbacks_per_kq"
UNIT = "1/kquery"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "WAND routing (ops/wand.wand_auto)"
MOVES = "kernel_us_per_query"


def read(run):
    q = run.delta("queries_total")
    if q <= 0 or run.delta("device_dispatch_total") <= 0:
        return None
    return 1e3 * run.delta("wand_fallbacks_total") / q
