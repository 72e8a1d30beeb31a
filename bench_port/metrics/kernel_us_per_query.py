"""The card's kernel time per query answered: the summed durations of the
kernels in the window's device trace (copies and fills left out), over the
queries answered by the requests it counted (in an untraced run, those sent
once the device-only trace runs, ``harness/trace.py::DeviceTrace``).  The device time a
query costs, the card's share of the bill; where the host bounds the rate,
as in the lexical cells, it is the steady reading of the served work, and
the rate is read per layer (``entry.qps.lex``)."""

NAME = "kernel_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    t = run.device_trace
    done = t.get("queries", run.run["done"]) if t is not None else 0
    if t is None or t["kernel_s"] <= 0 or done <= 0:
        return None
    return 1e6 * t["kernel_s"] / done
