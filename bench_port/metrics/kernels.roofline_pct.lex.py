"""Share of the least time the window's lexical work needs on the card, of
the profiler's summed kernel time.  The work is counted from the workload
alone: every posting of each served query's distinct terms (committed plus
tail) read once as a 32-bit doc id and a 32-bit impact, one multiply-add a
posting, and each page entry (id and score) written once.  Least time is the
larger of bytes at 3.35 TB/s and operations at 67 TFLOP/s (H100 SXM, f32
outside the tensor cores)."""

NAME = "kernels.roofline_pct.lex"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (csrc/*.cu, the card)"
MOVES = "kernel_us_per_query"

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def read(run):
    w = run.work
    if run.trace is None or "postings" not in w or run.trace["kernel_s"] <= 0:
        return None
    n_bytes = 8 * w["postings"] + 8 * w["page_entries"]
    least = max(n_bytes / HBM_BYTES_S, 2 * w["postings"] / F32_OPS_S)
    return 100.0 * least / run.trace["kernel_s"]
