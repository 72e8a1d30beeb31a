"""Share of the least time the window's hybrid work needs on the card, of
the profiler's summed kernel time: the least time of its lexical work plus
the least time of its vector work.  Lexical, as ``kernels.roofline_pct.lex``
counts it: every posting of each served query's distinct terms (committed
plus tail) read once as a 32-bit doc id and a 32-bit impact, one
multiply-add a posting, and each entry of the lexical list written once,
bounded by 3.35 TB/s and 67 TFLOP/s (f32 outside the tensor cores).
Vector, as ``kernels.roofline_pct.vec`` counts it: a batch of B queries at
nprobe reads the d-byte i8 rows of min(B * nprobe, C) of the C clusters,
the C centroid rows and the B query rows once, and writes its lists of
max(length, 20) entries (8 bytes each) once; each query's scan is 2 * d
operations a row of its nprobe clusters, at 1,979 TOP/s (dense int8).  d is
the configuration's width, not the program's padded one."""

NAME = "kernels.roofline_pct.hyb"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (csrc/*.cu, the card)"
MOVES = "kernel_us_per_query"

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12


def read(run):
    w = run.work
    if (run.trace is None or "lex_postings" not in w
            or "vec_clusters" not in w or run.trace["kernel_s"] <= 0):
        return None
    lex_bytes = 8 * w["lex_postings"] + 8 * w["lex_page_entries"]
    lex = max(lex_bytes / HBM_BYTES_S, 2 * w["lex_postings"] / F32_OPS_S)
    r = run.cell["request"]
    B, nprobe = int(run.cell["batch"]), int(r["nprobe"])
    k = max(int(r.get("offset", 0)) + int(r["length"]), 20)
    C, rows, d = w["vec_clusters"], w["vec_rows"], w["dim"]
    per_batch = (min(B * nprobe, C) / C * rows * d + C * d + B * d
                 + 8 * B * k)
    ops = 2.0 * d * rows * min(nprobe, C) / C * w["queries"]
    vec = max(w["queries"] / B * per_batch / HBM_BYTES_S, ops / INT8_OPS_S)
    return 100.0 * (lex + vec) / run.trace["kernel_s"]
