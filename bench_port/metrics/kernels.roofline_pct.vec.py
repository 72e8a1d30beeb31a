"""Share of the least time the window's vector work needs on the card, of
the profiler's summed kernel time.  A batch of B queries at nprobe needs
the i8 rows of min(B * nprobe, C) of the C clusters (C read once from the
index at set-up), the C centroid rows and the B query rows, read once, and
its pages written once; each query's scan is 2 * d operations a row of its
nprobe clusters.  Least time is the larger of bytes at 3.35 TB/s and
operations at 1,979 TOP/s (H100 SXM, dense int8)."""

NAME = "kernels.roofline_pct.vec"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (csrc/*.cu, the card)"
MOVES = "qps"

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def read(run):
    w = run.work
    if run.trace is None or "n_clusters" not in w or run.trace["kernel_s"] <= 0:
        return None
    r = run.cell["request"]
    B, nprobe, k = int(run.cell["batch"]), int(r["nprobe"]), int(r["length"])
    C, rows, d = w["n_clusters"], w["n_rows"], w["dim"]
    batches = w["queries"] / B
    per_batch = (min(B * nprobe, C) / C * rows * d + C * d + B * d
                 + 8 * B * k)
    ops = 2.0 * d * rows * min(nprobe, C) / C * w["queries"]
    least = max(batches * per_batch / HBM_BYTES_S, ops / INT8_OPS_S)
    return 100.0 * least / run.trace["kernel_s"]
