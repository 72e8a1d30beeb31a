"""``k4.per_tile_share`` and ``k4.per_tile_share.vec``, the per-layer
metrics that read the program's ``k4_per_tile_total`` over its
``k4_launches_total``: BENCHMARK.json lists the first for the hybrid cell
and the second for the vector cell (each moves the end-to-end metric its
cell reports), and a program without the counter gives them nothing."""

import pytest

import run
from harness import files

METRICS = {"k4.per_tile_share": "wikihybrid1m.rrf_b128",
           "k4.per_tile_share.vec": "sift1m.nprobe16_b64"}


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_the_k4_cells_list_the_route_share(metric):
    mods = files.metric_modules()
    for cell in (METRICS[metric], *(c for c in METRICS.values()
                                    if c != METRICS[metric])):
        listed = files.per_layer_names(cell, files.benchmark_json(), mods,
                                       [])
        assert (metric in listed) == (cell == METRICS[metric]), cell


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_the_route_share_reads_the_counters(metric):
    read = files.metric_modules()[metric].read
    before = {"k4_launches_total": 10.0}
    after = {"k4_launches_total": 14.0}
    # the parent: K4 launches, no per-tile counter
    assert read(run.RunRecord(snap0=before, snap1=after)) is None
    # no K4 call in the window
    assert read(run.RunRecord(
        snap0=dict(before, k4_per_tile_total=0.0),
        snap1=dict(before, k4_per_tile_total=0.0))) is None
    # every call on the running scan, every call on the per-tile scan
    assert read(run.RunRecord(
        snap0=dict(before, k4_per_tile_total=0.0),
        snap1=dict(after, k4_per_tile_total=0.0))) == 0.0
    assert read(run.RunRecord(
        snap0=dict(before, k4_per_tile_total=3.0),
        snap1=dict(after, k4_per_tile_total=7.0))) == 1.0
