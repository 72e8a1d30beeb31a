"""``search.tail_postings_per_query``, the per-layer metric that reads the
program's ``tail_postings_total``: BENCHMARK.json lists it for the text
cell, a traced CPU dry run of that cell reports it finite and at least the
tail entries a query, an untraced run does not report it, and a program
without the counter gives it nothing."""

import math

import run
from conftest import tiny
from harness import files

CELL = "wiki1m.topkcount_b512"
METRIC = "search.tail_postings_per_query"


def _run(cache, trace):
    cell, config = tiny(CELL)
    return run.run_cell(cell, config, 2**31 + 97, 1.5, trace, device="cpu",
                        cache=cache)


def test_a_traced_run_reports_tail_postings(cache):
    listed = files.per_layer_names(CELL, files.benchmark_json(),
                                   files.metric_modules(), [])
    assert METRIC in listed
    out = _run(cache, trace=True)
    assert out["correct"] is True
    v = out["metrics"][METRIC]["value"]
    assert math.isfinite(v) and v > 0, v
    # every entry the merge appends is a matched (query, posting) pair
    assert v >= out["metrics"]["search.tail_entries_per_query"]["value"]


def test_an_untraced_run_does_not_report_tail_postings(cache):
    out = _run(cache, trace=False)
    assert METRIC not in out["metrics"]


def test_tail_postings_read_nothing_without_the_counter():
    """A program that merges the tail but keeps no tail_postings_total (the
    dense merge before it) reports no search.tail_postings_per_query."""
    read = files.metric_modules()[METRIC].read
    before = {"queries_total": 1024.0, "tail_merge_count": 2}
    after = {"queries_total": 1536.0, "tail_merge_count": 3}
    assert read(run.RunRecord(snap0=before, snap1=after)) is None
    assert read(run.RunRecord(
        snap0=dict(before, tail_postings_total=100.0),
        snap1=dict(after, tail_postings_total=30820.0))) == 60.0
