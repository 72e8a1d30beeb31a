"""The per-layer metrics that read the program's own timers and counters
(parse, tail merge, tail entries, finalize; the vector scan, tail and
merge): a traced CPU dry run of each cell reports every one that
BENCHMARK.json lists for it, finite, beside the per-layer metrics it
reported before; an untraced run reports none of them."""

import math

import pytest

import run
from conftest import tiny
from harness import files

NEW = {
    "wiki1m.topkcount_b512": ["search.parse_us_per_query",
                              "search.tail_merge_us_per_query",
                              "search.tail_entries_per_query",
                              "search.finalize_us_per_query"],
    "sift1m.nprobe16_b64": ["vector.dispatch_ms", "vector.tail_us_per_query",
                            "vector.merge_us_per_query"],
}
BEFORE = {
    "wiki1m.topkcount_b512": ["entry.batch_p95_ms.lex", "entry.qps.lex",
                              "search.host_us_per_query",
                              "wand.dispatch_ms", "wand.fallbacks_per_kq"],
    "sift1m.nprobe16_b64": ["entry.batch_p95_ms"],
}


def _run(name, cache, trace):
    cell, config = tiny(name)
    return run.run_cell(cell, config, 2**31 + 91, 1.5, trace, device="cpu",
                        cache=cache)


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_run_reports_the_program_timers(name, cache):
    listed = files.per_layer_names(name, files.benchmark_json(),
                                   files.metric_modules(), [])
    assert set(NEW[name]) <= set(listed)
    out = _run(name, cache, trace=True)
    assert out["correct"] is True
    for metric in NEW[name]:
        v = out["metrics"][metric]["value"]
        assert math.isfinite(v) and v > 0, (metric, v)
    # beside those it reported before (the CPU has no device time, so the
    # roofline shares, the idle share and the vector remainder read
    # nothing here)
    assert set(BEFORE[name]) <= set(out["metrics"])


@pytest.mark.parametrize("name", sorted(NEW))
def test_an_untraced_run_reports_none_of_them(name, cache):
    out = _run(name, cache, trace=False)
    assert not set(NEW[name]) & set(out["metrics"])
