"""The lexical cells' end-to-end metric read from the card's trace
(``kernel_us_per_query``), their rate read per layer (``entry.qps.lex``), and
BENCHMARK.json held to its own links: each metric's cells report what it
moves, and each metric file says what its entry says."""

import pytest
import torch

import run
from conftest import tiny
from harness import files
from harness.trace import DeviceTrace, after_mark, summarize

LEX = ["wiki1m.topkcount_b512", "wiki1m.topkcount_b512_committed"]
FIELDS = {"unit": "UNIT", "better": "BETTER", "source": "SOURCE"}


def _e2e_of_cells():
    return {p.stem: files.load_cell(p.stem)["end_to_end"]
            for p in (files.HERE / "workloads").glob("*.json")}


def test_each_per_layer_metric_moves_what_its_cells_report():
    bench, cells = files.benchmark_json(), _e2e_of_cells()
    for m in bench["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert m["moves"] in cells[w], (m["name"], w)


def test_each_end_to_end_metric_lists_the_cells_that_report_it():
    bench, cells = files.benchmark_json(), _e2e_of_cells()
    for m in bench["end_to_end"]:
        having = sorted(c for c, e2e in cells.items() if m["name"] in e2e)
        assert sorted(m.get("workloads", having)) == having, m["name"]
    names = {m["name"] for m in bench["end_to_end"]}
    for c, e2e in cells.items():
        assert set(e2e) <= names and "setup_s" in e2e and len(e2e) >= 2, c


def test_each_metric_file_says_what_its_entry_says():
    bench, mods = files.benchmark_json(), files.metric_modules()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            mod = mods[m["name"]]
            for key, attr in FIELDS.items():
                assert getattr(mod, attr) == m[key], (m["name"], key)
            if kind == "per_layer":
                assert (mod.MOVES, mod.LAYER) == (m["moves"], m["layer"])
            else:
                assert not hasattr(mod, "LAYER"), m["name"]


def test_the_lexical_cells_report_the_rate_per_layer_only():
    bench = files.benchmark_json()
    qps = next(m for m in bench["end_to_end"] if m["name"] == "qps")
    assert not set(LEX) & set(qps["workloads"])
    rate = next(m for m in bench["per_layer"] if m["name"] == "entry.qps.lex")
    assert rate["workloads"] == LEX


def _record(kernel_s, done, elapsed=2.0):
    return run.RunRecord(
        device_trace=None if kernel_s is None else {"kernel_s": kernel_s},
        run={"done": done, "elapsed_s": elapsed})


@pytest.mark.parametrize("kernel_s,done,want", [
    (0.25, 500_000, 0.5), (1e-3, 10, 100.0), (None, 100, None),
    (0.0, 100, None), (0.5, 0, None)])
def test_kernel_time_per_query(kernel_s, done, want):
    got = files.metric_modules()["kernel_us_per_query"].read(
        _record(kernel_s, done))
    assert got == (None if want is None else pytest.approx(want))


def test_kernel_time_leaves_copies_and_fills_out():
    dev = [(0.0, 1000.0, "k1"), (500.0, 700.0, "Memcpy DtoH"),
           (2000.0, 2500.0, "k2"), (3000.0, 3100.0, "Memset")]
    out = summarize(dev, [], 0.0, 0.01)
    assert out["kernel_s"] == pytest.approx(1.5e-3)
    assert out["busy_s"] == pytest.approx(1.6e-3)


def test_the_window_starts_at_the_last_marker():
    dev = [(0.0, 50.0, "upload"), (60.0, 61.0, "spin_kernel(long)"),
           (70.0, 90.0, "warm k1"), (100.0, 101.0, "spin_kernel(long)"),
           (101.0, 130.0, "k1"), (140.0, 150.0, "Memcpy DtoH")]
    ops, lo = after_mark(dev, DeviceTrace.MARK)
    assert lo == 101.0
    assert ops == [(101.0, 130.0, "k1"), (140.0, 150.0, "Memcpy DtoH")]
    assert summarize(ops, [], lo, 1e-4)["kernel_s"] == pytest.approx(29e-6)
    # no marker: everything, from the first start
    assert after_mark(dev[:1], DeviceTrace.MARK) == (dev[:1], 0.0)


def test_a_device_trace_without_a_card_records_nothing():
    if torch.cuda.is_available():
        pytest.skip("the card records: the untraced runs on the card read it")
    tr = DeviceTrace(torch)
    search = tr.counting(lambda rs: [None] * len(rs))
    for _ in range(3):
        search([1, 2])
    tr.stop()
    assert tr.summary() is None and tr.queries == 0


class _Event:
    def __init__(self, start_us, dur_us, name, dev="CUDA"):
        self.s, self.d, self.n, self.dev = start_us, dur_us, name, dev

    def start_us(self):
        return self.s

    def duration_us(self):
        return self.d

    def name(self):
        return self.n

    def device_type(self):
        return f"DeviceType.{self.dev}"


class _Card:
    """A stand-in for torch with a card: the profiler records the launches
    (a kernel of 10 us a query, the marker 1 us) on one clock."""

    def __init__(self):
        self.events, self.clock = [], 0.0
        card = self

        class _Prof:
            def __init__(self, activities):
                self.profiler = self

            def start(self):
                pass

            def stop(self):
                pass

            @property
            def kineto_results(self):
                return self

            def events(self):
                return card.events
        self.profiler = type("P", (), {
            "profile": _Prof,
            "ProfilerActivity": type("A", (), {"CUDA": "cuda"})})
        self.cuda = type("C", (), {
            "is_available": staticmethod(lambda: True),
            "synchronize": staticmethod(lambda: None),
            "_sleep": staticmethod(lambda n: card.launch(1.0, "spin_kernel"))})

    def launch(self, us, name):
        self.events.append(_Event(self.clock, us, name))
        self.clock += us + 5.0


def test_the_device_trace_counts_the_requests_after_its_marker():
    card = _Card()
    tr = DeviceTrace(card)

    def search(rs):
        card.launch(10.0 * len(rs), "k1")
        card.launch(3.0, "Memcpy DtoH")
        return [None] * len(rs)
    search([0] * 4)                  # set-up's work, before the window
    counted = tr.counting(search)
    for n in (8, 16, 32):            # the first starts and marks
        counted([0] * n)
    tr.stop()
    out = tr.summary()
    assert tr.marked and out["queries"] == 56
    assert out["kernel_s"] == pytest.approx(10e-6 * 56)
    assert out["busy_s"] == pytest.approx((10.0 * 56 + 3 * 3.0) * 1e-6)
    rec = run.RunRecord(device_trace=out, run={"done": 60, "elapsed_s": 1})
    got = files.metric_modules()["kernel_us_per_query"].read(rec)
    assert got == pytest.approx(10.0)


def _spy(monkeypatch, name):
    import harness.trace
    made = []
    base = getattr(harness.trace, name)

    class Spy(base):
        def __init__(self, *a, **kw):
            made.append(name)
            super().__init__(*a, **kw)
    monkeypatch.setattr(harness.trace, name, Spy)
    return made


@pytest.mark.parametrize("name", LEX)
def test_an_untraced_lexical_run_reads_the_device_trace(name, cache,
                                                        monkeypatch):
    """The untraced run starts the device-only trace and no host trace (the
    CPU gives it nothing to read, so only setup_s is reported)."""
    made = [_spy(monkeypatch, cls) for cls in ("DeviceTrace", "Trace")]
    cell, config = tiny(name)
    out = run.run_cell(cell, config, 2**31 + 93, 1.5, False, device="cpu",
                       cache=cache)
    assert made == [["DeviceTrace"], []]
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s"}
    assert "breakdown" not in out and "busy_s" not in out["device"]


@pytest.mark.parametrize("trace", [False, True])
def test_no_other_run_takes_the_device_only_trace(trace, cache, monkeypatch):
    made = _spy(monkeypatch, "DeviceTrace")
    names = ["sift1m.nprobe16_b64"] + (LEX if trace else [])
    for name in names:
        cell, config = tiny(name)
        run.run_cell(cell, config, 2**31 + 94, 1.0, trace, device="cpu",
                     cache=cache)
    assert made == []
