"""The traced run: ``torch.profiler`` over the window, and host spans that the
benchmark records around the program's layers, so that the trace can say
what the host was doing while the device sat idle.

Spans are host intervals on the benchmark's clock, named by layer: one
around each client request (``request``), one around each program timer
(``timer.<name>``, e.g. ``timer.lex_device``) and one around each function
listed in SPANS, in whatever thread runs it.  They are set up when the trace
starts and taken away when it stops, so an untraced run runs the program
untouched; a SPANS target missing from the port fails the traced run.  The
profiler records the device; one ``record_function`` marker in the thread
that starts it puts the spans on the trace's clock.

``DeviceTrace`` records the card's operations alone, for an untraced run of
a cell whose end-to-end metrics read the device trace.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time
from collections import defaultdict

# (module, function, span name): host layers of the port, entry point down
SPANS = [
    ("seekstorm_tpu_torch.search", "_build_specs", "search.parse"),
    ("seekstorm_tpu_torch.search", "_merge_tail", "search.tail_merge"),
    ("seekstorm_tpu_torch.search", "_finalize_lexical", "search.finalize"),
    ("seekstorm_tpu_torch.ops.wand", "plan_batch", "wand.plan"),
    ("seekstorm_tpu_torch.vector_search", "_quantize_queries",
     "vector.quantize"),
    ("seekstorm_tpu_torch.vector_search", "_scan_committed_shard",
     "vector.committed_scan"),
]


class Trace:
    def __init__(self, torch, metrics):
        self.torch = torch
        self.metrics = metrics
        self._undo = []
        self.prof = None
        self.spans: list[tuple[float, float, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # list.append is atomic: client threads share the list
            self.spans.append((t0, time.perf_counter(), name))

    def _wrap(self, fn, name):
        span = self.span

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return wrapped

    def start(self) -> None:
        missing = [f"{m}.{a}" for m, a, _ in SPANS
                   if not callable(getattr(importlib.import_module(m), a,
                                           None))]
        if missing:
            # a span that silently went would leave its layer's idle time
            # to the span around it
            raise RuntimeError("the traced run's span targets are gone "
                               f"from the port: {', '.join(missing)}")
        for mod_name, attr, name in SPANS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            setattr(mod, attr, self._wrap(fn, name))
            self._undo.append((mod, attr, fn))
        timer, span = self.metrics.timer, self.span

        @contextlib.contextmanager
        def traced_timer(name):
            with span(f"timer.{name}"), timer(name):
                yield
        self.metrics.timer = traced_timer
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        self.prof = self.torch.profiler.profile(activities=acts)
        self.prof.start()
        with self.torch.profiler.record_function("bench_port.align"):
            self.t_align = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()
        del self.metrics.timer

    def summary(self, top: int = 10) -> dict:
        """busy_s (union of device operations), kernel_s (kernel time),
        window_s, the device operations that took most time and the idle
        gaps summed by the innermost host span open at their middle."""
        dev, align = [], None
        for e in self.prof.profiler.kineto_results.events():
            a, d = _start_us(e), _dur_us(e)
            if str(e.device_type()).rsplit(".", 1)[-1] == "CPU":
                if e.name() == "bench_port.align":
                    align = a + d / 2
            elif d > 0:
                dev.append((a, a + d, e.name()))
        # host clock -> trace clock, by the marker (to its duration's
        # half, some microseconds)
        off = (align - 1e6 * self.t_align) if align is not None else None
        spans = ([(1e6 * a + off, 1e6 * b + off, n) for a, b, n in self.spans]
                 if off is not None else [])
        cpu_lo = 1e6 * self.t0 + off if off is not None else (
            min((a for a, _, _ in dev), default=0.0))
        return summarize(dev, spans, cpu_lo, self.window_s, top)


class DeviceTrace:
    """torch.profiler recording the card alone, for an untraced run.  Its
    start takes seconds (7-8 on an H100 machine, far longer beside a busy
    client), so set-up does not pay it: the client's first request starts
    it, in an owner thread that also stops it, waits until it runs, and
    launches a marker kernel on the idle card, which divides the window's
    operations from set-up's.  The requests from then on are counted.
    Without a card it records nothing."""

    MARK = "spin_kernel"          # torch.cuda._sleep's kernel

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.error = None
        self.queries = 0
        self.marked = False
        self._thread = None
        self._ready = threading.Event()
        self._stop = threading.Event()

    def before(self) -> None:
        """In the client, before each request: the first starts the trace,
        waits for it and marks the card."""
        if self.marked or not self.torch.cuda.is_available():
            return
        self._thread = threading.Thread(target=self._own, daemon=True,
                                        name="bench_port.device_trace")
        self._thread.start()
        self._ready.wait()
        if self.error is not None:
            raise RuntimeError(f"the device trace did not start: "
                               f"{self.error!r}")
        self.torch.cuda.synchronize()
        self.torch.cuda._sleep(1000)
        self.marked, self.t0 = True, time.perf_counter()

    def after(self, queries: int) -> None:
        """In the client, after each request answered."""
        if self.marked:
            self.queries += queries

    def counting(self, search):
        """`search` with ``before`` ahead of each request and ``after``
        once it is answered."""
        def counted(rs):
            self.before()
            res = search(rs)
            self.after(len(rs))
            return res
        return counted

    def _own(self) -> None:
        try:
            self.prof = self.torch.profiler.profile(
                activities=[self.torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        except BaseException as e:        # reported by before()
            self.error, self.prof = e, None
        finally:
            self._ready.set()
        self._stop.wait()
        if self.prof is not None:
            try:
                self.prof.stop()
            except BaseException as e:    # reported by stop()
                self.error = e

    def stop(self) -> None:
        if self._thread is None:
            return
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise RuntimeError(f"the device trace did not stop: "
                               f"{self.error!r}")

    def summary(self, top: int = 10) -> dict | None:
        """``summarize`` over the operations from the marker's end on, and
        the queries the requests sent after it answered; None where nothing
        was counted."""
        if self.prof is None or not self.marked:
            return None
        dev = []
        for e in self.prof.profiler.kineto_results.events():
            a, d = _start_us(e), _dur_us(e)
            if str(e.device_type()).rsplit(".", 1)[-1] != "CPU" and d > 0:
                dev.append((a, a + d, e.name()))
        ops, lo = after_mark(dev, self.MARK)
        return {**summarize(ops, [], lo, self.window_s, top),
                "queries": self.queries}


def after_mark(dev, mark: str):
    """(the operations that start at or after the end of the last one
    named like `mark`, that end); every operation and the first start where
    there is no marker."""
    marks = [b for a, b, n in dev if mark in n]
    if not marks:
        return dev, min((a for a, _, _ in dev), default=0.0)
    end = max(marks)
    return [(a, b, n) for a, b, n in dev
            if a >= end and mark not in n], end


def summarize(dev, spans, lo: float, window_s: float, top: int = 10) -> dict:
    """From device operations and host spans ((start us, end us, name), one
    clock) over a window starting at `lo`: busy_s (union of device
    operations), kernel_s (kernels alone), window_s, the device operations
    that took most time, and the idle gaps summed by the innermost host span
    open at their middle."""
    hi = lo + 1e6 * window_s
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) * 1e-6
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = _attribute(
        [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a], spans)
    return {
        "busy_s": busy,
        # kernels alone: copies and fills left out
        "kernel_s": sum(s for n, s in by_name.items()
                        if not n.startswith(("Memcpy", "Memset"))),
        "window_s": window_s,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }


def _attribute(gaps, spans) -> dict:
    """Seconds of idle gap by the innermost span (the latest started) open
    at each gap's middle, in one sweep over both sorted lists."""
    out = defaultdict(float)
    bounds = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    active: dict[int, float] = {}
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while j < len(bounds) and bounds[j][0] <= mid:
            t, opens, i = bounds[j]
            if opens:
                active[i] = t
            else:
                active.pop(i, None)
            j += 1
        owner = (spans[max(active, key=active.get)][2] if active
                 else "no span")
        out[owner] += (b - a) * 1e-6
    return out


def _start_us(e) -> float:
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-3
    return float(e.start_us())


def _dur_us(e) -> float:
    if hasattr(e, "duration_ns"):
        return e.duration_ns() * 1e-3
    return float(e.duration_us())
