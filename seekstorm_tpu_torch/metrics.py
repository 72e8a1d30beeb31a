"""Process-wide metrics + tracing hooks (aux subsystem, SURVEY §5).

The reference exposes per-query timing (`time` in the result JSON,
reference search.rs:1153 result assembly) and little else; production
deployments need an observability surface, so this module adds cheap
thread-safe counters/timers around the hot paths and renders them in
Prometheus text format at GET /metrics (server/app.py).

Timer sums add each call's seconds: per-thread sums over-count waits under
concurrent callers, and a trace's spans show the overlap.

Device-side tracing delegates to `torch.profiler` (start_trace/stop_trace),
which one owner thread starts and stops whichever thread asks.  While a
trace runs every timer also records a span (name, host start and end,
thread, the id of its `search_batch`), and stop_trace writes the spans into
the session's trace file on the profiler's clock.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor


class Metrics:
    """Thread-safe counter + timer registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timer_count: dict[str, int] = {}
        self._timer_sum: dict[str, float] = {}
        # spans of the running trace, (name, start ns, end ns, thread id,
        # batch id) on perf_counter_ns; None while no trace runs
        self._spans: list | None = None
        # next() on a count is one C call, atomic under the interpreter lock
        self._batch_ids = itertools.count(1)
        self._local = threading.local()     # .batch: the thread's batch id

    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timer_count[name] = self._timer_count.get(name, 0) + 1
            self._timer_sum[name] = self._timer_sum.get(name, 0.0) + seconds

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def batch(self) -> "_Batch":
        """Scope of one search_batch: the id its spans carry."""
        return _Batch(self)

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: v for k, v in self._counters.items()}
            for k in self._timer_count:
                out[f"{k}_count"] = self._timer_count[k]
                out[f"{k}_seconds_total"] = self._timer_sum[k]
            return out

    def render_prometheus(self) -> str:
        lines = []
        with self._lock:
            for k in sorted(self._counters):
                lines.append(f"# TYPE seekstorm_{k} counter")
                lines.append(f"seekstorm_{k} {self._counters[k]:g}")
            for k in sorted(self._timer_count):
                lines.append(f"# TYPE seekstorm_{k}_seconds summary")
                lines.append(
                    f"seekstorm_{k}_seconds_count {self._timer_count[k]}"
                )
                lines.append(
                    f"seekstorm_{k}_seconds_sum {self._timer_sum[k]:.6f}"
                )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timer_count.clear()
            self._timer_sum.clear()


class _Timer:
    __slots__ = ("_m", "_name", "_t0")

    def __init__(self, m: Metrics, name: str):
        self._m = m
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        m = self._m
        m.observe(self._name, (t1 - self._t0) * 1e-9)
        spans = m._spans
        if spans is not None:
            # list.append is atomic: every thread shares the list
            spans.append((self._name, self._t0, t1, threading.get_native_id(),
                          getattr(m._local, "batch", 0)))
        return False


class _Batch:
    """Draws a batch id for the thread's spans; a nested search_batch (one
    group of a mixed batch) keeps its caller's.  Under a trace the batch's
    own interval is a span named ``search_batch``."""

    __slots__ = ("_m", "_id", "_t0")

    def __init__(self, m: Metrics):
        self._m = m

    def __enter__(self):
        m = self._m
        if getattr(m._local, "batch", 0):
            self._id = 0
        else:
            self._id = m._local.batch = next(m._batch_ids)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._id:
            m = self._m
            m._local.batch = 0
            spans = m._spans
            if spans is not None:
                spans.append(("search_batch", self._t0,
                              time.perf_counter_ns(),
                              threading.get_native_id(), self._id))
        return False


METRICS = Metrics()


# ---------------------------------------------------------------------------
# device tracing (torch.profiler on one owner thread)

_trace = None
_trace_lock = threading.Lock()
_owner = None


def _on_owner(fn):
    """fn() on the trace's owner thread, made at the first trace: a
    torch.profiler session belongs to the thread that started it.  Called
    under _trace_lock."""
    global _owner
    if _owner is None:
        _owner = ThreadPoolExecutor(1, thread_name_prefix="seekstorm-trace")
    return _owner.submit(fn).result()


def _clock_offset_ns() -> int:
    """The profiler's clock less perf_counter_ns, from one paired reading:
    torch.profiler stamps its events in epoch ns, time.time_ns()'s clock."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


class _Session:
    def __init__(self, log_dir: str, prof, offset_ns: int):
        self.log_dir, self.prof, self.offset_ns = log_dir, prof, offset_ns

    @classmethod
    def start(cls, log_dir: str) -> "_Session | str":
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            prof.start()
        except RuntimeError as e:
            return f"{type(e).__name__}: {e}"
        return cls(log_dir, prof, _clock_offset_ns())

    def stop(self, spans: list) -> bool | str:
        """Stop the profiler and write its trace, with `spans` in it, to
        log_dir (TensorBoard's file name)."""
        try:
            self.prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir, f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            # the export's "ts" is microseconds after baseTimeNanoseconds
            off = self.offset_ns - trace.get("baseTimeNanoseconds", 0)
            pid = os.getpid()
            trace["traceEvents"].extend(
                {"ph": "X", "cat": "seekstorm", "name": name, "pid": pid,
                 "tid": tid, "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
                 "args": {"batch": batch}}
                for name, t0, t1, tid, batch in spans)
            with open(path, "w") as f:
                json.dump(trace, f)
        except (RuntimeError, OSError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return True


def start_trace(log_dir: str) -> bool | str:
    """Start a torch.profiler trace of the host and, where CUDA is
    available, the card, written to `log_dir` in TensorBoard's format when
    stop_trace ends it.  Returns False if a trace is already running, an
    error string on failure."""
    global _trace
    with _trace_lock:
        if _trace is not None:
            return False
        r = _on_owner(lambda: _Session.start(log_dir))
        if isinstance(r, str):
            return r
        _trace = r
        METRICS._spans = []
        return True


def stop_trace() -> bool | str:
    global _trace
    with _trace_lock:
        if _trace is None:
            return False
        # the session is finished either way: a new start is allowed
        session, _trace = _trace, None
        spans, METRICS._spans = METRICS._spans, None
        return _on_owner(lambda: session.stop(spans))
