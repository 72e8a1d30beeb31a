"""Process-wide metrics + tracing hooks (aux subsystem, SURVEY §5).

The reference exposes per-query timing (`time` in the result JSON,
reference search.rs:1153 result assembly) and little else; production
deployments need an observability surface, so this module adds cheap
thread-safe counters/timers around the hot paths and renders them in
Prometheus text format at GET /metrics (server/app.py).

Device-side tracing delegates to `torch.profiler` (start_trace/stop_trace).
"""

from __future__ import annotations

import threading
import time


class Metrics:
    """Thread-safe counter + timer registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timer_count: dict[str, int] = {}
        self._timer_sum: dict[str, float] = {}
        # busy accounting: union of wall intervals with >= 1 timer of the
        # name open.  Under multithread serving the plain sums double-
        # count queue waits (N threads timing one serialized resource);
        # busy seconds are the honest utilization figure.
        self._busy_active: dict[str, int] = {}
        self._busy_start: dict[str, float] = {}
        self._busy_sum: dict[str, float] = {}

    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timer_count[name] = self._timer_count.get(name, 0) + 1
            self._timer_sum[name] = self._timer_sum.get(name, 0.0) + seconds

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def _busy_enter(self, name: str, now: float) -> None:
        with self._lock:
            n = self._busy_active.get(name, 0)
            if n == 0:
                self._busy_start[name] = now
            self._busy_active[name] = n + 1

    def _busy_exit(self, name: str, now: float) -> None:
        with self._lock:
            n = self._busy_active.get(name, 1) - 1
            self._busy_active[name] = n
            if n == 0:
                self._busy_sum[name] = (
                    self._busy_sum.get(name, 0.0)
                    + now - self._busy_start.get(name, now))

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: v for k, v in self._counters.items()}
            for k in self._timer_count:
                out[f"{k}_count"] = self._timer_count[k]
                out[f"{k}_seconds_total"] = self._timer_sum[k]
                if self._timer_count[k]:
                    out[f"{k}_seconds_avg"] = (
                        self._timer_sum[k] / self._timer_count[k]
                    )
            for k, v in self._busy_sum.items():
                out[f"{k}_busy_seconds_total"] = v
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
            for k in sorted(self._busy_sum):
                lines.append(
                    f"# TYPE seekstorm_{k}_busy_seconds counter")
                lines.append(
                    f"seekstorm_{k}_busy_seconds {self._busy_sum[k]:.6f}"
                )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timer_count.clear()
            self._timer_sum.clear()
            self._busy_sum.clear()
            # open timers keep their starts; only accumulated sums reset


class _Timer:
    __slots__ = ("_m", "_name", "_t0")

    def __init__(self, m: Metrics, name: str):
        self._m = m
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._m._busy_enter(self._name, self._t0)
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        self._m.observe(self._name, now - self._t0)
        self._m._busy_exit(self._name, now)
        return False


METRICS = Metrics()


# ---------------------------------------------------------------------------
# device tracing (torch.profiler passthrough)

_trace = None
_trace_lock = threading.Lock()


def start_trace(log_dir: str) -> bool | str:
    """Start a torch.profiler trace of the host and, where CUDA is
    available, the card, written to `log_dir` in TensorBoard format when
    stop_trace ends it.  Returns False if a trace is already running, an
    error string on failure."""
    global _trace
    with _trace_lock:
        if _trace is not None:
            return False
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(log_dir))
        try:
            prof.start()
        except RuntimeError as e:
            return f"{type(e).__name__}: {e}"
        _trace = prof
        return True


def stop_trace() -> bool | str:
    global _trace
    with _trace_lock:
        if _trace is None:
            return False
        prof, _trace = _trace, None
        # the session is finished either way: a new start is allowed
        try:
            prof.stop()
        except RuntimeError as e:
            return f"{type(e).__name__}: {e}"
        return True
