"""Structured trace events, commit-path spans and rolling trace files.

The port's copy of foundationdb_tpu/utils/trace.py. Reference:
flow/Trace.cpp (`TraceEvent("Type", id).detail(k, v)` structured logging
with severities, rolling files and per-type suppression), flow/Trace.h
g_traceBatch and the proxy's LatencyBands (Stats.h). Events are JSON lines
on stderr, or go to a sink set with `set_sink` (tests capture them that
way; a server process installs a `RollingTraceFile`).

Spans of the device path (`span`, `enable_spans`) time the host's calls
into the conflict engine onto `*Seconds` counters of the engine's
CounterCollections, and name them as torch.profiler ranges.
"""

from __future__ import annotations

import functools
import json
import sys
import threading
import time
from bisect import bisect_left
from typing import Callable

SevDebug, SevInfo, SevWarn, SevWarnAlways, SevError = 5, 10, 20, 30, 40

_sink: Callable[[dict], None] | None = None
_now: Callable[[], float] = time.time
_min_severity = SevInfo


def set_clock(fn: Callable[[], float]):
    global _now
    _now = fn


def set_sink(fn: Callable[[dict], None] | None):
    global _sink
    _sink = fn


def set_min_severity(sev: int):
    global _min_severity
    _min_severity = sev


def _emit(fields: dict):
    if _sink is not None:
        _sink(fields)
    else:
        print(json.dumps(fields, default=str), file=sys.stderr)


class TraceEvent:
    __slots__ = ("_fields", "_sev")

    def __init__(self, event_type: str, ident=None, severity: int = SevInfo):
        self._sev = severity
        self._fields = {"Type": event_type, "Time": round(_now(), 6)}
        if ident is not None:
            self._fields["ID"] = str(ident)

    def detail(self, key: str, value) -> "TraceEvent":
        self._fields[key] = value
        return self

    def error(self, e: BaseException) -> "TraceEvent":
        self._sev = max(self._sev, SevError)
        self._fields["Error"] = repr(e)
        return self

    def log(self):
        if self._sev < _min_severity:
            return
        if (_suppression is not None and self._sev < SevError
                and not _suppression.admit(self._fields)):
            return  # rate-suppressed (errors always pass)
        _emit(self._fields)


class RollingTraceFile:
    """Rolling trace sink (flow/Trace.h:260 openTraceFile): JSON lines into
    `path`, rolled to `path.<n>` when `roll_bytes` is exceeded, keeping the
    newest `keep` rolls. Install with set_sink(rt.write)."""

    def __init__(self, path: str, roll_bytes: int = 10_000_000, keep: int = 10):
        import os
        self.path = path
        self.roll_bytes = roll_bytes
        self.keep = keep
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, fields: dict):
        self._f.write(json.dumps(fields, default=str) + "\n")
        if self._f.tell() >= self.roll_bytes:
            self.roll()

    def roll(self):
        import os
        self._f.close()
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", buffering=1)

    def close(self):
        self._f.close()


class _Suppression:
    """Per-type rate suppression (Trace.cpp's suppressFor): at most `limit`
    events of one Type per `interval` seconds; excess is counted and
    surfaced once per interval as a Suppressed event."""

    def __init__(self, limit: int = 100, interval: float = 5.0):
        self.limit = limit
        self.interval = interval
        self._windows: dict[str, tuple[float, int, int]] = {}

    def admit(self, fields: dict) -> bool:
        ty = fields.get("Type", "")
        now = fields.get("Time", 0.0)
        start, n, dropped = self._windows.get(ty, (now, 0, 0))
        if now - start >= self.interval:
            if dropped:
                _emit({"Type": "TraceEventsSuppressed", "Time": now,
                       "OfType": ty, "Dropped": dropped})
            start, n, dropped = now, 0, 0
        if n >= self.limit:
            self._windows[ty] = (start, n, dropped + 1)
            return False
        self._windows[ty] = (start, n + 1, dropped)
        return True


_suppression: _Suppression | None = None


def enable_suppression(limit: int = 100, interval: float = 5.0):
    global _suppression
    _suppression = _Suppression(limit, interval)


def flush_suppressed():
    """Emit pending Dropped counts (a chatty type that went quiet would
    otherwise never surface its final window's suppression)."""
    if _suppression is None:
        return
    for ty, (_start, _n, dropped) in list(_suppression._windows.items()):
        if dropped:
            _emit({"Type": "TraceEventsSuppressed", "Time": _now(),
                   "OfType": ty, "Dropped": dropped})
    _suppression._windows.clear()


def disable_suppression():
    global _suppression
    flush_suppressed()
    _suppression = None


class TraceBatch:
    """g_traceBatch (flow/Trace.h): buffered span records that stitch one
    commit's timeline across roles (Resolver.actor.cpp:83). dump() flushes
    them to the trace log."""

    def __init__(self, max_buffer: int = 4096):
        self.max_buffer = max_buffer
        self._events: list[dict] = []

    def add_event(self, kind: str, ident, location: str, at: float | None = None):
        self._append({"Type": kind,
                      "Time": round(_now() if at is None else at, 6),
                      "ID": str(ident), "Location": location})

    def add_attach(self, kind: str, ident, to: str, at: float | None = None):
        """Link two ids (e.g. a transaction to its commit batch)."""
        self._append({"Type": kind,
                      "Time": round(_now() if at is None else at, 6),
                      "ID": str(ident), "To": str(to)})

    def span_begin(self, kind: str, ident, span: str, at: float | None = None):
        """Begin a named stage span for one id. Pass `at=loop.now()` so sim
        roles stamp virtual time."""
        self._span(kind, ident, span, "Begin", at)

    def span_end(self, kind: str, ident, span: str, at: float | None = None):
        self._span(kind, ident, span, "End", at)

    def _span(self, kind: str, ident, span: str, phase: str, at: float | None):
        self._append({"Type": kind,
                      "Time": round(_now() if at is None else at, 6),
                      "ID": str(ident), "Span": span, "Phase": phase})

    def _append(self, event: dict):
        self._events.append(event)
        if len(self._events) >= self.max_buffer:
            self.dump()

    def dump(self):
        events, self._events = self._events, []
        for e in events:
            _emit(e)

    def timeline(self, ident) -> list[dict]:
        """Buffered records for one id (tests/debugging)."""
        return [e for e in self._events if e.get("ID") == str(ident)]


g_trace_batch = TraceBatch()


class LatencyBands:
    """Latency histogram traced alongside counters (the reference's
    LatencyBands in Stats.h / proxy GRV+commit bands): fixed upper-bound
    bands in seconds, counts per band."""

    BANDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0)

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * (len(self.BANDS) + 1)
        self.total = 0
        self.max_seen = 0.0

    def add(self, seconds: float):
        self.counts[bisect_left(self.BANDS, seconds)] += 1
        self.total += 1
        self.max_seen = max(self.max_seen, seconds)

    def trace(self):
        ev = TraceEvent(f"{self.name}LatencyBands")
        for bound, n in zip(self.BANDS, self.counts):
            if n:
                ev.detail(f"le_{bound}", n)
        if self.counts[-1]:
            ev.detail("gt_last", self.counts[-1])
        ev.detail("Total", self.total).detail("Max", round(self.max_seen, 6))
        ev.log()


# ---------------------------------------------------------------------------
# spans of the device path: host seconds on the counters, profiler ranges
# ---------------------------------------------------------------------------

# every span's name, "<CounterCollection>.<span>": the range it opens in a
# torch.profiler trace, so a timeline can tell the port's ranges from others
SPAN_NAMES = ("CudaTransfers.Put", "CudaGraphs.Replay", "CudaTransfers.Get",
              "ConflictKernel.Encode", "ConflictKernel.Verdicts",
              "ConflictKernel.HostPass", "CudaGraphs.Capture")

_spans_on = False
_span_lock = threading.Lock()  # the verdicts run in up to four threads
_autograd_profiler = None


def enable_spans(on: bool = True):
    """Switch the spans on or off (off at import). Off, a span costs one
    test of this flag; on, it adds its call's seconds to its counter and,
    while a torch.profiler records, opens the range of its name."""
    global _spans_on
    _spans_on = bool(on)


def spans_enabled() -> bool:
    return _spans_on


def _timed(name: str, seconds, fn, args, kwargs):
    global _autograd_profiler
    t0 = time.perf_counter()
    try:
        if _spans_on:
            if _autograd_profiler is None:
                import torch.autograd.profiler as _autograd_profiler
            if _autograd_profiler._is_profiler_enabled:
                with _autograd_profiler.record_function(name):
                    return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t0
        with _span_lock:
            seconds.increment(dt)


def span(name: str, seconds, always: bool = False):
    """Decorator: a span named `name` (one of SPAN_NAMES) over each call of
    the function, its seconds added to the Counter `seconds` while spans
    are on, or at every call with `always` (for calls too rare to matter).
    The call's count is the caller's own counter, which always counts."""
    if name not in SPAN_NAMES:
        raise ValueError(f"{name!r} is not one of {SPAN_NAMES}")

    def wrap(fn):
        if always:
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                return _timed(name, seconds, fn, args, kwargs)
        else:
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                if not _spans_on:
                    return fn(*args, **kwargs)
                return _timed(name, seconds, fn, args, kwargs)
        return spanned
    return wrap
