"""Structured trace events and commit-path spans.

The port's copy of foundationdb_tpu/utils/trace.py, trimmed to what the
commit pipeline uses. Reference: flow/Trace.cpp (`TraceEvent("Type",
id).detail(k, v)` structured logging), flow/Trace.h g_traceBatch and the
proxy's LatencyBands (Stats.h). Events are JSON lines on stderr, or go to a sink set with
`set_sink` (tests capture them that way).
"""

from __future__ import annotations

import json
import sys
import time
from bisect import bisect_left
from typing import Callable

SevDebug, SevInfo, SevWarn, SevWarnAlways, SevError = 5, 10, 20, 30, 40

_sink: Callable[[dict], None] | None = None


def set_sink(fn: Callable[[dict], None] | None):
    global _sink
    _sink = fn


def _emit(fields: dict):
    if _sink is not None:
        _sink(fields)
    else:
        print(json.dumps(fields, default=str), file=sys.stderr)


class TraceEvent:
    __slots__ = ("_fields", "_sev")

    def __init__(self, event_type: str, ident=None, severity: int = SevInfo):
        self._sev = severity
        self._fields = {"Type": event_type, "Time": round(time.time(), 6)}
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
        if self._sev < SevInfo:  # the reference's default minimum severity
            return
        _emit(self._fields)


class TraceBatch:
    """g_traceBatch (flow/Trace.h): buffered span records that stitch one
    commit's timeline across roles (Resolver.actor.cpp:83). dump() flushes
    them to the trace log."""

    def __init__(self, max_buffer: int = 4096):
        self.max_buffer = max_buffer
        self._events: list[dict] = []

    def add_event(self, kind: str, ident, location: str, at: float | None = None):
        self._append({"Type": kind,
                      "Time": round(time.time() if at is None else at, 6),
                      "ID": str(ident), "Location": location})

    def add_attach(self, kind: str, ident, to: str, at: float | None = None):
        """Link two ids (e.g. a transaction to its commit batch)."""
        self._append({"Type": kind,
                      "Time": round(time.time() if at is None else at, 6),
                      "ID": str(ident), "To": str(to)})

    def span_begin(self, kind: str, ident, span: str, at: float | None = None):
        """Begin a named stage span for one id. Pass `at=loop.now()` so sim
        roles stamp virtual time."""
        self._span(kind, ident, span, "Begin", at)

    def span_end(self, kind: str, ident, span: str, at: float | None = None):
        self._span(kind, ident, span, "End", at)

    def _span(self, kind: str, ident, span: str, phase: str, at: float | None):
        self._append({"Type": kind,
                      "Time": round(time.time() if at is None else at, 6),
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
