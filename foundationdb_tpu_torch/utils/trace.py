"""Structured trace events and commit-path spans.

The port's copy of foundationdb_tpu/utils/trace.py, trimmed to what the
resolver slice uses. Reference: flow/Trace.cpp (`TraceEvent("Type",
id).detail(k, v)` structured logging) and flow/Trace.h
g_traceBatch. Events are JSON lines on stderr, or go to a sink set with
`set_sink` (tests capture them that way).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable

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
    __slots__ = ("_fields",)

    def __init__(self, event_type: str, ident=None):
        self._fields = {"Type": event_type, "Time": round(time.time(), 6)}
        if ident is not None:
            self._fields["ID"] = str(ident)

    def detail(self, key: str, value) -> "TraceEvent":
        self._fields[key] = value
        return self

    def log(self):
        _emit(self._fields)


class TraceBatch:
    """g_traceBatch (flow/Trace.h): buffered span records that stitch one
    commit's timeline across roles (Resolver.actor.cpp:83). dump() flushes
    them to the trace log."""

    def __init__(self, max_buffer: int = 4096):
        self.max_buffer = max_buffer
        self._events: list[dict] = []

    def span_begin(self, kind: str, ident, span: str, at: float | None = None):
        """Begin a named stage span for one id. Pass `at=loop.now()` so sim
        roles stamp virtual time."""
        self._span(kind, ident, span, "Begin", at)

    def span_end(self, kind: str, ident, span: str, at: float | None = None):
        self._span(kind, ident, span, "End", at)

    def _span(self, kind: str, ident, span: str, phase: str, at: float | None):
        self._events.append({"Type": kind,
                             "Time": round(time.time() if at is None else at, 6),
                             "ID": str(ident), "Span": span, "Phase": phase})
        if len(self._events) >= self.max_buffer:
            self.dump()

    def dump(self):
        events, self._events = self._events, []
        for e in events:
            _emit(e)


g_trace_batch = TraceBatch()
