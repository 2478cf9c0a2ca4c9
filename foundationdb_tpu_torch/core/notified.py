"""NotifiedVersion: a monotonically increasing value with threshold waiters.

Reference: fdbclient/Notified.h:29 — the ordering primitive of the whole write
pipeline. The resolver orders batches by waiting version.whenAtLeast(prev)
(Resolver.actor.cpp:104), TLogs order commits the same way
(TLogServer.actor.cpp:1168), proxies gate their pipeline phases on it
(MasterProxyServer.actor.cpp:364-366,426-428), and storage servers wake readers
when they catch up (storageserver.actor.cpp:654 waitForVersion).
"""

from __future__ import annotations

import heapq

from foundationdb_tpu_torch.core.future import Future, ready_future


class NotifiedVersion:
    __slots__ = ("_value", "_waiters", "_seq")

    def __init__(self, value: int = 0):
        self._value = value
        self._waiters: list[tuple[int, int, Future]] = []  # (threshold, seq, f)
        self._seq = 0

    def get(self) -> int:
        return self._value

    def when_at_least(self, threshold: int) -> Future:
        if self._value >= threshold:
            return ready_future(self._value)
        f = Future()
        self._seq += 1
        heapq.heappush(self._waiters, (threshold, self._seq, f))
        return f

    def set(self, value: int):
        if value < self._value:
            raise ValueError(f"NotifiedVersion moved backwards: {self._value} -> {value}")
        self._value = value
        while self._waiters and self._waiters[0][0] <= value:
            _, _, f = heapq.heappop(self._waiters)
            if not f.is_ready():
                f._set(value)


class AsyncVar:
    """A mutable value with change notification (flow/genericactors.actor.h
    AsyncVar): readers `await onChange()` to observe the next set(); set with
    an equal value does not fire (the reference's setUnconditional is
    `set_unconditional`)."""

    def __init__(self, value=None):
        self._value = value
        self._waiters: list[Future] = []

    def get(self):
        return self._value

    def on_change(self) -> Future:
        f = Future()
        self._waiters.append(f)
        return f

    def set(self, value):
        if value == self._value:
            return
        self.set_unconditional(value)

    def set_unconditional(self, value):
        self._value = value
        waiters, self._waiters = self._waiters, []
        for f in waiters:
            f._set(value)


class AsyncTrigger:
    """An edge-only signal (flow/genericactors.actor.h AsyncTrigger):
    `await on_trigger()` resumes at the NEXT trigger(); triggers with no
    waiters are not remembered."""

    def __init__(self):
        self._waiters: list[Future] = []

    def on_trigger(self) -> Future:
        f = Future()
        self._waiters.append(f)
        return f

    def trigger(self):
        waiters, self._waiters = self._waiters, []
        for f in waiters:
            f._set(None)
