"""Deterministic single-threaded prioritized event loop.

Reference: flow/Net2.actor.cpp — Net2::run (:550) drains a priority queue of
OrderedTasks with 42 named priorities (flow/network.h:31-73); the simulator
(fdbrpc/sim2.actor.cpp) replaces the wall clock with virtual time so a run is a
pure function of the seed.

Ordering contract: runnable items execute in (time, -priority, seq) order.
`seq` is a global monotone counter, so same-time same-priority items run in
schedule order — this is what makes whole-cluster simulation replayable.

The loop runs coroutines ("actors") that await Futures. Cancellation follows
Flow's model: cancelling an actor injects operation_cancelled at its current
wait point (flow/README.md "ACTOR cancellation").
"""

from __future__ import annotations

import heapq
from typing import Any, Coroutine

from foundationdb_tpu_torch.core.future import Future
from foundationdb_tpu_torch.utils.errors import FDBError


class TaskPriority:
    """Subset of flow/network.h task priorities (higher runs first)."""

    Max = 1000000
    Coordination = 8800
    FailureMonitor = 8700
    TLogCommit = 8570
    ProxyCommitDispatch = 8550
    ProxyCommit = 8540
    ResolverResolve = 8530
    ProxyGetConsistentReadVersion = 8500
    DefaultOnMainThread = 7500
    DefaultDelay = 7010
    DefaultYield = 7000
    DataDistribution = 3500
    UpdateStorage = 3000
    Low = 2000
    Min = 1000
    Zero = 0


class ActorTask(Future):
    """A running coroutine; also the Future of its final result.

    Unhandled-error contract (Flow's SAV error delivery, flow/flow.h): an
    actor that dies with an error *nobody is waiting on* must not fail
    silently — the loop reports it loudly (default: raise out of the run
    loop). operation_cancelled is benign (that's how kills reap actors).
    """

    __slots__ = ("_coro", "_loop", "name", "_waiting_on", "_cancelled",
                 "_observed", "_started")

    def __init__(self, loop: "EventLoop", coro: Coroutine, name: str):
        super().__init__()
        self._loop = loop
        self._coro = coro
        self.name = name
        self._waiting_on: Future | None = None
        self._cancelled = False
        self._observed = False
        self._started = False

    def __del__(self):
        # A task whose loop was abandoned before its first step holds a
        # coroutine that never ran; close it so GC doesn't emit
        # "coroutine ... was never awaited" (the silent-task-loss class —
        # the suite runs with that warning promoted to an error).
        if not self._started and not self.is_ready():
            self._coro.close()

    def add_callback(self, cb):
        self._observed = True
        super().add_callback(cb)

    def add_system_callback(self, cb):
        """Bookkeeping callback that does NOT count as observing the result
        (used by SimProcess's actor registry)."""
        super().add_callback(cb)

    # awaiting/getting an already-failed task raises inline without going
    # through add_callback — still counts as observing the error
    def __await__(self):
        self._observed = True
        return super().__await__()

    def get(self):
        self._observed = True
        return super().get()

    def cancel(self):
        """Inject operation_cancelled at the actor's current wait point."""
        if self.is_ready() or self._cancelled:
            return
        self._cancelled = True
        if self._waiting_on is not None:
            self._waiting_on.remove_callback(self._on_waited)
            self._waiting_on = None
        self._loop._schedule(0.0, TaskPriority.DefaultOnMainThread, self._step_cancel)

    def _step_cancel(self):
        if self.is_ready():
            return
        self._started = True
        # If the actor swallows the cancellation (cleanup in an except/finally
        # that awaits), _drive registers on whatever it awaits next.
        self._cancelled = False
        self._drive(lambda: self._coro.throw(FDBError("operation_cancelled")))

    def _start(self):
        self._started = True
        self._step()

    def _step(self):
        if self.is_ready():
            return  # died meanwhile (e.g. a cancel landed between a queued
            # resume and now): a finished coroutine must never be re-driven
        # the resume hot path: _drive(lambda: self._coro.send(None)) costs
        # a closure allocation + an extra frame per actor step, which is
        # measurable at bench rates — inline the send instead
        try:
            waited = self._coro.send(None)
        except StopIteration as stop:
            self._set(stop.value)
            return
        except BaseException as e:  # noqa: BLE001
            self._died(e)
            return
        self._waiting_on = waited
        waited.add_callback(self._on_waited)

    def _drive(self, advance):
        """Advance the coroutine one step; park it on whatever it yields."""
        try:
            waited = advance()
        except StopIteration as stop:
            self._set(stop.value)
            return
        except BaseException as e:  # noqa: BLE001
            self._died(e)
            return
        self._waiting_on = waited
        waited.add_callback(self._on_waited)

    def _died(self, err: BaseException):
        self._set_error(err)
        if not self._observed and not (
                isinstance(err, FDBError) and err.name == "operation_cancelled"):
            # defer one scheduler turn at the lowest priority: a caller
            # that awaits the task in the same virtual instant observes it
            # first; only a genuinely unwatched death reports
            self._loop._schedule(
                0.0, TaskPriority.Zero,
                lambda: None if self._observed
                else self._loop._report_unhandled(self, err))

    def _on_waited(self, fut: Future):
        self._waiting_on = None
        self._loop._schedule(0.0, TaskPriority.DefaultOnMainThread, self._step)


class EventLoop:
    """Deterministic scheduler with a virtual (or wall) clock."""

    def __init__(self, start_time: float = 0.0):
        self._now = start_time
        self._seq = 0
        self._heap: list[tuple[float, int, int, Any]] = []
        self._stopped = False
        # Override to tolerate unobserved actor errors (takes (task, error));
        # None = trace the error and raise, crashing the run loop.
        self.on_unhandled_actor_error = None

    def _report_unhandled(self, task: "ActorTask", error: BaseException):
        if self.on_unhandled_actor_error is not None:
            self.on_unhandled_actor_error(task, error)
            return
        from foundationdb_tpu_torch.utils.trace import TraceEvent
        TraceEvent("UnhandledActorError", task.name).detail(
            "Error", repr(error)).log()
        raise error

    # -- clock --
    def now(self) -> float:
        return self._now

    # -- scheduling primitives --
    def _schedule(self, delay: float, priority: int, fn):
        self._seq += 1
        heapq.heappush(self._heap, (self._now + delay, -priority, self._seq, fn))

    def delay(self, seconds: float, priority: int = TaskPriority.DefaultDelay) -> Future:
        f = Future()
        self._schedule(max(0.0, seconds), priority, lambda: f._set(None) if not f.is_ready() else None)
        return f

    def yield_(self, priority: int = TaskPriority.DefaultYield) -> Future:
        return self.delay(0.0, priority)

    def spawn(self, coro: Coroutine, name: str = "actor") -> ActorTask:
        task = ActorTask(self, coro, name)
        self._schedule(0.0, TaskPriority.DefaultOnMainThread, task._start)
        return task

    def stop(self):
        self._stopped = True

    # -- running --
    def run_until_idle(self, max_time: float | None = None) -> float:
        """Drain the queue, advancing virtual time; returns final time."""
        self._stopped = False
        while self._heap and not self._stopped:
            t, negp, seq, fn = heapq.heappop(self._heap)
            if max_time is not None and t > max_time:
                heapq.heappush(self._heap, (t, negp, seq, fn))
                self._now = max_time
                break
            self._now = max(self._now, t)
            fn()
        return self._now

    def run_future(self, fut: Future, max_time: float | None = None) -> Any:
        """Run until `fut` resolves; returns its value (or raises)."""
        if isinstance(fut, ActorTask):
            fut._observed = True  # the caller is watching this actor
        self._stopped = False
        while not fut.is_ready() and self._heap and not self._stopped:
            t, negp, seq, fn = heapq.heappop(self._heap)
            if max_time is not None and t > max_time:
                heapq.heappush(self._heap, (t, negp, seq, fn))  # don't lose it
                raise FDBError("timed_out", "run_future hit max_time")
            self._now = max(self._now, t)
            fn()
        if not fut.is_ready():
            raise FDBError("internal_error", "deadlock: future unresolved and queue empty")
        return fut.get()

    def run_blocking(self, fn) -> Future:
        """Future of fn()'s value, for host-blocking work (e.g. a device
        readback). The deterministic sim runs it inline — virtual time does
        not advance and replay stays exact; RealEventLoop overrides this to
        a worker thread so the loop keeps serving while the host blocks
        (the reference's IThreadPool / onMainThread bridge, flow/flow.h)."""
        out = Future()
        try:
            out._set(fn())
        except BaseException as e:  # noqa: BLE001 — delivered to the awaiter
            out._set_error(e)
        return out

    def timeout(self, fut: Future, seconds: float) -> Future:
        """Future of fut's value, or error timed_out after `seconds`.

        Reference: flow/genericactors.actor.h timeoutError.
        """
        out = Future()

        def on_fut(f: Future):
            if out.is_ready():
                return
            if f.is_error():
                out._set_error(f._result)
            else:
                out._set(f._result)

        fut.add_callback(on_fut)
        self._schedule(
            seconds,
            TaskPriority.DefaultDelay,
            lambda: out._set_error(FDBError("timed_out")) if not out.is_ready() else None,
        )
        return out
