"""Futures, promises and streams.

Reference: flow/flow.h — SAV<T> single-assignment variable (:351), Future<T>
(:595), Promise<T> (:709), PromiseStream/FutureStream (:760,:837). Error
propagation is by exception (flow/Error.h); `broken_promise` is delivered when
a Promise is dropped unfulfilled, which is how dead servers surface to waiters.

A Future here is a plain awaitable resolved by the EventLoop. It is decoupled
from any particular loop: callbacks fire synchronously on set, and the loop's
task-resume callback reschedules the awaiting actor.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Generator

from foundationdb_tpu_torch.utils.errors import FDBError

_PENDING, _VALUE, _ERROR = 0, 1, 2


class Future:
    __slots__ = ("_state", "_result", "_callbacks")

    def __init__(self):
        self._state = _PENDING
        self._result: Any = None
        self._callbacks: list[Callable[[Future], None]] = []

    # -- inspection --
    def is_ready(self) -> bool:
        return self._state != _PENDING

    def is_error(self) -> bool:
        return self._state == _ERROR

    def get(self) -> Any:
        """Value if ready; raises if error or not ready."""
        if self._state == _VALUE:
            return self._result
        if self._state == _ERROR:
            raise self._result
        raise FDBError("internal_error", "Future.get() on pending future")

    # -- resolution (used by Promise / loop) --
    def _set(self, value: Any):
        if self._state != _PENDING:
            raise FDBError("internal_error", "future set twice")
        self._state = _VALUE
        self._result = value
        self._fire()

    def _set_error(self, error: BaseException):
        if self._state != _PENDING:
            return  # late error after value: drop (matches SAV sendError races)
        self._state = _ERROR
        self._result = error
        self._fire()

    def _fire(self):
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_callback(self, cb: Callable[[Future], None]):
        if self._state != _PENDING:
            cb(self)
        else:
            self._callbacks.append(cb)

    def remove_callback(self, cb):
        try:
            self._callbacks.remove(cb)
        except ValueError:
            pass

    def __await__(self) -> Generator["Future", None, Any]:
        if self._state == _PENDING:
            yield self
        if self._state == _ERROR:
            raise self._result
        if self._state == _PENDING:
            raise FDBError("internal_error", "actor resumed with pending future")
        return self._result


class Promise:
    """Sender side of a Future. Dropping it unfulfilled breaks the future."""

    __slots__ = ("future", "_sent")

    def __init__(self):
        self.future = Future()
        self._sent = False

    def send(self, value: Any = None):
        self._sent = True
        self.future._set(value)

    def send_error(self, error: BaseException):
        self._sent = True
        self.future._set_error(error)

    def is_set(self) -> bool:
        return self.future.is_ready()

    def break_promise(self):
        if not self.future.is_ready():
            self.future._set_error(FDBError("broken_promise"))


def settle_failed(reply: Promise, e: BaseException) -> None:
    """Settle a reply promise from a FAILING spawned handler, just before
    the exception propagates and kills the coroutine. The transport only
    auto-answers raises from synchronous handlers; a spawned delegate that
    dies with its reply unsettled wedges the caller until the full RPC
    timeout (protolint PROTO002). Cancellation maps to broken_promise:
    forwarding operation_cancelled verbatim would make the remote caller
    believe its OWN operation was cancelled and kill actors (see
    ratekeeper._sample's re-raise discipline)."""
    if isinstance(e, FDBError) and e.name == "operation_cancelled":
        e = FDBError("broken_promise", "handler cancelled before reply")
    reply.send_error(e)


def settle_many(settlements) -> None:
    """Settle a batch of promises synchronously, in order.

    `settlements` is a list of (promise, value, error) triples — error is
    None for a value settlement. One native reply batch (a ClientConn.feed
    over a socket read) resolves every future it carries from a single
    call in a single loop tick: each settle fires its callbacks inline,
    and only the awaiting actors' resumes go back through the loop, so
    the per-future schedule hop of settling one-by-one from a coroutine
    disappears. Already-settled promises (request expired, duplicate
    reply) are skipped, matching the reply loop's dedup discipline."""
    for p, value, error in settlements:
        if p.is_set():
            continue
        if error is not None:
            p.send_error(error)
        else:
            p.send(value)


class PromiseStream:
    """Multi-value stream: send() many values; receivers pop() Futures.

    Reference: flow/flow.h:760 PromiseStream / :837 FutureStream. Queueing is
    unbounded; `close(error)` ends the stream (end_of_stream by default).
    """

    __slots__ = ("_queue", "_waiters", "_closed")

    def __init__(self):
        # deques: both ends see O(1) — a saturated stream (thousands of
        # queued commits / GRV waiters) must not turn every pop into a
        # front-shift of the whole backlog
        self._queue: deque[Any] = deque()
        self._waiters: deque[Future] = deque()
        self._closed: BaseException | None = None

    def send(self, value: Any = None):
        if self._closed is not None:
            return
        if self._waiters:
            self._waiters.popleft()._set(value)
        else:
            self._queue.append(value)

    def close(self, error: BaseException | None = None):
        if self._closed is not None:
            return
        self._closed = error or FDBError("end_of_stream")
        for w in self._waiters:
            w._set_error(self._closed)
        self._waiters = deque()

    def pop(self) -> Future:
        """Future of the next value (FIFO among waiters — deterministic)."""
        f = Future()
        if self._queue:
            f._set(self._queue.popleft())
        elif self._closed is not None:
            f._set_error(self._closed)
        else:
            self._waiters.append(f)
        return f

    def __len__(self):
        return len(self._queue)


def ready_future(value: Any = None) -> Future:
    f = Future()
    f._set(value)
    return f


def error_future(error: BaseException) -> Future:
    f = Future()
    f._set_error(error)
    return f


def all_of(futures: list[Future]) -> Future:
    """Resolves with the list of values once all resolve; first error wins.

    Reference: flow/genericactors.actor.h waitForAll.
    """
    out = Future()
    n = len(futures)
    if n == 0:
        out._set([])
        return out
    remaining = [n]

    def on_done(_f):
        if out.is_ready():
            return
        if _f.is_error():
            out._set_error(_f._result)
            return
        remaining[0] -= 1
        if remaining[0] == 0:
            out._set([f.get() for f in futures])

    for f in futures:
        f.add_callback(on_done)
    return out


def any_of(futures: list[Future]) -> Future:
    """Resolves with (index, value) of the first future to resolve."""
    out = Future()

    def on_done(_f):
        if out.is_ready():
            return
        if _f.is_error():
            out._set_error(_f._result)
        else:
            out._set((futures.index(_f), _f._result))

    for f in futures:
        f.add_callback(on_done)
    return out
