"""The C-ABI-shaped client: fdb_c.h's stable surface over this framework.

Reference: bindings/c/fdb_c.h + fdb_c.cpp:78 — the 27-entry-point stable ABI
every language binding is built on: a version-selected, thread-safe, flat
function surface where every asynchronous operation returns an FDBFuture
handle, results are extracted with fdb_future_get_*, and errors are NUMERIC
codes (flow/error_definitions.h, mirrored by utils/errors.py), never
exceptions. The network runs on a dedicated thread (fdb_setup_network +
fdb_run_network + fdb_stop_network), exactly the reference's threading
contract: any application thread may use databases/transactions/futures
while the network thread pumps IO — this module is therefore also the
framework's ThreadSafeApi analogue (fdbclient/ThreadSafeTransaction.actor.cpp).

Function names, argument order and get/extract semantics mirror fdb_c.h so a
binding written against libfdb_c ports by changing only the FFI layer; the
implementation underneath is this framework's client (client/transaction.py)
over the real TCP transport.
"""

from __future__ import annotations

import threading

from foundationdb_tpu_torch.utils.errors import FDBError, error_code

HEADER_API_VERSION = 610

_lock = threading.Lock()
_selected_version: int | None = None
_network = None


def _err(name: str) -> int:
    return error_code(name)


class _Network:
    """The network thread: a RealEventLoop + NetTransport pumped by
    fdb_run_network; submissions hop onto it via call_soon_threadsafe."""

    def __init__(self):
        from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        self.loop = RealEventLoop()
        self.transport = NetTransport(self.loop, addr)
        self._started = threading.Event()
        self._stopped = False

    def run(self):
        """The body of fdb_run_network: blocks until fdb_stop_network."""
        self.transport.start()
        self._started.set()
        self.loop.aio.run_forever()
        self.transport.close()

    def stop(self):
        self._stopped = True
        self.loop.aio.call_soon_threadsafe(self.loop.aio.stop)

    def submit(self, coro, name="capi") -> "FDBFuture":
        """Spawn an actor on the network thread; bridge to an FDBFuture."""
        fut = FDBFuture()

        def go():
            task = self.loop.spawn(coro, name=name)
            with fut._mutex:
                fut._task = task
                cancelled = fut._cancelled
            if cancelled:
                task.cancel()  # cancel() raced in before the task existed
            task.add_callback(fut._resolve_from)
        self._started.wait()
        self.loop.aio.call_soon_threadsafe(go)
        return fut


class FDBFuture:
    """fdb_c.h FDBFuture: block/is_ready/callback + typed extraction.

    The C contract: fdb_future_get_* returns an error code and writes the
    result through out-parameters; here the out-parameter is the return
    value after the error code (Pythonic out-params), keeping call shape
    1:1 with the header."""

    def __init__(self):
        self._event = threading.Event()
        # _mutex orders resolution against callback registration and
        # cancellation: set_callback either registers before the settle or
        # fires immediately, cancel() and _resolve_from() race to settle
        # exactly once, and callbacks fire exactly once — on whichever
        # thread won. Callbacks themselves run OUTSIDE the mutex so a
        # callback may re-enter (get_error, destroy) without deadlocking.
        self._mutex = threading.Lock()
        self._settled = False
        self._value = None
        self._error: FDBError | None = None
        self._callbacks: list = []
        self._task = None
        self._cancelled = False

    def _settle(self, value, error) -> list:
        """Settle once under the mutex; -> callbacks to fire (empty if a
        concurrent settle already won)."""
        with self._mutex:
            if self._settled:
                return []
            self._settled = True
            self._value = value
            self._error = error
            cbs, self._callbacks = self._callbacks, []
        self._event.set()  # after state is visible, before callbacks run
        return cbs

    # -- resolution (network thread) --

    def _resolve_from(self, framework_future):
        if framework_future.is_error():
            e = framework_future._result
            error = (e if isinstance(e, FDBError)
                     else FDBError("unknown_error", repr(e)))
            cbs = self._settle(None, error)
        else:
            cbs = self._settle(framework_future._result, None)
        for cb, arg in cbs:
            cb(self, arg)

    # -- the fdb_future_* surface --

    def block_until_ready(self) -> int:
        self._event.wait()
        return 0

    def is_ready(self) -> bool:
        return self._event.is_set()

    def set_callback(self, callback, callback_parameter=None) -> int:
        """fdb_future_set_callback: fires on the network thread, or
        immediately if already ready (the reference's contract). Holding
        the mutex across the registered/settled decision closes the race
        where a callback registered mid-resolution was never invoked."""
        with self._mutex:
            if not self._settled:
                self._callbacks.append((callback, callback_parameter))
                return 0
        self._event.wait()  # settle publishes state before firing callbacks
        callback(self, callback_parameter)
        return 0

    def cancel(self):
        with self._mutex:
            self._cancelled = True
            task = self._task
        if task is not None and _network is not None:
            _network.loop.aio.call_soon_threadsafe(task.cancel)
        for cb, arg in self._settle(None, FDBError("operation_cancelled")):
            cb(self, arg)

    def destroy(self):
        with self._mutex:
            self._callbacks = []
            self._task = None

    def get_error(self) -> int:
        self._event.wait()
        return _err(self._error.name) if self._error is not None else 0

    def _extract(self):
        self._event.wait()
        if self._error is not None:
            return _err(self._error.name), None
        return 0, self._value

    def get_value(self):
        """-> (err, present, value) — fdb_future_get_value."""
        err, v = self._extract()
        if err:
            return err, False, None
        return 0, v is not None, v

    def get_key(self):
        """-> (err, key) — fdb_future_get_key."""
        return self._extract()

    def get_keyvalue_array(self):
        """-> (err, kvs, more) — fdb_future_get_keyvalue_array."""
        err, v = self._extract()
        if err:
            return err, None, False
        rows, more = v if isinstance(v, tuple) else (v, False)
        return 0, rows, more

    def get_version(self):
        """-> (err, version) — fdb_future_get_int64 (committed/read version)."""
        return self._extract()


# -- network lifecycle (fdb_c.h:86-101) --

def fdb_select_api_version(version: int) -> int:
    global _selected_version
    with _lock:
        if version > HEADER_API_VERSION:
            return _err("client_invalid_operation")
        if _selected_version is not None and _selected_version != version:
            return _err("client_invalid_operation")  # api_version_already_set
        _selected_version = version
    return 0


def fdb_get_max_api_version() -> int:
    return HEADER_API_VERSION


def fdb_setup_network() -> int:
    global _network
    with _lock:
        if _selected_version is None:
            return _err("client_invalid_operation")  # api_version_unset
        if _network is not None:
            return _err("client_invalid_operation")  # network_already_setup
        _network = _Network()
    return 0


def fdb_run_network() -> int:
    """Blocks; the application calls this from its dedicated network thread."""
    if _network is None:
        return _err("client_invalid_operation")
    _network.run()
    return 0


def fdb_stop_network() -> int:
    if _network is None:
        return _err("client_invalid_operation")
    _network.stop()
    return 0


def _reset_for_tests():
    """Not part of the ABI: lets one process run several networks in tests."""
    global _network, _selected_version
    _network = None
    _selected_version = None


def fdb_get_error(code: int) -> str:
    from foundationdb_tpu_torch.utils.errors import error_name
    return error_name(code)


def fdb_error_predicate(predicate: str, code: int) -> bool:
    """fdb_error_predicate: RETRYABLE / MAYBE_COMMITTED classification."""
    from foundationdb_tpu_torch.utils.errors import is_retryable_code
    if predicate == "RETRYABLE":
        return is_retryable_code(code)
    if predicate == "MAYBE_COMMITTED":
        return code == _err("commit_unknown_result")
    return False


# -- database (fdb_create_database; cluster files collapse to a dict) --

class FDBDatabase:
    def __init__(self, db):
        self._db = db

    def create_transaction(self):
        """fdb_database_create_transaction."""
        return FDBTransaction(self)

    def destroy(self):
        pass


def fdb_create_database(cluster: dict) -> tuple[int, FDBDatabase | None]:
    """-> (err, database). `cluster` is the cluster-file analogue:
    {"coordinators": [...]} for discovery-based clusters or
    {"proxies": [...], "boundaries": [...], "storages": [[addr,...], ...]}
    for statically-wired ones."""
    if _network is None:
        return _err("client_invalid_operation"), None
    holder: dict = {}
    done = threading.Event()

    def build():
        from foundationdb_tpu_torch.client.database import Database, LocationCache
        try:
            if "coordinators" in cluster:
                holder["db"] = Database(
                    _network.transport.process,
                    coordinators=list(cluster["coordinators"]))
            else:
                holder["db"] = Database(
                    _network.transport.process,
                    proxies=list(cluster["proxies"]),
                    locations=LocationCache(
                        [bytes(b) for b in cluster["boundaries"]],
                        [list(t) for t in cluster["storages"]]))
        except Exception as e:  # noqa: BLE001
            holder["err"] = e
        done.set()
    _network._started.wait()
    _network.loop.aio.call_soon_threadsafe(build)
    done.wait()
    if "err" in holder:
        return _err("operation_failed"), None
    return 0, FDBDatabase(holder["db"])


# -- transactions (fdb_transaction_*) --

class FDBTransaction:
    def __init__(self, database: FDBDatabase):
        self._database = database
        self._make()

    def _make(self):
        self._tr = self._database._db.create_transaction()
        self._committed_version = -1

    # reads return FDBFuture handles, like the header

    def set_option(self, option: int, param: bytes | None = None) -> int:
        """fdb_transaction_set_option: the generated option surface
        (utils/fdboptions.py) supplies the codes."""
        try:
            self._tr.set_option(option, param)
        except FDBError as e:
            return _err(e.name)
        return 0

    def get_read_version(self) -> FDBFuture:
        return _network.submit(self._tr.get_read_version(), "capiGRV")

    def set_read_version(self, version: int):
        self._tr.set_read_version(version)

    def get(self, key: bytes, snapshot: bool = False) -> FDBFuture:
        return _network.submit(self._tr.get(key, snapshot=snapshot), "capiGet")

    def get_key(self, key: bytes, or_equal: bool, offset: int,
                snapshot: bool = False) -> FDBFuture:
        from foundationdb_tpu_torch.server.interfaces import KeySelector
        sel = KeySelector(key=key, or_equal=or_equal, offset=offset)
        return _network.submit(self._tr.get_key(sel, snapshot=snapshot),
                               "capiGetKey")

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False, snapshot: bool = False) -> FDBFuture:
        async def run():
            rows = await self._tr.get_range(begin, end, limit=limit,
                                            reverse=reverse,
                                            snapshot=snapshot)
            return rows, False
        return _network.submit(run(), "capiGetRange")

    def watch(self, key: bytes) -> FDBFuture:
        async def run():
            return await self._tr.watch(key)
        return _network.submit(run(), "capiWatch")

    # mutations are immediate, like the header

    def set(self, key: bytes, value: bytes):
        self._tr.set(key, value)

    def clear(self, key: bytes):
        self._tr.clear(key)

    def clear_range(self, begin: bytes, end: bytes):
        self._tr.clear_range(begin, end)

    def atomic_op(self, key: bytes, param: bytes, operation_type: int):
        from foundationdb_tpu_torch.utils.types import MutationType
        self._tr.atomic_op(MutationType(operation_type), key, param)

    def add_conflict_range(self, begin: bytes, end: bytes,
                           conflict_type: str) -> int:
        if conflict_type == "read":
            self._tr.add_read_conflict_range(begin, end)
        elif conflict_type == "write":
            self._tr.add_write_conflict_range(begin, end)
        else:
            return _err("client_invalid_operation")
        return 0

    def commit(self) -> FDBFuture:
        async def run():
            await self._tr.commit()
            self._committed_version = self._tr.committed_version or -1
        return _network.submit(run(), "capiCommit")

    def get_committed_version(self) -> tuple[int, int]:
        """-> (err, version) — only valid after a successful commit."""
        return 0, self._committed_version

    def on_error(self, code: int) -> FDBFuture:
        """fdb_transaction_on_error: resolves ready when the transaction was
        reset for retry, or carries the error when it is not retryable."""
        async def run():
            await self._tr.on_error(FDBError(fdb_get_error(code)))
        return _network.submit(run(), "capiOnError")

    def reset(self):
        self._tr.reset()
        self._committed_version = -1

    def cancel(self):
        self._make()  # a cancelled txn handle is reusable after reset

    def destroy(self):
        pass
