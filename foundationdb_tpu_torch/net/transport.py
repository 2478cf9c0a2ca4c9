"""Real network transport: the FlowTransport equivalent over asyncio TCP.

Reference: fdbrpc/FlowTransport.actor.cpp — endpoints are (address, token)
pairs (:FlowTransport.h:28); the wire carries length-prefixed packets with a
checksum, the first packet on a connection is a ConnectPacket with the
protocol version (:200-214); packets route by token to registered receivers
(deliver :455, scanPackets :487); unknown tokens answer with an ignore marker
so the caller sees broken_promise; one Peer per remote address with a
reconnect loop (:222-308).

The SAME role/client code that runs under the simulator runs here: NetProcess
mirrors SimProcess (register/spawn), NetTransport mirrors SimNetwork
(request/one_way/open_file), and RealEventLoop drives the framework's actors
with real time on top of asyncio. The sim is the test bed; this is the
deployment path.

Wire format (serialize.h's length-prefixed BinaryWriter framing; bodies are
utils/wire.py typed frames — decode builds only registry-whitelisted types,
so a hostile peer can corrupt its own requests but never execute code here):
  u32 length | u64 token | u64 reply_id | u8 kind | crc32c u32 | body
kind: 0 = request, 1 = reply, 2 = reply-error, 3 = one-way.

The port's copy of foundationdb_tpu/net/transport.py. With
NET_NATIVE_TRANSPORT=1 and a compiled extension (the port's own,
native/fdb_native.c), incoming server-side connections are served by the C
data plane (net/native_transport.py): framing, CRC-32C, and the
read-dominant fast-path tokens run in C, and only slow-path frames surface
here as Python objects (net/native_transport.py has the token table and the
fallback contract). With NET_NATIVE_CLIENT=1 requests leave through the C
client plane: one batched encode a peer a loop tick, and a C reply pump.

On the card, RealEventLoop.run_blocking runs the resolver's device readback
(ops/conflict.py `drain_and_collect`) on a worker thread while the loop
thread keeps dispatching: the readback waits on CUDA events and reads pinned
host buffers only, and each handle's result is read after its own event.
"""

from __future__ import annotations

import asyncio
import struct
import time

from foundationdb_tpu_torch.net import native_transport
from foundationdb_tpu_torch.utils import wire

from foundationdb_tpu_torch.core.eventloop import EventLoop, TaskPriority
from foundationdb_tpu_torch.core.future import Future, Promise, settle_many
from foundationdb_tpu_torch.utils.errors import FDBError

_HEADER = struct.Struct(">IQQBI")
# v2: frame checksum moved zlib.crc32 -> CRC-32C (the native plane computes
# Castagnoli in C; both sides must agree or every frame rejects)
PROTOCOL_VERSION = 2
_CONNECT = b"fdbtpu" + bytes([PROTOCOL_VERSION])
# hard bound on a single frame body; frames over this drop the connection
# before the allocation, on both the Python and C paths
_MAX_FRAME_BYTES = native_transport.MAX_FRAME_BYTES

_REQUEST, _REPLY, _REPLY_ERROR, _ONE_WAY = 0, 1, 2, 3


class _ResidueReader:
    """StreamReader shim that replays bytes the native plane had buffered
    when it faulted, then delegates to the real reader — the per-connection
    fallback hands the Python serve loop a mid-stream connection without
    losing the partial frame."""

    def __init__(self, residue: bytes, reader: asyncio.StreamReader):
        self._buf = residue
        self._reader = reader

    async def readexactly(self, n: int) -> bytes:
        if self._buf:
            if len(self._buf) >= n:
                out, self._buf = self._buf[:n], self._buf[n:]
                return out
            need = n - len(self._buf)
            out = self._buf + await self._reader.readexactly(need)
            self._buf = b""
            return out
        return await self._reader.readexactly(n)


def _decode_wire_error(payload) -> FDBError:
    """A _REPLY_ERROR body is either a bare error name (the common case) or
    [name, detail] when the error carries advice the client must see (e.g.
    transaction_throttled's backoff + hot range). Tolerate both shapes from
    any peer version; anything else maps to unknown_error."""
    if isinstance(payload, str):
        return FDBError(payload)
    if (isinstance(payload, (list, tuple)) and len(payload) == 2
            and isinstance(payload[0], str) and isinstance(payload[1], str)):
        return FDBError(payload[0], payload[1])
    return FDBError("unknown_error")


class _WireReplyPromise(Promise):
    """Reply promise for a remote request: the result goes straight to
    wire.dumps, so handlers may send a wire.PreEncoded frame. Class
    attribute (Promise has __slots__); handlers probe it with
    getattr(reply, "wants_bytes", False)."""

    __slots__ = ()
    wants_bytes = True


class RealEventLoop(EventLoop):
    """The framework's event loop driven by real time on asyncio.

    Actors written for the deterministic sim run unchanged: _schedule maps to
    call_later (priorities collapse — real time has no tie-breaking to do),
    now() is the monotonic clock, and run_future pumps asyncio until the
    future resolves.
    """

    def __init__(self):
        super().__init__()
        self.aio = asyncio.new_event_loop()
        self._pool = None  # lazily-built thread pool for run_blocking
        self._ready: list = []  # delay-0 callbacks drained one batch/tick

    def now(self) -> float:
        return time.monotonic()

    def run_blocking(self, fn) -> Future:
        """Run fn() on a worker thread; the loop keeps serving meanwhile.
        Used for device-result readbacks on the commit path — blocking the
        only loop thread on a TPU sync would stall GRV/reads/ingestion."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="fdbtpu-blocking")
        out = Future()

        def resolve(cf):
            e = cf.exception()
            if e is not None:
                out._set_error(e)
            else:
                out._set(cf.result())

        self._pool.submit(fn).add_done_callback(
            lambda cf: self.aio.call_soon_threadsafe(resolve, cf))
        return out

    def _schedule(self, delay: float, priority: int, fn):
        if delay <= 0.0:
            # the hot path: every actor step and future settle reschedules
            # at delay 0 — at bench load that is ~30k/s. One asyncio Handle
            # (alloc + context copy + Context.run) per step is the single
            # largest client-side cost, so delay-0 callbacks park on a
            # plain list and ONE call_soon drains the whole batch. FIFO
            # order among them is preserved (append order); callbacks
            # scheduled during a drain land on the next batch, so asyncio's
            # I/O callbacks are never starved
            self._ready.append(fn)
            if len(self._ready) == 1:
                self.aio.call_soon(self._run_ready)
        else:
            self.aio.call_later(delay, fn)

    def _run_ready(self):
        batch, self._ready = self._ready, []
        for fn in batch:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — match Handle._run
                self.aio.call_exception_handler(
                    {"message": "scheduled callback raised",
                     "exception": e})

    def run_future(self, fut: Future, max_time: float | None = None):
        from foundationdb_tpu_torch.core.eventloop import ActorTask
        if isinstance(fut, ActorTask):
            fut._observed = True
        aio_fut = self.aio.create_future()
        fut.add_callback(lambda f: aio_fut.done() or aio_fut.set_result(None))
        if max_time is not None:
            self.aio.call_later(max_time,
                                lambda: aio_fut.done()
                                or aio_fut.set_result(None))
        self.aio.run_until_complete(aio_fut)
        if not fut.is_ready():
            raise FDBError("timed_out", "run_future hit max_time")
        return fut.get()


class _LocalFile:
    """Durable file on the real filesystem (the sim's SimFile contract)."""

    def __init__(self, path):
        import os
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab+")

    def append(self, data: bytes):
        self._f.write(data)

    def sync(self):
        import os
        self._f.flush()
        os.fsync(self._f.fileno())

    def read_all(self) -> bytes:
        self._f.flush()
        with open(self.path, "rb") as f:
            return f.read()

    def read_range(self, offset: int, length: int) -> bytes:
        """Positioned read (pread) — the redwood engine's block fetch path;
        SimFile deliberately lacks this so sim runs keep whole-image reads
        and the engine caches the image instead."""
        import os
        self._f.flush()
        return os.pread(self._f.fileno(), length, offset)

    def truncate(self):
        self._f.truncate(0)
        self._f.seek(0)

    def truncate_to(self, size: int):
        self._f.flush()
        self._f.truncate(size)


class NetProcess:
    """SimProcess's surface over the real transport: one OS process."""

    def __init__(self, net: "NetTransport", address: str):
        self.net = net
        self.address = address
        self.alive = True
        self.handlers: dict[int, object] = {}
        self.reboots = 0
        self.boot_fn = None
        self.files: dict[str, _LocalFile] = {}

    def spawn(self, coro, name: str = "actor"):
        return self.net.loop.spawn(coro, name=f"{self.address}/{name}")

    def register(self, token: int, handler):
        self.handlers[token] = handler

    def deregister(self, token: int):
        self.handlers.pop(token, None)


class NetTransport:
    """FlowTransport: token-routed request/reply over persistent TCP peers.

    Addresses are "host:port". One listener per transport; one outgoing
    connection per remote peer, re-established on demand (connectionKeeper's
    reconnect-on-failure, without its backoff bookkeeping).
    """

    def __init__(self, loop: RealEventLoop, listen_address: str,
                 data_dir: str | None = None, tls=None):
        self.loop = loop
        self.address = listen_address
        if data_dir is None:
            import tempfile
            data_dir = f"{tempfile.gettempdir()}/fdbtpu"
        self.data_dir = data_dir
        # optional mutual TLS (net/tls.TLSConfig — the FDBLibTLS analogue):
        # both the listener and outgoing peer connections wrap in it, and
        # the verify_peers clauses gate every accepted/established session
        self.tls = tls
        self.process = NetProcess(self, listen_address)
        self.processes = {listen_address: self.process}  # sim-API parity
        self._server = None
        # one Peer per remote address (FlowTransport.actor.cpp:222): the
        # in-flight connect is memoized so concurrent requests share it
        self._peers: dict[str, asyncio.Future] = {}
        # reply_id -> (promise, peer address, timeout TimerHandle | None)
        self._pending: dict[int, tuple] = {}
        self._next_reply_id = 1
        # every asyncio task this transport spawns (reply readers, sends):
        # close() cancels and drains them so teardown never leaks pending
        # tasks ("Task was destroyed but it is pending!")
        self._tasks: set[asyncio.Task] = set()
        # established incoming connections: the listener's close() only stops
        # NEW connections, so these must be dropped explicitly or their
        # _on_connection read loops outlive the transport
        self._incoming: set[asyncio.StreamWriter] = set()
        # transport counters (Python paths; the native plane keeps its own
        # and transport_counters() sums both)
        self._c_frames_in = 0
        self._c_frames_out = 0
        self._c_bytes_in = 0
        self._c_bytes_out = 0
        self._c_checksum_rejects = 0
        self._c_slow_falls = 0
        # the native data plane: one TransportTable per transport, shared by
        # every incoming connection's TransportConn. None = pure Python.
        self.native_table = None
        if native_transport.enabled() and native_transport.available():
            self.native_table = native_transport.new_table()
        # the native CLIENT plane (NET_NATIVE_CLIENT): batched request
        # encode on send, ClientConn reply pump on receive. Independent
        # gate from the server plane — a client can run native against a
        # pure-Python server and vice versa (same wire bytes either way).
        self.native_client = (native_transport.client_enabled()
                              and native_transport.client_available())
        # address -> [(token, reply_id, payload), ...] awaiting the
        # once-per-tick batched encode + single write
        self._send_q: dict[str, list] = {}
        self._c_client_batches = 0
        self._c_client_settles = 0
        self._c_client_py_falls = 0

    def _spawn(self, coro) -> asyncio.Task:
        t = self.loop.aio.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    # -- lifecycle --

    async def _aio_start(self):
        host, port = self.address.rsplit(":", 1)
        # sync callback so the per-connection read loop is OUR tracked task
        # (start_server's own wrapping would bypass _spawn and leak at close)
        self._server = await asyncio.start_server(
            lambda r, w: self._spawn(self._on_connection(r, w)),
            host, int(port),
            ssl=self.tls.server_context() if self.tls else None)

    def start(self):
        self.loop.aio.run_until_complete(self._aio_start())

    def close(self):
        if self._server is not None:
            self._server.close()
        for w in list(self._incoming):
            w.close()
        for t in list(self._tasks):
            t.cancel()
        if self._tasks and not self.loop.aio.is_running():
            # let the cancellations actually run (a cancelled-but-unreaped
            # task still warns at loop GC)
            self.loop.aio.run_until_complete(
                asyncio.gather(*self._tasks, return_exceptions=True))
        for fut in self._peers.values():
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                fut.result().close()

    # -- files (sim open_file parity) --

    def open_file(self, process: NetProcess, name: str):
        if name not in process.files:
            process.files[name] = _LocalFile(
                f"{self.data_dir}/{process.address.replace(':', '_')}/{name}")
        return process.files[name]

    def new_process(self, address: str):  # sim parity for client code
        return self.process

    # -- outgoing --

    def _frame(self, token: int, reply_id: int, kind: int, body: bytes) -> bytes:
        self._c_frames_out += 1
        self._c_bytes_out += _HEADER.size + len(body)
        return native_transport.frame(token, reply_id, kind, body)

    async def _peer(self, address: str) -> asyncio.StreamWriter:
        fut = self._peers.get(address)
        if fut is not None:
            try:
                w = await asyncio.shield(fut)
                if not w.is_closing():
                    return w
            except OSError:
                pass
            if self._peers.get(address) is fut:
                self._peers.pop(address, None)
            return await self._peer(address)
        fut = self.loop.aio.create_future()
        self._peers[address] = fut
        try:
            host, port = address.rsplit(":", 1)
            _r, w = await asyncio.open_connection(
                host, int(port),
                ssl=self.tls.client_context() if self.tls else None)
            if self.tls is not None and not self._peer_ok(w):
                w.close()
                raise OSError("peer failed verify_peers")
        except OSError as e:
            self._peers.pop(address, None)
            fut.set_exception(e)
            raise
        w.write(_CONNECT)
        fut.set_result(w)
        if self.native_client:
            self._spawn(self._native_read_replies(_r, address))
        else:
            self._spawn(self._read_replies(_r, address))
        return w

    def request(self, src, dest, payload, priority: int = 0,
                timeout: float | None = -1.0) -> Future:
        """Endpoint request with a network-traversing reply promise
        (fdbrpc.h:99 ReplyPromise)."""
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        if dest.address == self.address:
            # local endpoint: direct in-memory delivery, no serialization —
            # the reference's RequestStream::send does exactly this for
            # non-remote endpoints (fdbrpc/fdbrpc.h: send delivers into the
            # local queue; only remote endpoints hit FlowTransport). Roles
            # co-hosted in one process (proxy+master+resolver+tlog) pay no
            # codec on the commit pipeline's internal hops.
            return self._local_request(dest, payload, timeout)
        reply = Promise()
        if timeout == -1.0:
            timeout = KNOBS.SIM_RPC_TIMEOUT_SECONDS
        reply_id = self._next_reply_id
        self._next_reply_id += 1
        handle = None
        if timeout is not None:
            def expire():
                entry = self._pending.pop(reply_id, None)
                if entry is not None and not entry[0].is_set():
                    entry[0].send_error(FDBError("request_maybe_delivered"))
            handle = self.loop.aio.call_later(timeout, expire)
        self._pending[reply_id] = (reply, dest.address, handle)

        peer = self._peers.get(dest.address)
        if peer is not None and peer.done() and not peer.cancelled() \
                and peer.exception() is None \
                and not peer.result().is_closing():
            # connected fast path: encode + write inline. No coroutine, no
            # task, no drain await — the transport's write buffer provides
            # the slack, and a dropped connection fails every pending
            # request via _read_replies. This is the per-request hot path
            # for a client under load (every GRV/read/commit lands here
            # once the proxy connection exists).
            if self.native_client:
                # native client plane: park the request; the first parker
                # schedules a same-tick flush that batch-encodes + writes
                # every request bound for this peer in ONE C call
                q = self._send_q.get(dest.address)
                if q is None:
                    q = self._send_q[dest.address] = []
                    self.loop.aio.call_soon(self._flush_sends, dest.address,
                                            peer.result())
                q.append((dest.token, reply_id, payload))
                return reply.future
            try:
                body = wire.dumps(payload)
                peer.result().write(
                    self._frame(dest.token, reply_id, _REQUEST, body))
            except (OSError, wire.WireError) as e:
                if isinstance(e, OSError):
                    self._peers.pop(dest.address, None)
                self._fail_pending(reply_id, "encode/write failed", dest, e)
            return reply.future

        async def send():
            try:
                body = wire.dumps(payload)
                w = await self._peer(dest.address)
                w.write(self._frame(dest.token, reply_id, _REQUEST, body))
                await w.drain()
            except (OSError, wire.WireError) as e:
                if isinstance(e, OSError):
                    self._peers.pop(dest.address, None)
                self._fail_pending(reply_id, "connect/encode failed", dest, e)

        self._spawn(send())
        return reply.future

    def _flush_sends(self, address: str, writer) -> None:
        """Drain the parked requests for one peer: one batched C encode,
        one socket write. Scheduled by the first request parked in a tick,
        so every read/GRV issued in the same loop iteration shares the
        call. Falls back to the per-request Python encoder when any
        payload has no native fast path (the whole-batch OverflowError
        contract of transport_client_encode)."""
        items = self._send_q.pop(address, None)
        if not items:
            return
        try:
            buf = native_transport.encode_batch(items)
        except Exception:  # noqa: BLE001 — unsupported payload / native
            # fault: re-run each request through the Python path, which
            # stays the semantic authority (and fails bad payloads
            # per-request instead of per-batch)
            self._c_client_py_falls += len(items)
            for token, reply_id, payload in items:
                try:
                    writer.write(self._frame(token, reply_id, _REQUEST,
                                             wire.dumps(payload)))
                except (OSError, wire.WireError) as e:
                    if isinstance(e, OSError):
                        self._peers.pop(address, None)
                    self._fail_pending(reply_id, "encode/write failed",
                                       None, e)
            return
        self._c_client_batches += 1
        self._c_frames_out += len(items)
        self._c_bytes_out += len(buf)
        try:
            writer.write(buf)
        except OSError as e:
            self._peers.pop(address, None)
            for _token, reply_id, _payload in items:
                self._fail_pending(reply_id, "write failed", None, e)

    def _fail_pending(self, reply_id: int, detail: str, dest=None,
                      cause: BaseException | None = None):
        entry = self._pending.pop(reply_id, None)
        if entry is None:
            return
        if entry[2] is not None:
            entry[2].cancel()
        if dest is not None:
            # name the endpoint: a bare "connect/encode failed" in a log of
            # thousands of requests is uncorrelatable with the actor that
            # wedged on it (import deferred — server.interfaces must stay
            # free to import net)
            from foundationdb_tpu_torch.server.interfaces import token_name
            detail = f"{detail}: {token_name(dest.token)} -> {dest.address}"
        if cause is not None:
            detail = f"{detail} ({type(cause).__name__}: {cause})"
        if not entry[0].is_set():
            entry[0].send_error(FDBError("broken_promise", detail))

    def _local_request(self, dest, payload, timeout) -> Future:
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        reply = Promise()
        if timeout == -1.0:
            timeout = KNOBS.SIM_RPC_TIMEOUT_SECONDS
        handle = None
        if timeout is not None:
            # cancel on completion: this is the hottest path in a co-hosted
            # pipeline, and an uncancelled 5s TimerHandle per request would
            # retain payloads and churn the timer heap
            handle = self.loop.aio.call_later(
                timeout,
                lambda: reply.send_error(FDBError("request_maybe_delivered"))
                if not reply.is_set() else None)

        def finish(err=None, value=None):
            if handle is not None:
                handle.cancel()
            if reply.is_set():
                return
            if err is not None:
                reply.send_error(err)
            else:
                reply.send(value)

        def deliver():
            handler = self.process.handlers.get(dest.token)
            if handler is None:
                finish(err=FDBError("broken_promise"))
                return
            inner = Promise()

            def on_reply(f: Future):
                if f.is_error():
                    finish(err=f._result)
                else:
                    finish(value=f._result)
            inner.future.add_callback(on_reply)
            try:
                handler(payload, inner)
            except Exception:  # noqa: BLE001 — parity with remote dispatch:
                # a raising handler must answer, not strand the caller
                finish(err=FDBError("unknown_error"))

        self.loop._schedule(0.0, 0, deliver)  # keep the async boundary
        return reply.future

    def one_way(self, src, dest, payload):
        if dest.address == self.address:
            def deliver():
                handler = self.process.handlers.get(dest.token)
                if handler is not None:
                    try:
                        handler(payload, Promise())
                    except Exception:  # noqa: BLE001 — one-way = dropped
                        pass
            self.loop._schedule(0.0, 0, deliver)
            return

        async def send():
            try:
                body = wire.dumps(payload)
                w = await self._peer(dest.address)
                w.write(self._frame(dest.token, 0, _ONE_WAY, body))
                await w.drain()
            except wire.WireError:
                pass  # unserializable one-way == dropped packet
            except OSError:
                self._peers.pop(dest.address, None)
        self._spawn(send())

    # -- incoming --

    async def _read_raw_frame(self, reader):
        """Header + body, bounds-checked and counted — but NOT verified:
        callers that can prove the frame is dead (a reply whose request
        already expired) skip the checksum instead of burning event-loop
        time on bytes nobody will read."""
        header = await reader.readexactly(_HEADER.size)
        length, token, reply_id, kind, crc = _HEADER.unpack(header)
        if length > _MAX_FRAME_BYTES:
            raise ConnectionError("oversized frame")
        body = await reader.readexactly(length)
        self._c_frames_in += 1
        self._c_bytes_in += _HEADER.size + length
        return token, reply_id, kind, crc, body

    def _verify_and_load(self, crc: int, body: bytes):
        if native_transport.crc32c(body) != crc:
            self._c_checksum_rejects += 1
            raise ConnectionError("packet checksum mismatch")
        try:
            return wire.loads(body)
        except wire.WireError as e:
            # undecodable frame: the stream is garbage or hostile — drop the
            # connection (peers reconnect; in-flight requests get
            # broken_promise from the reply-reader's cleanup)
            raise ConnectionError(f"bad wire frame: {e}") from e

    async def _read_frame(self, reader):
        token, reply_id, kind, crc, body = await self._read_raw_frame(reader)
        return token, reply_id, kind, self._verify_and_load(crc, body)

    def _peer_ok(self, writer) -> bool:
        """Apply the TLS verify_peers clauses to the session's peer cert
        (FDBLibTLSSession::verify_peer)."""
        sslobj = writer.get_extra_info("ssl_object")
        cert = sslobj.getpeercert() if sslobj is not None else None
        return self.tls.check_peer(cert)

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        self._incoming.add(writer)
        try:
            if self.tls is not None and not self._peer_ok(writer):
                writer.close()
                return
            connect = await reader.readexactly(len(_CONNECT))
            if connect != _CONNECT:
                writer.close()  # protocol mismatch (ConnectPacket check :206)
                return
            if self.native_table is not None:
                residue = await self._native_serve(reader, writer)
                if residue is None:
                    return
                # native plane fault on THIS connection: degrade to the
                # Python loop, replaying whatever the plane had buffered
                reader = _ResidueReader(residue, reader)
            await self._python_serve(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return
        finally:
            self._incoming.discard(writer)
            # the serve loop only exits on EOF or a protocol reject — in
            # both cases the drop decision must reach the TCP layer, or a
            # rejected peer hangs on recv() instead of seeing the close
            writer.close()

    async def _python_serve(self, reader, writer):
        """The pure-Python serve loop — the pre-native path, and the
        fallback target when the native plane degrades a connection."""
        while True:
            token, reply_id, kind, payload = await self._read_frame(reader)
            self._c_slow_falls += 1
            try:
                self._dispatch(token, reply_id, kind, payload, writer)
            except Exception:  # noqa: BLE001 — a bad handler/payload
                # must not kill the connection's read loop (every later
                # packet from this peer would silently hang otherwise)
                if kind == _REQUEST:
                    writer.write(self._frame(0, reply_id, _REPLY_ERROR,
                                             wire.dumps("unknown_error")))

    async def _native_serve(self, reader, writer):
        """Serve this connection through the C data plane. Returns None
        when the connection is done (EOF; protocol rejects raise), or the
        plane's buffered residue when it faulted and the Python loop must
        take over mid-stream (the per-connection fallback contract)."""
        conn = native_transport.new_conn(self.native_table)
        while True:
            chunk = await reader.read(262144)
            if not chunk:
                return None  # clean EOF
            try:
                replies, slow, err = conn.feed(chunk)
            except Exception:  # noqa: BLE001 — any native-plane fault
                # (alloc failure, internal invariant trip) downgrades just
                # this connection; correctness comes from the Python loop
                try:
                    residue = conn.residue()
                except Exception:  # noqa: BLE001
                    residue = b""
                return residue
            if replies is not None:
                writer.write(replies)
            for token, reply_id, kind, body in slow:
                try:
                    payload = wire.loads(body)
                except wire.WireError as e:
                    raise ConnectionError(f"bad wire frame: {e}") from e
                try:
                    self._dispatch(token, reply_id, kind, payload, writer)
                except Exception:  # noqa: BLE001 — parity with the
                    # Python loop: a raising handler answers, not hangs
                    if kind == _REQUEST:
                        writer.write(self._frame(
                            0, reply_id, _REPLY_ERROR,
                            wire.dumps("unknown_error")))
            if err is not None:
                # protocol reject (checksum mismatch / oversized frame):
                # same decision as the Python loop — drop the connection.
                # Replies queued earlier in this chunk were already written.
                raise ConnectionError(err)

    def transport_counters(self) -> dict:
        """Cumulative transport counters: Python paths + native plane."""
        c = {
            "FramesIn": self._c_frames_in,
            "FramesOut": self._c_frames_out,
            "BytesIn": self._c_bytes_in,
            "BytesOut": self._c_bytes_out,
            "ChecksumRejects": self._c_checksum_rejects,
            "NativeFastPathHits": 0,
            "PySlowPathFalls": self._c_slow_falls,
            "ClientNativeBatches": self._c_client_batches,
            "ClientNativeSettles": self._c_client_settles,
            "ClientPyFalls": self._c_client_py_falls,
        }
        if self.native_table is not None:
            for k, v in self.native_table.counters().items():
                c[k] = c.get(k, 0) + v
        return c

    def _dispatch(self, token, reply_id, kind, payload, writer):
        handler = self.process.handlers.get(token)
        if handler is None:
            # TOKEN_IGNORE path: tell the caller its promise is broken
            if kind == _REQUEST:
                writer.write(self._frame(0, reply_id, _REPLY_ERROR,
                                         wire.dumps("broken_promise")))
            return
        # A remote request's reply is headed for wire.dumps either way, so
        # the handler may answer with a wire.PreEncoded frame (the storage
        # C read path) — signaled by wants_bytes on the reply promise.
        # In-process requests (_local_request) hand the payload object to
        # the caller directly and never take this path.
        inner = _WireReplyPromise() if kind == _REQUEST else Promise()
        if kind == _REQUEST:
            def on_reply(f: Future):
                try:
                    if f.is_error():
                        name = getattr(f._result, "name", "unknown_error")
                        detail = getattr(f._result, "detail", "")
                        # detail must survive the wire: transaction_throttled
                        # carries the advised backoff + hot range in it, and
                        # a client that loses it falls back to blind jitter
                        body = wire.dumps([name, detail] if detail else name)
                        writer.write(self._frame(0, reply_id, _REPLY_ERROR, body))
                    else:
                        try:
                            body = wire.dumps(f._result)
                        except wire.WireError:
                            writer.write(self._frame(
                                0, reply_id, _REPLY_ERROR,
                                wire.dumps("unknown_error")))
                            return
                        writer.write(self._frame(0, reply_id, _REPLY, body))
                except OSError:
                    pass
            inner.future.add_callback(on_reply)
        handler(payload, inner)

    async def _read_replies(self, reader: asyncio.StreamReader, address: str):
        try:
            while True:
                _token, reply_id, kind, crc, body = \
                    await self._read_raw_frame(reader)
                entry = self._pending.pop(reply_id, None)
                if entry is None:
                    # retransmit-dedup hit: the request already completed or
                    # expired, so nobody will read this body — skip the
                    # checksum + decode instead of recomputing CRC-32C on
                    # the event loop for a frame that gets dropped anyway
                    continue
                if entry[2] is not None:
                    entry[2].cancel()  # drop the RPC-timeout timer now
                if entry[0].is_set():
                    continue
                try:
                    payload = self._verify_and_load(crc, body)
                except ConnectionError:
                    # the entry was already popped: fail it here, then let
                    # the outer handler fail the rest + drop the peer
                    if not entry[0].is_set():
                        entry[0].send_error(
                            FDBError("broken_promise", "peer closed"))
                    raise
                if kind == _REPLY:
                    entry[0].send(payload)
                elif kind == _REPLY_ERROR:
                    entry[0].send_error(_decode_wire_error(payload))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            # fail every in-flight request on this connection NOW (the peer-
            # failure path of FlowTransport): waiting out the RPC timeout
            # stalls failover, and timeout=None waiters would leak forever
            self._fail_peer(address)
            return

    def _fail_peer(self, address: str) -> None:
        """Drop a peer and fail every in-flight request bound to it."""
        self._peers.pop(address, None)
        for rid in [r for r, (_p, a, _h) in self._pending.items()
                    if a == address]:
            p, _a, h = self._pending.pop(rid)
            if h is not None:
                h.cancel()
            if not p.is_set():
                p.send_error(FDBError("broken_promise", "peer closed"))

    async def _native_read_replies(self, reader: asyncio.StreamReader,
                                   address: str):
        """The native client reply pump: ClientConn.feed parses + decodes
        every complete frame in a socket read in C, and _settle_batch
        resolves all their futures from the one returned batch — one
        Python call per read instead of two readexactly awaits plus a
        header unpack + CRC + wire.loads per frame. Faults degrade this
        connection to _read_replies mid-stream via _ResidueReader, the
        same per-connection contract as the server plane."""
        conn = native_transport.new_client_conn()
        if conn is None:  # symbols probed away: pure-Python loop
            await self._read_replies(reader, address)
            return
        while True:
            try:
                chunk = await reader.read(262144)
            except (ConnectionError, OSError):
                self._fail_peer(address)
                return
            if not chunk:
                self._fail_peer(address)  # EOF
                return
            try:
                entries, err = conn.feed(chunk)
            except Exception:  # noqa: BLE001 — native fault: degrade this
                # connection to the Python reply loop, replaying whatever
                # the pump had buffered
                try:
                    residue = conn.residue()
                except Exception:  # noqa: BLE001
                    residue = b""
                await self._read_replies(_ResidueReader(residue, reader),
                                         address)
                return
            self._c_client_batches += 1
            self._c_frames_in += len(entries)
            self._c_bytes_in += len(chunk)
            try:
                self._settle_batch(entries)
            except ConnectionError:
                self._fail_peer(address)
                return
            if err is not None:
                # protocol reject (checksum mismatch / oversized frame):
                # entries before the reject already settled, matching the
                # Python loop's sequential order — now drop the peer
                self._c_checksum_rejects += err == "packet checksum mismatch"
                self._fail_peer(address)
                return

    def _settle_batch(self, entries) -> None:
        """Settle every future carried by one ClientConn.feed batch, in
        frame order, in this loop tick. Entries whose body needed the
        Python codec arrive as raw bytes (ClientPyFalls); an undecodable
        raw body means the stream is garbage — fail that future and drop
        the connection, the _verify_and_load decision."""
        settlements = []
        for reply_id, kind, payload, raw in entries:
            entry = self._pending.pop(reply_id, None)
            if entry is None:
                continue  # request already completed or expired
            if entry[2] is not None:
                entry[2].cancel()  # drop the RPC-timeout timer now
            if entry[0].is_set():
                continue
            if raw is not None:
                self._c_client_py_falls += 1
                try:
                    payload = wire.loads(raw)
                except wire.WireError as e:
                    entry[0].send_error(
                        FDBError("broken_promise", "peer closed"))
                    raise ConnectionError(f"bad wire frame: {e}") from e
            if kind == _REPLY:
                settlements.append((entry[0], payload, None))
            elif kind == _REPLY_ERROR:
                settlements.append(
                    (entry[0], None, _decode_wire_error(payload)))
        self._c_client_settles += len(settlements)
        settle_many(settlements)
