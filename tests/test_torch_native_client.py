"""Native client plane: batched C request encoder + ClientConn reply pump
vs the pure-Python client paths.

The port's copy of tests/test_native_client.py (its PROTO005 cases,
which test the JAX tree's analyser, left out), run on the port's own C
extension. Three-way parity contract: (1) batch encode —
`native_transport.py_encode_batch` (pure Python), the C
`transport_client_encode`, and the concatenation of per-request
`py_frame(token, reply_id, _REQUEST, wire.dumps(payload))` bytes are all
identical, so a server cannot tell which encoder a client ran; (2) reply
pump — `ClientConn.feed` splits any byte stream (torn, corrupted,
oversized, undecodable, mixed-kind) into exactly the entries a reference
Python pump predicts, with identical reject decisions, identical residue,
and raw-bytes fallback wherever the C decoder declines (so Python's
wire.loads stays the semantic authority); (3) settlement — the transport's
_settle_batch resolves futures, cancels RPC timers, and degrades
mid-stream identically to the pure-Python reply loop.

The module skips only where there is no C compiler; with one, the port's
extension must build and carry the client plane.
"""

import os
import random
import shutil
import struct

import pytest

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.net import native_transport as nt
from foundationdb_tpu_torch.server import interfaces as si
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.knobs import KNOBS

HAVE_CC = shutil.which(os.environ.get("CC", "cc")) is not None
pytestmark = pytest.mark.skipif(
    not HAVE_CC, reason="no C compiler: the port's extension cannot be built")


@pytest.fixture(autouse=True)
def _port_knobs(monkeypatch):
    """The port's knobs reset around each test (the conftest resets only
    the JAX package's), and the native gates' variables unset."""
    monkeypatch.delenv("NET_NATIVE_TRANSPORT", raising=False)
    monkeypatch.delenv("NET_NATIVE_CLIENT", raising=False)
    KNOBS.reset()
    yield
    KNOBS.reset()

_REQUEST, _REPLY, _REPLY_ERROR, _ONE_WAY = 0, 1, 2, 3


# -- (1) batch encode parity --------------------------------------------------

def _rand_value(rng, depth=0):
    shape = rng.randrange(9 if depth < 2 else 7)
    if shape == 0:
        return None
    if shape == 1:
        return rng.random() < 0.5
    if shape == 2:  # stay within the 64-bit zigzag both codecs share
        return rng.randrange(-(1 << 60), 1 << 60)
    if shape == 3:
        return rng.uniform(-1e9, 1e9)
    if shape == 4:
        return bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
    if shape == 5:
        return "".join(chr(rng.randrange(32, 0x2FF))
                       for _ in range(rng.randrange(0, 12)))
    if shape == 6:
        return tuple(_rand_value(rng, depth + 1)
                     for _ in range(rng.randrange(0, 4)))
    if shape == 7:
        return [_rand_value(rng, depth + 1)
                for _ in range(rng.randrange(0, 4))]
    return {rng.randrange(100): _rand_value(rng, depth + 1)
            for _ in range(rng.randrange(0, 3))}


def _rand_selector(rng) -> si.KeySelector:
    return si.KeySelector(key=bytes(rng.randrange(256)
                                    for _ in range(rng.randrange(0, 8))),
                          or_equal=rng.random() < 0.5,
                          offset=rng.randrange(-3, 4))


def _rand_request(rng):
    """One of the four hot-token request payloads the encoder exists for."""
    shape = rng.randrange(4)
    if shape == 0:
        return si.GetValueRequest(
            key=b"k%d" % rng.randrange(1000), version=rng.randrange(1 << 40))
    if shape == 1:
        return si.GetValuesRequest(
            reads=[(b"k%d" % rng.randrange(1000), rng.randrange(1 << 40))
                   for _ in range(rng.randrange(1, 6))])
    if shape == 2:
        return si.GetKeyValuesRequest(
            begin=_rand_selector(rng), end=_rand_selector(rng),
            version=rng.randrange(1 << 40), limit=rng.randrange(0, 100),
            limit_bytes=rng.randrange(0, 10**6), reverse=rng.random() < 0.5)
    return si.GetReadVersionRequest(
        priority=rng.randrange(3),
        debug_id=None if rng.random() < 0.5 else "grv-%x" % rng.getrandbits(32))


def fuzz_encode_parity(seed: int, iters: int = 80):
    """C batch encoder == Python batch encoder == per-request frame
    concatenation, bit for bit, over hot-token requests and arbitrary
    wire-encodable payloads."""
    rng = random.Random(seed)
    for _ in range(iters):
        items = []
        for _i in range(rng.randrange(1, 9)):
            payload = (_rand_request(rng) if rng.random() < 0.6
                       else _rand_value(rng))
            items.append((rng.getrandbits(64), rng.getrandbits(64), payload))
        got = nt.encode_batch(items)
        assert got == nt.py_encode_batch(items)
        assert got == b"".join(
            nt.py_frame(tok, rid, _REQUEST, wire.dumps(p))
            for tok, rid, p in items)


def test_encode_parity_fuzz():
    for seed in (41, 42):
        fuzz_encode_parity(seed)


def test_encode_unsupported_payload_raises_for_whole_batch():
    """The fallback signal: a payload only the Python codec can express
    (>64-bit int) makes the C encoder raise instead of guessing — and the
    Python encoder (the fallback target) still handles it."""
    items = [(40, 1, si.GetValueRequest(key=b"k", version=1)),
             (40, 2, 1 << 70)]
    with pytest.raises(OverflowError):
        nt.encode_batch(items)
    buf = nt.py_encode_batch(items)
    assert buf.startswith(nt.py_frame(
        40, 1, _REQUEST, wire.dumps(si.GetValueRequest(key=b"k", version=1))))


def test_encode_rejects_malformed_items():
    with pytest.raises(TypeError):
        nt.encode_batch([(1, 2)])  # not a 3-tuple
    with pytest.raises(TypeError):
        nt.encode_batch(7)  # not a sequence


# -- (2) reply pump parity ----------------------------------------------------

def _frames_with_expectations(rng):
    """A random reply stream as (frames, expected_err): frames is a list of
    (frame_bytes, expected_entry_or_None) pairs — each frame is generated
    WITH its expected ClientConn entry, so the parity check pins the C
    decode-vs-raw-fallback decision, not just frame splitting. The last
    frame carries expected_entry None when it is a protocol reject."""
    frames, err = [], None
    for _f in range(rng.randrange(1, 7)):
        rid = rng.getrandbits(64)
        shape = rng.randrange(8)
        if shape == 0:  # decodable reply object
            payload = si.GetValueReply(
                value=None if rng.random() < 0.3 else b"v%d" % rng.randrange(99),
                version=rng.randrange(1 << 40))
            frames.append((nt.py_frame(0, rid, _REPLY, wire.dumps(payload)),
                           (rid, _REPLY, payload, None)))
        elif shape == 1:  # decodable plain value
            payload = _rand_value(rng)
            frames.append((nt.py_frame(0, rid, _REPLY, wire.dumps(payload)),
                           (rid, _REPLY, payload, None)))
        elif shape == 2:  # error reply: bare name or [name, detail]
            payload = ("transaction_too_old" if rng.random() < 0.5
                       else ["transaction_throttled", "backoff=0.05"])
            frames.append((nt.py_frame(0, rid, _REPLY_ERROR,
                                       wire.dumps(payload)),
                           (rid, _REPLY_ERROR, payload, None)))
        elif shape == 3:  # non-reply kind: never decoded, raw passthrough
            kind = rng.choice((_REQUEST, _ONE_WAY, rng.randrange(4, 256)))
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 30)))
            frames.append((nt.py_frame(0, rid, kind, body),
                           (rid, kind, None, body)))
        elif shape == 4:  # reply body without the wire magic: raw fallback
            body = bytes([rng.randrange(256) & ~0x01])  # != 0xF5
            body += bytes(rng.randrange(256)
                          for _ in range(rng.randrange(0, 20)))
            frames.append((nt.py_frame(0, rid, _REPLY, body),
                           (rid, _REPLY, None, body)))
        elif shape == 5:  # decodable value + trailing junk: raw fallback
            body = wire.dumps(rng.randrange(100)) + b"\x00"
            frames.append((nt.py_frame(0, rid, _REPLY, body),
                           (rid, _REPLY, None, body)))
        elif shape == 6:  # >64-bit varint: C declines, Python authority
            body = wire._py_dumps(1 << 70)
            frames.append((nt.py_frame(0, rid, _REPLY, body),
                           (rid, _REPLY, None, body)))
        else:  # protocol rejects end the stream
            frame = nt.py_frame(0, rid, _REPLY, b"xy")
            if rng.random() < 0.5:
                i = rng.randrange(nt.HEADER_LEN - 4, len(frame))
                frame = frame[:i] + bytes([frame[i] ^ 0x20]) + frame[i + 1:]
                err = "packet checksum mismatch"
            else:
                frame = struct.pack(
                    ">I", nt.MAX_FRAME_BYTES + rng.randrange(1, 1 << 20)) \
                    + frame[4:]
                err = "oversized frame"
            frames.append((frame, None))
            break
    return frames, err


def _feed_chunked(conn, data: bytes, rng):
    """Feed a ClientConn in random-size chunks; accumulate (entries, err),
    stopping at the first err (dead-latch contract)."""
    entries, pos = [], 0
    while pos < len(data):
        n = rng.randrange(1, max(2, len(data) - pos + 1))
        got, err = conn.feed(data[pos:pos + n])
        entries.extend(got)
        if err is not None:
            return entries, err
        pos += n
    return entries, None


def fuzz_reply_pump_parity(seed: int, streams: int = 40):
    """ClientConn.feed under random chunking produces exactly the
    entries/reject/residue the generator predicted: decoded payloads where
    the C codec covers the body, raw-bytes fallback where it declines,
    in-band err at the first protocol reject."""
    rng = random.Random(seed)
    for _ in range(streams):
        frames, want_err = _frames_with_expectations(rng)
        data = b"".join(fb for fb, _e in frames)
        expected = [e for _fb, e in frames if e is not None]
        if want_err is None and rng.random() < 0.5:  # torn tail
            want_err = None
            data = data[:max(0, len(data) - rng.randrange(1, 30))]
            expected, consumed = [], 0
            for fb, e in frames:
                if consumed + len(fb) > len(data):
                    break
                expected.append(e)
                consumed += len(fb)
            want_residue = data[consumed:]
        else:
            want_residue = b"" if want_err is None else None
        conn = nt.new_client_conn()
        got, err = _feed_chunked(conn, data, rng)
        assert err == want_err
        assert got == expected
        if want_err is None:
            assert conn.residue() == want_residue


def test_reply_pump_parity_fuzz():
    for seed in (43, 44):
        fuzz_reply_pump_parity(seed)


def test_pump_error_reply_with_detail_decodes():
    body = wire.dumps(["transaction_throttled", "backoff=0.1 hot=k7"])
    conn = nt.new_client_conn()
    entries, err = conn.feed(nt.py_frame(0, 9, _REPLY_ERROR, body))
    assert err is None
    assert entries == [(9, _REPLY_ERROR,
                        ["transaction_throttled", "backoff=0.1 hot=k7"], None)]


def test_pump_dead_latch_and_residue():
    conn = nt.new_client_conn()
    good = nt.py_frame(0, 1, _REPLY, wire.dumps("ok"))
    bad = nt.py_frame(0, 2, _REPLY, b"body")
    bad = bad[:-1] + bytes([bad[-1] ^ 1])
    entries, err = conn.feed(good + bad)
    assert entries == [(1, _REPLY, "ok", None)]
    assert err == "packet checksum mismatch"
    with pytest.raises(ValueError):
        conn.feed(b"more")
    # torn-tail residue on a healthy conn
    conn2 = nt.new_client_conn()
    frame = nt.py_frame(0, 3, _REPLY, wire.dumps(None))
    entries, err = conn2.feed(frame + frame[:10])
    assert err is None and len(entries) == 1
    assert conn2.residue() == frame[:10]


# -- (3) transport settlement -------------------------------------------------

def _free_addr():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


class _SinkWriter:
    """Writer double for the request fast path: collects bytes."""

    def __init__(self):
        self.chunks = []

    def write(self, data):
        self.chunks.append(bytes(data))

    def is_closing(self):
        return False

    def close(self):
        pass


def test_burst_settles_and_cancels_every_timer(monkeypatch):
    """Satellite 1 regression: after a 1k-read burst settles through the
    native reply pump, ZERO request-timeout TimerHandles may remain live —
    each must be cancelled at settlement, not left to expire (1k live 5s
    timers per burst is pure timer-heap churn retaining payloads)."""
    import asyncio

    monkeypatch.setenv("NET_NATIVE_CLIENT", "1")
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net import transport as T

    loop = T.RealEventLoop()
    t = T.NetTransport(loop, "127.0.0.1:1")  # never started: no sockets
    assert t.native_client
    addr = "10.0.0.9:4000"
    w = _SinkWriter()
    peer = loop.aio.create_future()
    peer.set_result(w)
    t._peers[addr] = peer

    n = 1000
    futs = [t.request(t.process, Endpoint(addr, si.Token.STORAGE_GET_VALUE),
                      si.GetValueRequest(key=b"k%d" % i, version=7),
                      timeout=30.0)
            for i in range(n)]
    replies = b"".join(
        nt.py_frame(0, rid, _REPLY,
                    wire.dumps(si.GetValueReply(value=b"v%d" % rid,
                                                version=7)))
        for rid in range(1, n + 1))

    async def pump():
        r = asyncio.StreamReader()
        r.feed_data(replies)
        r.feed_eof()
        await t._native_read_replies(r, addr)

    loop.aio.run_until_complete(pump())

    assert all(f.is_ready() and not f.is_error() for f in futs)
    assert futs[0].get().value == b"v1"
    assert futs[-1].get().value == b"v%d" % n
    # the batched encode actually ran (one C call, no per-request frames)
    assert t._c_client_py_falls == 0
    c = t.transport_counters()
    assert c["ClientNativeBatches"] >= 2  # >=1 send flush + >=1 feed batch
    assert c["ClientNativeSettles"] == n
    assert b"".join(w.chunks) == nt.py_encode_batch(
        [(si.Token.STORAGE_GET_VALUE, i + 1,
          si.GetValueRequest(key=b"k%d" % i, version=7)) for i in range(n)])
    # no live timer handles after settlement
    live = [h for h in loop.aio._scheduled if not h._cancelled]
    assert live == []
    assert not t._pending


def test_settle_batch_routes_errors_and_raw_fallback():
    """_settle_batch: error entries settle as FDBError (detail preserved),
    raw entries decode through Python (ClientPyFalls), dedup'd reply_ids
    are skipped, and an undecodable raw body fails its future AND drops
    the connection."""
    from foundationdb_tpu_torch.core.future import Promise
    from foundationdb_tpu_torch.net import transport as T

    loop = T.RealEventLoop()
    t = T.NetTransport(loop, "127.0.0.1:1")
    ok, err_p, raw_p = Promise(), Promise(), Promise()
    t._pending[1] = (ok, "a:1", None)
    t._pending[2] = (err_p, "a:1", None)
    t._pending[3] = (raw_p, "a:1", None)
    t._settle_batch([
        (1, T._REPLY, "value", None),
        (2, T._REPLY_ERROR, ["transaction_throttled", "backoff=0.2"], None),
        (3, T._REPLY, None, wire.dumps(1 << 70)),  # only Python decodes
        (99, T._REPLY, "dropped", None),  # no pending entry: dedup skip
    ])
    assert ok.future.get() == "value"
    e = err_p.future._result
    assert (e.name, e.detail) == ("transaction_throttled", "backoff=0.2")
    assert raw_p.future.get() == 1 << 70
    assert t._c_client_py_falls == 1
    assert t._c_client_settles == 3

    bad = Promise()
    t._pending[4] = (bad, "a:1", None)
    with pytest.raises(ConnectionError):
        t._settle_batch([(4, T._REPLY, None, b"\xf5\x01garbage")])
    assert bad.future.is_error()
    assert bad.future._result.name == "broken_promise"


def test_native_client_over_real_wire_and_ablation(monkeypatch):
    """End-to-end: a NET_NATIVE_CLIENT=1 client against a pure-Python
    server — values, error replies with detail, and counters — then the
    same calls with the plane off must return identical results (the
    bench's ablation contract)."""
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    def run(native_on: str):
        monkeypatch.setenv("NET_NATIVE_CLIENT", native_on)
        loop = RealEventLoop()
        srv = NetTransport(loop, _free_addr())
        cli = NetTransport(loop, _free_addr())
        srv.start()
        cli.start()
        try:
            assert cli.native_client == (native_on == "1")
            from foundationdb_tpu_torch.utils.errors import FDBError

            def on_gvs(req, reply):
                reply.send(si.GetValuesReply(
                    results=[(0, b"=" + k) for k, _v in req.reads]))

            def on_throttle(_req, reply):
                reply.send_error(
                    FDBError("transaction_throttled", "backoff=0.25"))
            srv.process.register(si.Token.STORAGE_GET_VALUES, on_gvs)
            srv.process.register(99, on_throttle)

            async def calls():
                gvs = await cli.request(
                    cli.process,
                    Endpoint(srv.address, si.Token.STORAGE_GET_VALUES),
                    si.GetValuesRequest(reads=[(b"a", 1), (b"b", 1)]))
                try:
                    await cli.request(cli.process,
                                      Endpoint(srv.address, 99), None)
                    raise AssertionError("error reply did not raise")
                except FDBError as e:
                    thr = (e.name, e.detail)
                return gvs.results, thr

            out = loop.run_future(loop.spawn(calls()), max_time=15.0)
            counters = cli.transport_counters()
            return out, counters
        finally:
            srv.close()
            cli.close()

    native_out, nc = run("1")
    assert nc["ClientNativeBatches"] >= 1
    assert nc["ClientNativeSettles"] >= 2
    assert nc["ChecksumRejects"] == 0
    py_out, pc = run("0")
    assert pc["ClientNativeBatches"] == 0 and pc["ClientNativeSettles"] == 0
    assert native_out == py_out
    assert native_out[0] == [(0, b"=a"), (0, b"=b")]
    assert native_out[1] == ("transaction_throttled", "backoff=0.25")


def test_pump_fault_degrades_connection_mid_stream(monkeypatch):
    """The per-connection degradation contract, client side: a reply-pump
    fault downgrades just that connection to the pure-Python reply loop,
    replaying the pump's buffered residue — in-flight requests still get
    their answers."""
    monkeypatch.setenv("NET_NATIVE_CLIENT", "1")
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    class FaultyPump:
        def __init__(self):
            self.buf = b""

        def feed(self, chunk):
            self.buf += bytes(chunk)
            raise RuntimeError("injected pump fault")

        def residue(self):
            return self.buf

    monkeypatch.setattr(nt, "new_client_conn", lambda: FaultyPump())

    loop = RealEventLoop()
    srv = NetTransport(loop, _free_addr())
    cli = NetTransport(loop, _free_addr())
    srv.start()
    cli.start()
    try:
        srv.process.register(42, lambda payload, reply: reply.send(
            payload * 2))

        async def call():
            a = await cli.request(cli.process, Endpoint(srv.address, 42), 10)
            b = await cli.request(cli.process, Endpoint(srv.address, 42), 11)
            return a, b
        assert loop.run_future(loop.spawn(call()), max_time=15.0) == (20, 22)
    finally:
        srv.close()
        cli.close()


# -- frame-to-future in one tick ---------------------------------

def test_read_group_settles_same_tick_with_span():
    """The database's single-replica read group settles its batch futures
    synchronously from the request future's callback — no coroutine resume
    between reply arrival and caller settlement — and emits the Client.Read
    span around exactly that window."""
    import types

    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.core.future import Future
    from foundationdb_tpu_torch.utils import trace as T

    captured = {}

    class _Net:
        def request(self, process, ep, payload):
            captured["ep"] = ep
            captured["req"] = payload
            captured["f"] = Future()
            return captured["f"]

    db = object.__new__(Database)
    db.loop = types.SimpleNamespace(now=lambda: 1.0)
    db.process = types.SimpleNamespace(net=_Net())
    db._replica_stats = types.SimpleNamespace(
        record=lambda addr, dt: None,
        begin=lambda addr: None, end=lambda addr: None)
    db.coordinators = None
    db._team_order = lambda team: team
    db._next_span_id = lambda kind: "r-tick"

    ents = [(b"a", 7, Future()), (b"b", 7, Future())]
    coro = db._send_read_group(["s1:1"], ents)
    with pytest.raises(StopIteration):
        coro.send(None)  # the fast path runs to completion without awaiting
    assert captured["req"].reads == [(b"a", 7), (b"b", 7)]
    assert not any(f.is_ready() for _k, _v, f in ents)

    n0 = len(T.g_trace_batch._events)
    reply = types.SimpleNamespace(results=[(0, b"va"), (0, None)])
    captured["f"]._set(reply)  # the reply frame "arrives"
    # settled NOW, same tick — no event loop ever ran in this test
    assert [f.get() for _k, _v, f in ents] == [b"va", None]
    spans = [e for e in T.g_trace_batch._events[n0:]
             if e.get("Span") == "Client.Read" and e.get("ID") == "r-tick"]
    assert [s["Phase"] for s in spans] == ["Begin", "End"]

    # error arrival settles the whole batch in the same tick too
    ents2 = [(b"c", 7, Future())]
    coro = db._send_read_group(["s1:1"], ents2)
    with pytest.raises(StopIteration):
        coro.send(None)
    captured["f"]._set_error(RuntimeError("replica exploded"))
    assert ents2[0][2].is_error()


def test_get_many_without_read_version_chains_grv():
    """Transaction.get_many with no read version fetches the GRV once and
    chains the multiget off its callback — no per-key coroutine fan-out —
    and the result future settles synchronously from the reply callback."""
    import types

    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.core.future import Future

    grvf, readf = Future(), Future()
    calls = []
    db = types.SimpleNamespace(
        _grv=lambda: calls.append("grv") or grvf,
        _read_get_many=lambda keys, v: calls.append(("read", keys, v))
        or readf)

    tr = object.__new__(Transaction)
    tr.db = db
    tr._opt_timeout_ms = None
    tr.reset()

    out = tr.get_many([b"a", b"b"])
    assert calls == ["grv"]  # read not issued until the GRV lands
    grvf._set(types.SimpleNamespace(version=99))
    assert tr._read_version == 99
    assert calls[1] == ("read", [b"a", b"b"], 99)
    assert not out.is_ready()
    readf._set([b"va", b"vb"])
    assert out.get() == [b"va", b"vb"]  # same tick: no loop ran
    assert tr._read_conflict_keys == [b"a", b"b"]

    # get_future rides the same chain
    grvf2, readf2 = Future(), Future()
    db._grv = lambda: grvf2
    db._read_get = lambda key, v: readf2
    tr2 = object.__new__(Transaction)
    tr2.db = db
    tr2._opt_timeout_ms = None
    tr2.reset()
    f = tr2.get_future(b"k")
    grvf2._set(types.SimpleNamespace(version=5))
    readf2._set(b"v")
    assert f.get() == b"v"
