"""Native transport plane: C framer/parser vs Python framer parity.

The port's copy of tests/test_native_transport.py, run on the port's own C
extension. Three-way parity contract (the C plane is held byte-identical
to the Python framer): (1) frame assembly — `native_transport.py_frame`
(pure Python) and the C `transport_frame` produce identical bytes; (2)
stream parsing — a reference Python parser (mirroring transport.py's
_read_raw_frame/_verify_and_load decisions) and `TransportConn.feed` split
any byte stream, torn/corrupted/oversized included, into identical frames
with identical reject decisions and identical residue; (3) fast-path
replies — the C storage/GRV serves answer with frames byte-identical to
`wire.dumps` of the reply objects the Python handlers would send.

The module skips only where there is no C compiler; with one, the port's
extension must build and carry the transport plane.
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
TOO_OLD = "transaction_too_old"


# -- (1) frame assembly parity ------------------------------------------------

def fuzz_frame_parity(seed: int, iters: int = 200):
    """py_frame == C transport_frame, bit for bit, and the header fields
    and CRC-32C of both parse back exactly."""
    rng = random.Random(seed)
    for _ in range(iters):
        token = rng.getrandbits(64)
        reply_id = rng.getrandbits(64)
        kind = rng.choice((0, 1, 2, 3, rng.randrange(256)))
        body = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 600)))
        a = nt.py_frame(token, reply_id, kind, body)
        b = native.mod.transport_frame(token, reply_id, kind, body)
        assert a == b
        length, tok, rid, k, crc = nt._HEADER.unpack(a[:nt.HEADER_LEN])
        assert (length, tok, rid, k) == (len(body), token, reply_id, kind)
        assert a[nt.HEADER_LEN:] == body
        assert crc == nt._py_crc32c(body) == native.mod.crc32c(body, 0)


def test_frame_parity_fuzz():
    for seed in (1, 2):
        fuzz_frame_parity(seed)


def test_oversized_body_rejected_by_both_framers():
    big = b"\x00" * (nt.MAX_FRAME_BYTES + 1)
    with pytest.raises(ValueError):
        nt.py_frame(1, 1, 0, big)
    with pytest.raises(ValueError):
        native.mod.transport_frame(1, 1, 0, big)


def test_crc32c_known_answer():
    # the Castagnoli check vector — a plain CRC-32 (0x04C11DB7) would give
    # 0xCBF43926 here instead, so this pins the polynomial on both sides
    assert nt._py_crc32c(b"123456789") == 0xE3069283
    assert native.mod.crc32c(b"123456789", 0) == 0xE3069283


# -- (2) stream parse + reject parity -----------------------------------------

def _py_parse_stream(data: bytes):
    """Reference stream parser: transport.py's per-frame decisions
    (_read_raw_frame bounds check, then CRC) applied to a whole buffer.
    Returns (frames, err, residue): frames as (token, reply_id, kind,
    body), err the reject decision string or None, residue the unconsumed
    tail (meaningful only when err is None)."""
    frames = []
    pos = 0
    while True:
        if len(data) - pos < nt.HEADER_LEN:
            return frames, None, data[pos:]
        length, token, reply_id, kind, crc = nt._HEADER.unpack_from(data, pos)
        if length > nt.MAX_FRAME_BYTES:
            return frames, "oversized frame", b""
        if len(data) - pos - nt.HEADER_LEN < length:
            return frames, None, data[pos:]
        body = data[pos + nt.HEADER_LEN:pos + nt.HEADER_LEN + length]
        if nt._py_crc32c(body) != crc:
            return frames, "packet checksum mismatch", b""
        frames.append((token, reply_id, kind, body))
        pos += nt.HEADER_LEN + length


def _feed_chunked(conn, data: bytes, rng):
    """Feed `data` to a TransportConn in random-size chunks; returns the
    accumulated (slow_frames, err). Stops at the first err (the connection
    is dead, matching the serve loop dropping it)."""
    slow_all = []
    pos = 0
    while pos < len(data):
        n = rng.randrange(1, max(2, len(data) - pos + 1))
        replies, slow, err = conn.feed(data[pos:pos + n])
        assert replies is None  # empty table: nothing fast-serves
        slow_all.extend(slow)
        if err is not None:
            return slow_all, err
        pos += n
    return slow_all, None


def fuzz_stream_reject_parity(seed: int, streams: int = 40):
    """Random frame streams — good frames, corrupted CRC, oversized
    headers, unknown kinds, torn tails — split identically by the
    reference Python parser and TransportConn.feed under random chunking:
    same frames out, same reject decision, same residue."""
    rng = random.Random(seed)
    for _ in range(streams):
        parts = []
        for _f in range(rng.randrange(0, 6)):
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 120)))
            frame = nt.py_frame(rng.getrandbits(64), rng.getrandbits(64),
                                rng.randrange(256), body)
            shape = rng.randrange(6)
            if shape == 0:  # corrupted CRC / body byte
                i = rng.randrange(nt.HEADER_LEN - 4, len(frame))
                frame = frame[:i] + bytes([frame[i] ^ 0x20]) + frame[i + 1:]
            elif shape == 1:  # oversized length claim
                frame = struct.pack(">I", nt.MAX_FRAME_BYTES
                                    + rng.randrange(1, 1 << 20)) + frame[4:]
            elif shape == 2:  # max-size length claim, body absent: torn
                frame = struct.pack(">I", nt.MAX_FRAME_BYTES) + frame[4:]
            parts.append(frame)
        data = b"".join(parts)
        if rng.randrange(2):  # torn tail
            data = data[:max(0, len(data) - rng.randrange(1, 30))]

        want_frames, want_err, want_residue = _py_parse_stream(data)
        conn = nt.new_conn(nt.new_table())
        got_frames, got_err = _feed_chunked(conn, data, rng)
        assert got_frames == want_frames
        assert got_err == want_err
        if want_err is None:
            assert conn.residue() == want_residue


def test_stream_reject_parity_fuzz():
    for seed in (3, 4):
        fuzz_stream_reject_parity(seed)


def test_dead_conn_refuses_more_input():
    conn = nt.new_conn(nt.new_table())
    bad = nt.py_frame(1, 1, 0, b"x")
    bad = bad[:-1] + bytes([bad[-1] ^ 1])  # corrupt the body
    _replies, _slow, err = conn.feed(bad)
    assert err == "packet checksum mismatch"
    with pytest.raises(ValueError):
        conn.feed(b"more")


# -- (3) fast-path reply byte parity ------------------------------------------

def _fge(key: bytes) -> si.KeySelector:
    return si.KeySelector(key=key, or_equal=False, offset=1)


def _request_frame(table_token, reply_id, payload) -> bytes:
    return nt.py_frame(table_token, reply_id, _REQUEST, wire.dumps(payload))


def _expect_reply(reply_id, payload) -> bytes:
    return nt.py_frame(0, reply_id, _REPLY, wire.dumps(payload))


def _expect_error(reply_id, name) -> bytes:
    return nt.py_frame(0, reply_id, _REPLY_ERROR, wire.dumps(name))


def _build_store(rng, keys, versions):
    """A VStore plus the pure-Python model of it: {key: [(v, val)...]}."""
    vs = native.mod.VStore()
    model = {}
    for k in keys:
        for v in sorted(rng.sample(versions, rng.randrange(1, 4))):
            val = (None if rng.random() < 0.2 else
                   bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 20))))
            vs.put(k, v, val)
            model.setdefault(k, []).append((v, val))
    return vs, model


def _model_get(model, key, version):
    best = None
    for v, val in model.get(key, ()):
        if v <= version:
            best = val
    return best


def fuzz_fast_path_parity(seed: int, iters: int = 60):
    """The C storage serves answer byte-identically to wire.dumps of the
    reply objects the Python storage handlers produce — checked against an
    independent pure-Python MVCC model, not against the C store's own
    encoders."""
    rng = random.Random(seed)
    tok_gv, tok_gvs, tok_gkv = si.Token.STORAGE_GET_VALUE, \
        si.Token.STORAGE_GET_VALUES, si.Token.STORAGE_GET_KEY_VALUES
    oldest, latest = 5, 15
    keys = [b"k%02d" % i for i in range(12)]
    vs, model = _build_store(rng, keys, list(range(1, latest + 1)))
    table = nt.new_table()
    table.enable_storage(vs, *nt.storage_wire_ids(),
                         oldest, latest, 10**9)
    conn = nt.new_conn(table)
    rid = 0
    for _ in range(iters):
        rid += 1
        shape = rng.randrange(4)
        if shape == 0:  # GetValue within the window
            key = rng.choice(keys + [b"absent"])
            ver = rng.randrange(oldest, latest + 1)
            req = _request_frame(tok_gv, rid,
                                 si.GetValueRequest(key=key, version=ver))
            want = _expect_reply(rid, si.GetValueReply(
                value=_model_get(model, key, ver), version=ver))
        elif shape == 1:  # GetValue outside the MVCC window
            ver = rng.choice((oldest - 1, 0))
            req = _request_frame(tok_gv, rid, si.GetValueRequest(
                key=rng.choice(keys), version=ver))
            want = _expect_error(rid, TOO_OLD)
        elif shape == 2:  # GetValues batch, mixed per-item outcomes
            reads = [(rng.choice(keys),
                      rng.randrange(oldest - 2, latest + 1))
                     for _ in range(rng.randrange(1, 5))]
            req = _request_frame(tok_gvs, rid,
                                 si.GetValuesRequest(reads=reads))
            if max(v for _k, v in reads) < oldest:
                want = _expect_error(rid, TOO_OLD)
            else:
                results = [(1, TOO_OLD) if v < oldest
                           else (0, _model_get(model, k, v))
                           for k, v in reads]
                want = _expect_reply(rid, si.GetValuesReply(results=results))
        else:  # GetKeyValues over FGE selectors
            b, e = sorted((rng.choice(keys + [b""]),
                           rng.choice(keys + [b"\xff"])))
            ver = rng.randrange(oldest, latest + 1)
            reverse = rng.random() < 0.5
            rows = [(k, _model_get(model, k, ver))
                    for k in keys if b <= k < e
                    and _model_get(model, k, ver) is not None]
            if reverse:
                rows.reverse()
            limit = rng.choice((0, 0, rng.randrange(1, 6)))
            more = bool(limit) and len(rows) > limit
            if limit:
                rows = rows[:limit]
            req = _request_frame(tok_gkv, rid, si.GetKeyValuesRequest(
                begin=_fge(b), end=_fge(e), version=ver, limit=limit,
                limit_bytes=0, reverse=reverse))
            want = _expect_reply(rid, si.GetKeyValuesReply(
                data=rows, more=more, version=ver))
        replies, slow, err = conn.feed(req)
        assert err is None and slow == []
        assert replies == want, (shape, rid)


def test_fast_path_parity_fuzz():
    for seed in (5, 6):
        fuzz_fast_path_parity(seed)


def test_future_version_falls_to_python():
    """A read above the pushed latest bound must NOT be answered by the C
    plane — Python owns version waits — and shard-mode disable stands the
    plane down entirely."""
    vs = native.mod.VStore()
    vs.put(b"k", 5, b"v")
    table = nt.new_table()
    table.enable_storage(vs, *nt.storage_wire_ids(), 1, 10, 10**9)
    conn = nt.new_conn(table)
    req = _request_frame(si.Token.STORAGE_GET_VALUE, 1,
                         si.GetValueRequest(key=b"k", version=11))
    replies, slow, err = conn.feed(req)
    assert replies is None and err is None and len(slow) == 1
    assert slow[0][:3] == (si.Token.STORAGE_GET_VALUE, 1, _REQUEST)

    # bounds move with durability/GC: push, then the same version serves
    table.set_read_bounds(1, 11)
    replies, slow, err = conn.feed(req)
    assert err is None and slow == []
    assert replies == _expect_reply(1, si.GetValueReply(value=b"v",
                                                        version=11))

    table.disable_storage()
    replies, slow, err = conn.feed(req)
    assert replies is None and len(slow) == 1


def test_grv_fast_path_allowance_and_priority():
    table = nt.new_table()
    table.enable_grv(*nt.grv_wire_ids())
    conn = nt.new_conn(table)

    def grv(rid, priority=0, debug_id=None):
        return conn.feed(_request_frame(
            si.Token.PROXY_GET_READ_VERSION, rid,
            si.GetReadVersionRequest(priority=priority, debug_id=debug_id)))

    # no version pushed yet: falls to Python
    replies, slow, err = grv(1)
    assert replies is None and len(slow) == 1 and err is None

    table.set_grv(42, 3)
    replies, slow, err = grv(2)
    assert slow == [] and err is None
    assert replies == _expect_reply(2, si.GetReadVersionReply(version=42))

    # non-default priority is ratekeeper policy: Python's call
    replies, slow, err = grv(3, priority=1)
    assert replies is None and len(slow) == 1

    # the client stamps a span id on every real-path GRV; the handler
    # never reads it, so the plane serves through it
    replies, slow, err = grv(4, debug_id="grv-1f3a")
    assert slow == [] and err is None
    assert replies == _expect_reply(4, si.GetReadVersionReply(version=42))

    replies, _slow, _err = grv(5)
    assert replies == _expect_reply(5, si.GetReadVersionReply(version=42))
    # allowance exhausted (3 granted): the plane stops handing out
    replies, slow, _err = grv(6)
    assert replies is None and len(slow) == 1
    assert table.counters()["NativeGRVHits"] == 3


def test_counters_track_frames_and_hits():
    vs = native.mod.VStore()
    vs.put(b"a", 3, b"1")
    table = nt.new_table()
    table.enable_storage(vs, *nt.storage_wire_ids(), 1, 5, 10**9)
    conn = nt.new_conn(table)
    served = _request_frame(si.Token.STORAGE_GET_VALUE, 1,
                            si.GetValueRequest(key=b"a", version=3))
    fell = nt.py_frame(999, 2, _REQUEST, wire.dumps("nope"))
    replies, slow, err = conn.feed(served + fell)
    assert err is None and len(slow) == 1 and replies is not None
    c = table.counters()
    assert c["FramesIn"] == 2 and c["FramesOut"] == 1
    assert c["NativeFastPathHits"] == 1 and c["NativeGetValueHits"] == 1
    assert c["PySlowPathFalls"] == 1 and c["ChecksumRejects"] == 0
    assert c["BytesIn"] == len(served) + len(fell)
    assert c["BytesOut"] == len(replies)


# -- end-to-end over the real wire --------------------------------------------

def _free_addr():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def test_native_plane_serves_over_real_wire(monkeypatch):
    """Proof the C plane answers on a live connection: the server registers
    NO Python handler for the storage/GRV tokens, so any reply the client
    gets can only have come from the native fast path — and it must parse
    and CRC-verify on the client's pure-Python reply reader."""
    monkeypatch.setenv("NET_NATIVE_TRANSPORT", "1")
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    loop = RealEventLoop()
    srv = NetTransport(loop, _free_addr())
    cli = NetTransport(loop, _free_addr())
    srv.start()
    cli.start()
    try:
        assert srv.native_table is not None
        vs = native.mod.VStore()
        vs.put(b"hello", 7, b"native")
        srv.native_table.enable_storage(vs, *nt.storage_wire_ids(),
                                        1, 10, 10**9)
        srv.native_table.enable_grv(*nt.grv_wire_ids())
        srv.native_table.set_grv(77, 100)

        async def reads():
            gv = await cli.request(
                cli.process,
                Endpoint(srv.address, si.Token.STORAGE_GET_VALUE),
                si.GetValueRequest(key=b"hello", version=7))
            grv = await cli.request(
                cli.process,
                Endpoint(srv.address, si.Token.PROXY_GET_READ_VERSION),
                si.GetReadVersionRequest(debug_id="span-g1"))
            return gv, grv

        gv, grv = loop.run_future(loop.spawn(reads()), max_time=15.0)
        assert (gv.value, gv.version) == (b"native", 7)
        assert grv.version == 77
        c = srv.transport_counters()
        assert c["NativeFastPathHits"] == 2
        assert c["NativeGetValueHits"] == 1 and c["NativeGRVHits"] == 1
        assert c["FramesIn"] >= 2 and c["ChecksumRejects"] == 0
    finally:
        srv.close()
        cli.close()


def test_native_fault_degrades_connection_to_python(monkeypatch):
    """The per-connection fallback contract: a native-plane fault mid-
    stream downgrades just that connection to the Python serve loop, which
    replays the plane's buffered residue — the in-flight request still
    gets its answer."""
    monkeypatch.setenv("NET_NATIVE_TRANSPORT", "1")
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    class FaultyConn:
        def __init__(self):
            self.buf = b""

        def feed(self, chunk):
            self.buf += bytes(chunk)
            raise RuntimeError("injected native fault")

        def residue(self):
            return self.buf

    monkeypatch.setattr(nt, "new_conn", lambda table: FaultyConn())

    loop = RealEventLoop()
    srv = NetTransport(loop, _free_addr())
    cli = NetTransport(loop, _free_addr())
    srv.start()
    cli.start()
    try:
        assert srv.native_table is not None
        srv.process.register(42, lambda payload, reply: reply.send(
            payload + 1))

        async def call():
            return await cli.request(cli.process,
                                     Endpoint(srv.address, 42), 10)
        assert loop.run_future(loop.spawn(call()), max_time=15.0) == 11
        assert srv.transport_counters()["PySlowPathFalls"] >= 1
    finally:
        srv.close()
        cli.close()


@pytest.mark.parametrize("native_on", ["1", "0"])
def test_checksum_reject_drops_the_tcp_connection(monkeypatch, native_on):
    """A protocol reject must reach the TCP layer on both planes: the
    serve loop's drop decision has to close the socket so the peer sees
    EOF instead of hanging on recv forever (regression for the reject
    path leaving the writer open)."""
    import asyncio

    monkeypatch.setenv("NET_NATIVE_TRANSPORT", native_on)
    from foundationdb_tpu_torch.net import transport as T

    loop = T.RealEventLoop()
    srv = T.NetTransport(loop, _free_addr())
    srv.start()
    try:
        assert (srv.native_table is not None) == (native_on == "1")
        host, port = srv.address.rsplit(":", 1)

        async def probe():
            r, w = await asyncio.open_connection(host, int(port))
            w.write(T._CONNECT)
            bad = bytearray(srv._frame(7, 1, T._REQUEST, wire.dumps(None)))
            bad[21] ^= 0xFF  # corrupt the stored CRC-32C
            w.write(bytes(bad))
            await w.drain()
            data = await asyncio.wait_for(r.read(64), timeout=10.0)
            w.close()
            return data

        assert loop.aio.run_until_complete(probe()) == b""
        assert srv.transport_counters()["ChecksumRejects"] == 1
    finally:
        srv.close()


def test_read_replies_verifies_checksum_exactly_once(monkeypatch):
    """Satellite regression: the client reply reader must verify a frame's
    CRC at most once, and not at all for a retransmit-dedup hit (a reply
    whose request already completed or expired) — those bytes are dropped
    unread, so checksumming them is pure event-loop burn."""
    import asyncio

    from foundationdb_tpu_torch.core.future import Promise
    from foundationdb_tpu_torch.net import transport as T

    calls = []
    real = nt.crc32c
    monkeypatch.setattr(nt, "crc32c",
                        lambda body, crc=0: calls.append(len(body))
                        or real(body, crc))

    loop = T.RealEventLoop()
    t = T.NetTransport(loop, "127.0.0.1:1")  # never started: pure framing
    pending = Promise()
    t._pending[5] = (pending, "10.0.0.9:4000", None)
    live = t._frame(0, 5, T._REPLY, wire.dumps("served"))
    dedup = t._frame(0, 99, T._REPLY, wire.dumps("dropped"))

    async def go():
        r = asyncio.StreamReader()
        r.feed_data(dedup + live)
        r.feed_eof()
        await t._read_replies(r, "10.0.0.9:4000")

    loop.aio.run_until_complete(go())
    assert pending.future.is_ready()
    assert pending.future.get() == "served"
    # exactly one verification, for the one frame somebody read
    assert calls == [len(live) - nt.HEADER_LEN]


def test_read_replies_crc_reject_fails_popped_entry():
    """A reply frame that fails its checksum AFTER its pending entry was
    popped must fail that entry (broken_promise), not strand it until the
    RPC timeout."""
    import asyncio

    from foundationdb_tpu_torch.core.future import Promise
    from foundationdb_tpu_torch.net import transport as T

    loop = T.RealEventLoop()
    t = T.NetTransport(loop, "127.0.0.1:1")
    pending = Promise()
    t._pending[5] = (pending, "10.0.0.9:4000", None)
    frame = t._frame(0, 5, T._REPLY, wire.dumps("x"))
    frame = frame[:-1] + bytes([frame[-1] ^ 1])  # corrupt the body

    async def go():
        r = asyncio.StreamReader()
        r.feed_data(frame)
        r.feed_eof()
        await t._read_replies(r, "10.0.0.9:4000")

    loop.aio.run_until_complete(go())
    fut = pending.future
    assert fut.is_ready() and fut.is_error()
    assert fut._result.name == "broken_promise"
    assert t._c_checksum_rejects == 1
    assert not t._pending
