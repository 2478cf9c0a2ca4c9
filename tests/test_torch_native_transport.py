"""The port's transport framing against the JAX package's Python framer.

The pure-Python cases of tests/test_native_transport.py run here on the
port's net/native_transport.py and net/transport.py, held to the JAX
module's Python fallbacks: frame assembly and CRC-32C over a seeded fuzz,
the oversized-body reject, the Castagnoli check vector, the stream parse
and reject decisions of a live connection over random frame streams, and a
connection dropped at its first bad frame. The native planes, asked for by
knob or by environment variable, serve (tests/test_torch_native_server.py
and test_torch_native_client.py hold them to the Python paths).
"""

import asyncio
import random
import socket
import struct

import pytest

from foundationdb_tpu.net import native_transport as j_nt
from foundationdb_tpu_torch.net import native_transport as nt
from foundationdb_tpu_torch.net import transport as T
from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

from test_torch_transport import free_addr


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.delenv("NET_NATIVE_TRANSPORT", raising=False)
    monkeypatch.delenv("NET_NATIVE_CLIENT", raising=False)
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def fuzz_frame_parity(seed: int, iters: int = 200):
    """The port's py_frame and frame equal the JAX package's py_frame bit
    for bit, and the header fields and CRC-32C parse back exactly."""
    rng = random.Random(seed)
    for _ in range(iters):
        token = rng.getrandbits(64)
        reply_id = rng.getrandbits(64)
        kind = rng.choice((0, 1, 2, 3, rng.randrange(256)))
        body = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 600)))
        a = nt.py_frame(token, reply_id, kind, body)
        assert a == nt.frame(token, reply_id, kind, body)
        assert a == j_nt.py_frame(token, reply_id, kind, body)
        length, tok, rid, k, crc = nt._HEADER.unpack(a[:nt.HEADER_LEN])
        assert (length, tok, rid, k) == (len(body), token, reply_id, kind)
        assert a[nt.HEADER_LEN:] == body
        assert crc == nt.crc32c(body) == j_nt._py_crc32c(body)
        # a CRC continued over a split equals the CRC of the whole
        cut = rng.randrange(len(body) + 1)
        assert nt.crc32c(body[cut:], nt.crc32c(body[:cut])) == crc


@pytest.mark.parametrize("seed", [1, 2])
def test_frame_parity_fuzz(seed):
    fuzz_frame_parity(seed)


def test_oversized_body_rejected_by_both_framers():
    big = b"\x00" * (nt.MAX_FRAME_BYTES + 1)
    assert (nt.HEADER_LEN, nt.MAX_FRAME_BYTES) == (j_nt.HEADER_LEN,
                                                   j_nt.MAX_FRAME_BYTES)
    for framer in (nt.py_frame, nt.frame, j_nt.py_frame):
        with pytest.raises(ValueError):
            framer(1, 1, 0, big)


def test_crc32c_known_answer():
    # the Castagnoli check vector; a plain CRC-32 gives 0xCBF43926
    assert nt.crc32c(b"123456789") == 0xE3069283
    assert j_nt._py_crc32c(b"123456789") == 0xE3069283


def _py_parse_stream(data: bytes):
    """The reference decisions (tests/test_native_transport.py's parser):
    (frames, err, residue) for a byte stream."""
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
        if j_nt._py_crc32c(body) != crc:
            return frames, "packet checksum mismatch", b""
        frames.append((token, reply_id, kind, body))
        pos += nt.HEADER_LEN + length


def _transport_parse(t, loop, data: bytes, rng):
    """The port transport's reader over `data`, fed in random chunks:
    frames read with `_read_raw_frame` and verified by its CRC check,
    until a reject (err) or the end (the torn residue)."""
    async def go():
        reader = asyncio.StreamReader()
        pos = 0
        while pos < len(data):
            n = rng.randrange(1, max(2, len(data) - pos + 1))
            reader.feed_data(data[pos:pos + n])
            pos += n
        reader.feed_eof()
        frames = []
        while True:
            try:
                token, reply_id, kind, crc, body = \
                    await t._read_raw_frame(reader)
            except asyncio.IncompleteReadError as e:
                return frames, None, e.partial
            except ConnectionError as e:
                return frames, str(e), b""
            if nt.crc32c(body) != crc:
                return frames, "packet checksum mismatch", b""
            frames.append((token, reply_id, kind, body))
    return loop.run_future(loop.spawn(go()), max_time=10.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_stream_reject_parity_fuzz(seed):
    """Random frame streams (good frames, corrupted CRCs, oversized and
    max-size length claims, unknown kinds, torn tails) split by the port's
    transport reader exactly as the reference parser splits them: the same
    frames, the same reject decision, the same residue (the torn bytes a
    header or body still waited for)."""
    rng = random.Random(seed)
    loop = RealEventLoop()
    t = NetTransport(loop, "127.0.0.1:1")  # never started: pure framing
    for _ in range(40):
        parts = []
        for _f in range(rng.randrange(0, 6)):
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 120)))
            frame = nt.py_frame(rng.getrandbits(64), rng.getrandbits(64),
                                rng.randrange(256), body)
            shape = rng.randrange(6)
            if shape == 0:
                i = rng.randrange(nt.HEADER_LEN - 4, len(frame))
                frame = frame[:i] + bytes([frame[i] ^ 0x20]) + frame[i + 1:]
            elif shape == 1:
                frame = struct.pack(">I", nt.MAX_FRAME_BYTES
                                    + rng.randrange(1, 1 << 20)) + frame[4:]
            elif shape == 2:
                frame = struct.pack(">I", nt.MAX_FRAME_BYTES) + frame[4:]
            parts.append(frame)
        data = b"".join(parts)
        if rng.randrange(2):
            data = data[:max(0, len(data) - rng.randrange(1, 30))]
        want = _py_parse_stream(data)
        got = _transport_parse(t, loop, data, rng)
        assert got[:2] == want[:2]
        if want[1] is None:
            # the reader's residue is the torn frame's partial read: a
            # partial header, or the body read after a whole header
            torn = want[2]
            assert got[2] in (torn, torn[nt.HEADER_LEN:])


def test_dead_conn_refuses_more_input():
    """A live listener drops a connection at its first bad frame: later
    bytes on it get no answer, and a new connection is served."""
    from foundationdb_tpu_torch.core.sim import Endpoint

    loop = RealEventLoop()
    srv = NetTransport(loop, free_addr())
    cli = NetTransport(loop, free_addr())
    srv.start()
    cli.start()
    try:
        srv.process.register(7, lambda payload, reply: reply.send(payload))
        bad = nt.py_frame(7, 1, T._REQUEST, b"x")
        bad = bad[:-1] + bytes([bad[-1] ^ 1])
        good = nt.py_frame(7, 2, T._REQUEST, wire.dumps("ping"))
        host, port = srv.address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)))
        s.settimeout(5.0)

        async def settle():
            await asyncio.sleep(0.2)
        s.sendall(T._CONNECT + bad)
        loop.aio.run_until_complete(settle())
        try:
            s.sendall(good)
        except OSError:
            pass  # already reset: that is the refusal
        loop.aio.run_until_complete(settle())
        try:
            answer = s.recv(4096)
        except OSError:
            answer = b""
        s.close()
        assert answer == b""
        assert srv.transport_counters()["ChecksumRejects"] == 1

        async def call():
            return await cli.request(cli.process, Endpoint(srv.address, 7),
                                     "alive")
        assert loop.run_future(loop.spawn(call()), max_time=10.0) == "alive"
    finally:
        srv.close()
        cli.close()


def _plane_round_trip(server_native: bool, client_native: bool):
    """One echo request over TCP, the server and client transports built
    under the gates as they stand: (the server's C plane counters, or None
    without the plane; the client's transport counters) after it."""
    from foundationdb_tpu_torch.core.sim import Endpoint

    loop = RealEventLoop()
    srv = NetTransport(loop, free_addr())
    cli = NetTransport(loop, free_addr())
    assert (srv.native_table is not None) == server_native
    assert cli.native_client == client_native
    srv.start()
    cli.start()
    try:
        srv.process.register(7, lambda payload, reply: reply.send(payload))

        async def call():
            return await cli.request(cli.process, Endpoint(srv.address, 7),
                                     ["echo", b"\x00\xff", 3])
        assert loop.run_future(loop.spawn(call()), max_time=10.0) == [
            "echo", b"\x00\xff", 3]
        table = srv.native_table
        return (table.counters() if table is not None else None,
                cli.transport_counters())
    finally:
        srv.close()
        cli.close()


@pytest.mark.parametrize("name", ["NET_NATIVE_TRANSPORT",
                                  "NET_NATIVE_CLIENT"])
@pytest.mark.parametrize("how", ["knob", "env"])
def test_native_planes_serve_when_asked(monkeypatch, name, how):
    """A plane asked for by its knob or its environment variable serves:
    the server plane parses the request frame in C (and hands the echo
    token, which has no fast path, to Python), the client plane encodes the
    request in a C batch and settles the reply from its C pump. Off (the
    knob's default or the variable set to 0), the Python path serves."""
    assert nt.available() and nt.client_available()
    if how == "knob":
        TKNOBS.set(name, 1)
    else:
        monkeypatch.setenv(name, "1")
    server = name == "NET_NATIVE_TRANSPORT"
    s, c = _plane_round_trip(server, not server)
    if server:
        assert s["FramesIn"] == 1 and s["PySlowPathFalls"] == 1
        assert s["NativeFastPathHits"] == 0
        assert c["ClientNativeBatches"] == 0
    else:
        assert s is None
        assert c["ClientNativeBatches"] >= 1
        assert c["ClientNativeSettles"] == 1
    if how == "knob":
        TKNOBS.set(name, 0)
    else:
        monkeypatch.setenv(name, "0")
    s, c = _plane_round_trip(False, False)
    assert s is None and c["ClientNativeBatches"] == 0


@pytest.mark.parametrize("how", ["knob", "env"])
def test_both_native_planes_serve_together(monkeypatch, how):
    for name in ("NET_NATIVE_TRANSPORT", "NET_NATIVE_CLIENT"):
        if how == "knob":
            TKNOBS.set(name, 1)
        else:
            monkeypatch.setenv(name, "1")
    s, c = _plane_round_trip(True, True)
    assert s["PySlowPathFalls"] == 1 and c["ClientNativeSettles"] == 1


def test_batch_encoder_equals_the_jax_packages():
    """encode_batch writes, request by request, the frames the JAX
    package's Python batch encoder writes."""
    from foundationdb_tpu_torch.server.interfaces import GetValueRequest
    from foundationdb_tpu.server.interfaces import (
        GetValueRequest as JGetValueRequest)
    items = [(5, 1, "x"), (21, 2, [b"k", None, 3]), (9, 3, (1.5, "y"))]
    t_items = items + [(18, 4, GetValueRequest(key=b"k", version=7))]
    j_items = items + [(18, 4, JGetValueRequest(key=b"k", version=7))]
    assert nt.encode_batch(t_items) == j_nt.py_encode_batch(j_items)
