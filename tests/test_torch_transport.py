"""The port's real transport and server processes against the JAX package's.

tests/test_transport.py's eight tests run on the port's net/transport.py,
net/server_main.py and tools/networktest.py: loopback request/reply, error
detail over the wire, a cluster of real OS processes (under the oracle and
the device backend, the device engine on the CPU at a small shape), a
restart that recovers the tlog's files after hostile bytes, networktest,
the framing fuzz, the frame round trip and the named broken_promise.

Cross-package checks: the port's frames equal the JAX package's byte for
byte over a seeded fuzz of every wire type, and a port client reads and
commits against a JAX server_main process and a JAX client against the
port's (oracle backend). A port server_main with the default knobs (the
device backend on CUDA) exits non-zero on a machine without a card and
never prints `ready`. Importing the port's real-process modules loads
neither jax nor anything of foundationdb_tpu.

Server processes take their ports from a range of this xdist worker's
own, and every wait on a child has a deadline.
"""

import itertools
import json
import os
import select
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small engine shape of the port's CPU tests (tests/test_torch_cluster.py)
SHAPE_KNOBS = dict(CONFLICT_STATE_CAPACITY=1024, CONFLICT_BATCH_TXNS=64,
                   CONFLICT_BATCH_READS_PER_TXN=4,
                   CONFLICT_BATCH_WRITES_PER_TXN=4)
READY_S = 120.0  # a server process's boot on a loaded CPU
STOP_S = 20.0


@pytest.fixture(autouse=True)
def _knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def _worker_ports():
    """Ports 20000 + 1000 x (this xdist worker's number) up, below the
    kernel's ephemeral range, so that two workers never draw the same."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    n = int(worker[2:]) if worker[2:].isdigit() else 0
    base = 20000 + 1000 * (n % 12)
    return itertools.cycle(range(base, base + 1000))


_PORTS = _worker_ports()


def free_port() -> int:
    """The next port of this worker's range that binds now."""
    for _ in range(1000):
        port = next(_PORTS)
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        return port
    raise RuntimeError("no free port in this worker's range")


def free_addr() -> str:
    return f"127.0.0.1:{free_port()}"


def server_env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)


def start_server(module, spec, env=None, timeout=READY_S, log_path=None):
    """`python -m <module> <spec>` with a deadline on its ready line; a
    child that prints anything else, exits or hangs fails the test. With
    `log_path` its stderr goes to that file: a process that lives through
    a whole module writes counter records that would fill a pipe nobody
    reads, and block."""
    err = open(log_path, "ab") if log_path else subprocess.PIPE
    try:
        p = subprocess.Popen([sys.executable, "-m", module, json.dumps(spec)],
                             stdout=subprocess.PIPE, stderr=err, cwd=ROOT,
                             env=env or server_env())
    finally:
        if log_path:
            err.close()
    ready, _w, _x = select.select([p.stdout], [], [], timeout)
    line = p.stdout.readline().decode() if ready else ""
    if not line.startswith("ready"):
        p.kill()
        _out, said = p.communicate(timeout=STOP_S)
        if log_path:
            with open(log_path, "rb") as f:
                said = f.read()
        pytest.fail(f"{module} did not print ready within {timeout} s "
                    f"(got {line!r}): {said.decode()[-2000:]}")
    return p


def stop_servers(procs, sig=signal.SIGTERM):
    """Signal every live child and reap it within STOP_S; returns the exit
    codes."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=STOP_S))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=STOP_S)
            rcs.append("timeout")
        for stream in (p.stdout, p.stderr):
            if stream is not None:
                stream.close()
    return rcs


def cluster_specs(tmp_path, knobs, recover=False):
    """test_transport.py's two-process topology: (txn spec, storage spec);
    the txn process hosts master, resolver, tlog and proxy, the storage
    process one storage server. With `recover` the master and resolver
    fence their versions with '@recover:local_tlog'."""
    from foundationdb_tpu_torch.server.interfaces import Token
    p_txn, p_storage = free_addr(), free_addr()
    fence = {"recovery_version": "@recover:local_tlog"} if recover else {}
    txn = {
        "listen": p_txn, "data_dir": str(tmp_path / "txn"), "knobs": knobs,
        "roles": [
            {"role": "master", "args": dict(fence)},
            {"role": "resolver", "args": dict(fence)},
            {"role": "tlog", "args": {}},
            {"role": "proxy", "args": {
                "proxy_id": 0,
                "master": {"address": p_txn,
                           "token": Token.MASTER_GET_COMMIT_VERSION},
                "resolvers": {"boundaries": [b"".hex()],
                              "endpoints": [{"address": p_txn,
                                             "token": Token.RESOLVER_RESOLVE}]},
                "tlogs": [{"address": p_txn, "token": Token.TLOG_COMMIT}],
                "shards": {"boundaries": [b"".hex()], "tags": [[0]]},
            }},
        ],
    }
    storage = {
        "listen": p_storage, "data_dir": str(tmp_path / "storage"),
        "knobs": knobs,
        "roles": [{"role": "storage",
                   "args": {"tag": 0, "tlog_addrs": [p_txn]}}],
    }
    return txn, storage


def port_client(proxy, storage):
    """A port client on a real loop: (loop, transport, Database)."""
    from foundationdb_tpu_torch.client.database import Database, LocationCache
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    loop = RealEventLoop()
    client = NetTransport(loop, free_addr())
    client.start()
    db = Database(client.process, proxies=[proxy],
                  locations=LocationCache([b""], [[storage]]))
    return loop, client, db


async def write_and_read(db, writes):
    """Commit `writes` in one transaction, then read them and the whole
    user range back in another."""
    async def setup(tr):
        for k, v in writes:
            tr.set(k, v)
    await db.transact(setup, max_retries=50)

    async def read(tr):
        got = [await tr.get(k) for k, _v in writes]
        return got, await tr.get_range(b"", b"\xff")
    return await db.transact(read, max_retries=50)


# ------------------------------------------------------- in-process transport

def test_transport_request_reply_loopback():
    """Token-routed request/reply between two transports in one process."""
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    loop = RealEventLoop()
    a = NetTransport(loop, free_addr())
    b = NetTransport(loop, free_addr())
    a.start()
    b.start()
    try:
        b.process.register(42, lambda payload, reply: reply.send(payload * 2))

        async def call():
            return await a.request(a.process, Endpoint(b.address, 42), 21)
        assert loop.run_future(loop.spawn(call()), max_time=10.0) == 42

        async def bad():
            try:
                await a.request(a.process, Endpoint(b.address, 999), None)
                return "no error"
            except Exception as e:
                return getattr(e, "name", str(e))
        assert loop.run_future(loop.spawn(bad()),
                               max_time=10.0) == "broken_promise"
    finally:
        a.close()
        b.close()
    assert not a._tasks and not b._tasks


def test_transport_error_detail_survives_the_wire():
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.utils.errors import FDBError

    loop = RealEventLoop()
    a = NetTransport(loop, free_addr())
    b = NetTransport(loop, free_addr())
    a.start()
    b.start()
    try:
        def throttler(payload, reply):
            reply.send_error(FDBError("transaction_throttled",
                                      "0.5 6b3030 6b303100"))
        b.process.register(43, throttler)
        b.process.register(44, lambda payload, reply: reply.send_error(
            FDBError("not_committed")))

        async def call(token):
            try:
                await a.request(a.process, Endpoint(b.address, token), None)
                return None
            except FDBError as e:
                return e
        e = loop.run_future(loop.spawn(call(43)), max_time=10.0)
        assert (e.name, e.detail) == ("transaction_throttled",
                                      "0.5 6b3030 6b303100")
        e = loop.run_future(loop.spawn(call(44)), max_time=10.0)
        assert (e.name, e.detail) == ("not_committed", "")
    finally:
        a.close()
        b.close()


def test_readback_counters_hold_under_worker_threads():
    """A real loop drains the resolvers' readbacks on up to four worker
    threads: the readback counters must not lose an update when many
    threads finish at once (a short switch interval forces the races)."""
    import threading

    from foundationdb_tpu_torch.ops.conflict import (drain_and_collect,
                                                     kernel_metrics)

    n_threads, calls = 16, 2000
    before = kernel_metrics.as_dict()["ReadbackWaits"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [drain_and_collect([]) for _ in range(calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernel_metrics.as_dict()["ReadbackWaits"] - before == \
        n_threads * calls


# ----------------------------------------------------------- OS processes

@pytest.mark.parametrize("backend", ["oracle", "device"])
def test_multiprocess_cluster_serves_gets_and_commits(tmp_path, backend):
    """The port's server_main in two OS processes (txn subsystem, storage),
    transactions from this process through the port's client API; the
    device backend runs its engine's plain PyTorch path on the CPU."""
    knobs = {"CONFLICT_BACKEND": backend, "CONFLICT_DEVICE": "cpu",
             **SHAPE_KNOBS}
    specs = cluster_specs(tmp_path, knobs)
    procs = []
    try:
        for spec in specs:
            procs.append(start_server("foundationdb_tpu_torch.net.server_main",
                                      spec))
        loop, client, db = port_client(specs[0]["listen"],
                                       specs[1]["listen"])
        try:
            (v, k2), rows = loop.run_future(loop.spawn(write_and_read(
                db, [(b"hello", b"multiprocess"), (b"k2", b"v2")])),
                max_time=60.0)
        finally:
            client.close()
        assert (v, k2) == (b"multiprocess", b"v2")
        assert (b"hello", b"multiprocess") in rows and (b"k2", b"v2") in rows
    finally:
        rcs = stop_servers(procs)
    assert rcs == [0, 0]  # graceful SIGTERM: both unwind and exit 0


def test_multiprocess_restart_recovers_wire_wal(tmp_path):
    """SIGKILL the txn process and restart it on its data dir: the tlog
    recovers its disk queue, the master and resolver fence past the
    recovered version, new commits land and old data survives. Hostile
    bytes at the live port first drop their connection, not the server."""
    import struct

    from foundationdb_tpu_torch.net import native_transport as nt
    from foundationdb_tpu_torch.net.transport import _CONNECT

    knobs = {"CONFLICT_BACKEND": "oracle"}
    txn_spec, storage_spec = cluster_specs(tmp_path, knobs, recover=True)
    module = "foundationdb_tpu_torch.net.server_main"
    txn_p = start_server(module, txn_spec)
    sto_p = start_server(module, storage_spec)
    try:
        loop, client, db = port_client(txn_spec["listen"],
                                       storage_spec["listen"])

        def run(coro, t=90.0):
            return loop.run_future(loop.spawn(coro), max_time=t)

        async def write_kv(k, v):
            async def body(tr):
                tr.set(k, v)
            await db.transact(body, max_retries=50)

        async def read_k(k):
            async def body(tr):
                return await tr.get(k)
            return await db.transact(body, max_retries=50)

        run(write_kv(b"before", b"alive"))
        host, port = txn_spec["listen"].rsplit(":", 1)
        body = b"\x80\x04junkpickle"
        frame = struct.pack(">IQQBI", len(body), 10, 1, 0,
                            nt.crc32c(body)) + body
        for blob in (b"\x00" * 64, _CONNECT + b"\xff" * 200,
                     _CONNECT + frame):
            s = socket.create_connection((host, int(port)))
            s.sendall(blob)
            s.close()
        run(write_kv(b"hostile", b"survived"))

        stop_servers([txn_p], signal.SIGKILL)
        time.sleep(0.5)
        txn_p = start_server(module, txn_spec)
        run(write_kv(b"after", b"recovered"))
        assert run(read_k(b"after")) == b"recovered"
        assert run(read_k(b"before")) == b"alive"
        assert run(read_k(b"hostile")) == b"survived"
        client.close()
    finally:
        stop_servers([txn_p, sto_p])


def test_networktest_tool_measures_the_wire():
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.tools.networktest import (run_load,
                                                          start_receiver)

    loop = RealEventLoop()
    srv = NetTransport(loop, free_addr())
    cli = NetTransport(loop, free_addr())
    srv.start()
    cli.start()
    start_receiver(srv.process)

    async def go():
        return await run_load(cli, cli.process, srv.address, streams=8,
                              payload_bytes=128, seconds=1.0)
    try:
        report = loop.run_future(loop.spawn(go()), max_time=30.0)
    finally:
        cli.close()
        srv.close()
    assert report["requests"] > 50, report
    assert report["p50_ms"] is not None and report["p50_ms"] < 500
    assert report["mbit_per_sec"] > 0


def test_framing_fuzz_rejects_garbage_without_wedging():
    """Random bodies, truncated frames, corrupted CRCs, undecodable bodies,
    unknown kinds and a missing connect magic at a live listener: each is
    rejected and the listener still answers a well-formed request."""
    import asyncio
    import random

    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net import native_transport as nt
    from foundationdb_tpu_torch.net import transport as T
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.utils import wire

    loop = RealEventLoop()
    srv = NetTransport(loop, free_addr())
    cli = NetTransport(loop, free_addr())
    srv.start()
    cli.start()
    try:
        srv.process.register(7, lambda payload, reply: reply.send(payload))
        rng = random.Random(0xF0D8)
        good_body = wire.dumps("ping")

        def fuzz_bytes(trial: int) -> bytes:
            noise = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(1, 64)))
            shape = trial % 5
            if shape == 0:
                return noise
            if shape == 1:
                return T._HEADER.pack(1000, 7, 1, T._REQUEST,
                                      nt.crc32c(noise)) + noise
            if shape == 2:
                return T._HEADER.pack(len(good_body), 7, 1, T._REQUEST,
                                      nt.crc32c(good_body) ^ 0xDEAD
                                      ) + good_body
            if shape == 3:
                return T._HEADER.pack(len(noise), 7, 1, T._REQUEST,
                                      nt.crc32c(noise)) + noise
            return T._HEADER.pack(len(good_body), 7, 1, 9,
                                  nt.crc32c(good_body)) + good_body

        async def fuzz():
            host, port = srv.address.rsplit(":", 1)
            for trial in range(25):
                _reader, writer = await asyncio.open_connection(host,
                                                                int(port))
                if trial % 7 != 0:
                    writer.write(T._CONNECT)
                writer.write(fuzz_bytes(trial))
                try:
                    await writer.drain()
                except OSError:
                    pass
                writer.close()

        loop.aio.run_until_complete(asyncio.wait_for(fuzz(), 25.0))

        async def call():
            return await cli.request(cli.process,
                                     Endpoint(srv.address, 7), "alive")
        assert loop.run_future(loop.spawn(call()), max_time=10.0) == "alive"
        # the corrupted CRCs that came after the connect magic
        assert srv.transport_counters()["ChecksumRejects"] == sum(
            1 for trial in range(25) if trial % 5 == 2 and trial % 7)
    finally:
        srv.close()
        cli.close()


def test_read_frame_roundtrip_and_crc_reject():
    import asyncio

    from foundationdb_tpu_torch.net import transport as T
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.utils import wire

    loop = RealEventLoop()
    t = NetTransport(loop, "127.0.0.1:1")  # never started: pure framing
    frame = t._frame(7, 3, T._REPLY, wire.dumps(["hello", 7]))

    def feed(data: bytes):
        async def go():
            r = asyncio.StreamReader()
            r.feed_data(data)
            r.feed_eof()
            return await t._read_frame(r)
        return loop.run_future(loop.spawn(go()), max_time=5.0)

    assert feed(frame) == (7, 3, T._REPLY, ["hello", 7])
    with pytest.raises(ConnectionError):
        feed(frame[:-1] + bytes([frame[-1] ^ 1]))
    with pytest.raises(asyncio.IncompleteReadError):
        feed(frame[: len(frame) - 3])


def test_fail_pending_names_endpoint_and_cause():
    from foundationdb_tpu_torch.core.future import Promise
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.server.interfaces import Token

    loop = RealEventLoop()
    t = NetTransport(loop, "127.0.0.1:2")  # never started: no I/O here
    reply = Promise()
    t._pending[9] = (reply, "10.0.0.8:4500", None)
    t._fail_pending(9, "connect/encode failed",
                    dest=Endpoint("10.0.0.8:4500", Token.TLOG_COMMIT),
                    cause=OSError("connection refused"))
    fut = reply.future
    assert fut.is_ready() and fut.is_error()
    err = fut._result
    assert err.name == "broken_promise"
    assert "TLOG_COMMIT" in err.detail and "10.0.0.8:4500" in err.detail
    assert "OSError" in err.detail and "connection refused" in err.detail
    assert 9 not in t._pending


# ------------------------------------------------------- across packages

def _random_value(rng, depth=0):
    """A seeded wire value: every primitive the codec frames, nested."""
    kind = rng.integers(0, 9 if depth < 2 else 7)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-(1 << 62), 1 << 62))
    if kind == 3:
        return bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
    if kind == 4:
        return "".join(chr(c) for c in rng.integers(32, 0x3000,
                                                    rng.integers(0, 12)))
    if kind == 5:
        return float(rng.normal())
    if kind == 6:
        return int(rng.integers(0, 1 << 20)) * (1 << 40)
    if kind == 7:
        seq = [_random_value(rng, depth + 1)
               for _ in range(rng.integers(0, 4))]
        return tuple(seq) if rng.integers(0, 2) else seq
    return {f"k{i}": _random_value(rng, depth + 1)
            for i in range(rng.integers(0, 3))}


def _twin_structs(rng, t_wire, j_wire):
    """For every registered wire type, an instance in each package with the
    same seeded field values: [(type id, port object, JAX object)]."""
    import dataclasses
    from enum import IntEnum

    t_wire._ensure_registry()
    j_wire._ensure_registry()
    assert sorted(t_wire._BY_ID) == sorted(j_wire._BY_ID)
    out = []
    for tid in sorted(t_wire._BY_ID):
        t_cls, j_cls = t_wire._BY_ID[tid], j_wire._BY_ID[tid]
        assert t_cls.__name__ == j_cls.__name__
        if isinstance(t_cls, type) and issubclass(t_cls, IntEnum):
            member = list(t_cls)[rng.integers(0, len(t_cls))]
            out.append((tid, member, j_cls(int(member))))
            continue
        names = [f.name for f in dataclasses.fields(t_cls)]
        assert names == [f.name for f in dataclasses.fields(j_cls)]
        objs = []
        values = [_random_value(rng) for _ in names]
        for cls in (t_cls, j_cls):
            obj = object.__new__(cls)
            for name, value in zip(names, values):
                object.__setattr__(obj, name, value)
            objs.append(obj)
        out.append((tid, *objs))
    return out


def test_wire_frames_equal_the_jax_packages_bytes():
    """A seeded numpy fuzz over every wire type: the port's codec bodies,
    its transport `_frame`, `native_transport.frame` and `crc32c` equal the
    JAX package's byte for byte, and each side decodes the other's."""
    from foundationdb_tpu.net import native_transport as j_nt
    from foundationdb_tpu.utils import wire as j_wire
    from foundationdb_tpu_torch.net import native_transport as t_nt
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.utils import wire as t_wire

    rng = np.random.default_rng(19)
    t = NetTransport(RealEventLoop(), "127.0.0.1:1")  # framing only
    frames = 0
    for _round in range(3):
        for tid, t_obj, j_obj in _twin_structs(rng, t_wire, j_wire):
            payload = [t_obj, _random_value(rng)]
            j_payload = [j_obj, payload[1]]
            body = t_wire.dumps(payload)
            assert body == j_wire.dumps(j_payload), tid
            assert j_wire.dumps(t_wire.loads(body)[1]) == \
                j_wire.dumps(payload[1])
            assert type(j_wire.loads(body)[0]).__name__ == \
                type(t_obj).__name__
            token = int(rng.integers(0, 1 << 63))
            rid = int(rng.integers(0, 1 << 63))
            kind = int(rng.integers(0, 4))
            want = j_nt.frame(token, rid, kind, body)
            assert want == j_nt.py_frame(token, rid, kind, body)
            assert t._frame(token, rid, kind, body) == want
            assert t_nt.frame(token, rid, kind, body) == want
            assert t_nt.crc32c(body) == j_nt.crc32c(body)
            frames += 1
    assert frames == 3 * len(t_wire._BY_ID)
    assert t.transport_counters()["FramesOut"] == frames
    items = [(5, 1, "x"), (21, 2, [b"k", None])]
    assert t_nt.encode_batch(items) == j_nt.py_encode_batch(items)


def _cross_package(tmp_path, server, client, native=False):
    """Oracle backend: a client of one package against a server_main
    cluster of the other; each sees the rows it wrote and the rows another
    client wrote before it. With `native`, the servers run the C server
    plane (NET_NATIVE_TRANSPORT=1) and the clients the C client plane
    (NET_NATIVE_CLIENT=1, the caller's environment); returns the clients'
    transport counters."""
    module = {"jax": "foundationdb_tpu.net.server_main",
              "port": "foundationdb_tpu_torch.net.server_main"}[server]
    specs = cluster_specs(tmp_path, {"CONFLICT_BACKEND": "oracle"})
    env = server_env(NET_NATIVE_TRANSPORT="1") if native else None
    procs, counters = [], {}
    try:
        for spec in specs:
            procs.append(start_server(module, spec, env=env))
        proxy, storage = specs[0]["listen"], specs[1]["listen"]
        # the server's own package writes first, the other package reads
        # it and writes on top
        rows = {}
        for who, writes in ((server, [(b"a", b"1"), (b"b", b"2")]),
                            (client, [(b"c", b"3")])):
            if who == "port":
                loop, cli, db = port_client(proxy, storage)
            else:
                from foundationdb_tpu.client.database import (Database,
                                                              LocationCache)
                from foundationdb_tpu.net.transport import (NetTransport,
                                                            RealEventLoop)
                loop = RealEventLoop()
                cli = NetTransport(loop, free_addr())
                cli.start()
                db = Database(cli.process, proxies=[proxy],
                              locations=LocationCache([b""], [[storage]]))
            try:
                assert cli.native_client == native
                got, rows[who] = loop.run_future(
                    loop.spawn(write_and_read(db, writes)), max_time=60.0)
                counters[who] = cli.transport_counters()
            finally:
                cli.close()
            assert got == [v for _k, v in writes]
        assert [tuple(r) for r in rows[client]] == [
            (b"a", b"1"), (b"b", b"2"), (b"c", b"3")]
    finally:
        rcs = stop_servers(procs)
    assert rcs == [0, 0]
    return counters


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_cross_package_client_and_server(tmp_path, server, client):
    """Oracle backend: a port client against a JAX server_main cluster,
    and a JAX client against the port's; each sees the rows it wrote and
    the rows another client wrote before it."""
    _cross_package(tmp_path, server, client)


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_cross_package_native_planes(tmp_path, monkeypatch, server, client):
    """The same over the C planes: each package's servers with
    NET_NATIVE_TRANSPORT=1, its clients with NET_NATIVE_CLIENT=1; the
    clients' replies were settled by their C reply pumps."""
    monkeypatch.setenv("NET_NATIVE_CLIENT", "1")
    counters = _cross_package(tmp_path, server, client, native=True)
    for who in ("jax", "port"):
        assert counters[who]["ClientNativeSettles"] > 0, who
        assert counters[who]["ClientNativeBatches"] > 0, who


def test_device_server_without_a_card_exits_before_ready(tmp_path):
    """The default knobs put the resolvers on CUDA: without a card the
    process exits non-zero with platform_error and never prints ready."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    txn, _storage = cluster_specs(tmp_path, {})
    p = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.net.server_main",
         json.dumps(txn)], capture_output=True, cwd=ROOT, env=server_env(),
        timeout=READY_S)
    assert p.returncode != 0
    assert b"ready" not in p.stdout
    assert b"platform_error" in p.stderr


def test_real_process_modules_import_no_jax():
    """The port's server entry point, transport and operator tools load
    neither jax nor any foundationdb_tpu module."""
    code = ("import sys\n"
            "import foundationdb_tpu_torch.net.server_main\n"
            "import foundationdb_tpu_torch.net.transport\n"
            "import foundationdb_tpu_torch.tools.fdbmonitor\n"
            "import foundationdb_tpu_torch.tools.trace_analyze\n"
            "import foundationdb_tpu_torch.tools.networktest\n"
            "import foundationdb_tpu_torch.tools.fdbbackup\n"
            "import foundationdb_tpu_torch.net.server_main as m\n"
            "m.build_role\n"
            "bad = [n for n in sys.modules if n == 'jax'\n"
            "       or n.startswith(('jax.', 'foundationdb_tpu.'))\n"
            "       or n == 'foundationdb_tpu']\n"
            "print(bad)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       cwd=ROOT, env=server_env(), timeout=READY_S)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert p.stdout.decode().strip() == "[]"


def test_native_planes_serve_in_a_server_process(tmp_path, monkeypatch):
    """NET_NATIVE_TRANSPORT=1 in the spec's knobs: the port's server
    processes boot with the C server plane and serve a port client on the
    C client plane (NET_NATIVE_CLIENT=1) its reads and commits."""
    knobs = {"CONFLICT_BACKEND": "oracle", "NET_NATIVE_TRANSPORT": 1}
    monkeypatch.setenv("NET_NATIVE_CLIENT", "1")
    txn, storage = cluster_specs(tmp_path, knobs)
    procs = []
    try:
        for spec in (txn, storage):
            procs.append(start_server(
                "foundationdb_tpu_torch.net.server_main", spec))
        loop, cli, db = port_client(txn["listen"], storage["listen"])
        try:
            assert cli.native_client
            got, rows = loop.run_future(
                loop.spawn(write_and_read(db, [(b"n", b"1"), (b"m", b"2")])),
                max_time=60.0)
            counters = cli.transport_counters()
        finally:
            cli.close()
        assert got == [b"1", b"2"]
        assert [tuple(r) for r in rows] == [(b"m", b"2"), (b"n", b"1")]
        assert counters["ClientNativeSettles"] > 0
    finally:
        rcs = stop_servers(procs)
    assert rcs == [0, 0]
