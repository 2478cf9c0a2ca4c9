"""The port's operator tools over the real transport.

tests/test_fdbmonitor.py's start, restart-with-backoff and reload on the
port's fdbmonitor and server_main processes; tests/test_aux_surface.py's
transport TLS (mutual auth and the verify-peers clauses; skips without
openssl, as there) and sampling profiler on the port's modules; and
fdbbackup's main (start, status, stop) against a port cluster of real
processes, its container then restored into a simulated cluster.
"""

import contextlib
import io
import json
import os
import subprocess
import time

import pytest

from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

from test_torch_transport import (SHAPE_KNOBS, cluster_specs, free_addr,
                                  free_port, start_server, stop_servers)


@pytest.fixture(autouse=True)
def _knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


# ------------------------------------------------------------- fdbmonitor

def _write_conf(path, sections, restart_delay=0.2):
    lines = ["[general]", f"restart_delay = {restart_delay}",
             "restart_delay_reset = 5"]
    for name, spec in sections.items():
        lines += [f"[server.{name}]", f"spec = {spec}"]
    path.write_text("\n".join(lines) + "\n")


def _spec_file(tmp_path, name, port):
    """A server_main spec with no roles (the process just listens); its
    knobs keep the resolvers' device on the CPU, as on a card-less box."""
    spec = {"listen": f"127.0.0.1:{port}", "data_dir": str(tmp_path / name),
            "knobs": {"CONFLICT_DEVICE": "cpu"}, "roles": []}
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(spec))
    return str(p)


def test_monitor_starts_restarts_and_reloads(tmp_path):
    from foundationdb_tpu_torch.tools.fdbmonitor import FdbMonitor

    conf = tmp_path / "monitor.conf"
    _write_conf(conf, {"a": _spec_file(tmp_path, "a", free_port())})
    mon = FdbMonitor(str(conf), out=open(os.devnull, "w"))
    try:
        mon.poll_once()
        c = mon.children["server.a"]
        assert c.proc is not None and c.proc.poll() is None
        assert c.args()[1:3] == ["-m", "foundationdb_tpu_torch.net.server_main"]

        c.proc.kill()
        c.proc.wait(timeout=20)
        mon.poll_once()
        assert c.proc is None and c.backoff > 0
        deadline = time.time() + 20
        while time.time() < deadline and c.proc is None:
            time.sleep(0.1)
            mon.poll_once()
        assert c.proc is not None and c.proc.poll() is None, "never restarted"

        time.sleep(0.05)
        _write_conf(conf, {"b": _spec_file(tmp_path, "b", free_port())})
        os.utime(conf)
        mon.poll_once()
        assert "server.a" not in mon.children
        assert "server.b" in mon.children
        deadline = time.time() + 20
        b = mon.children["server.b"]
        while time.time() < deadline and b.proc is None:
            time.sleep(0.1)
            mon.poll_once()
        assert b.proc is not None and b.proc.poll() is None
        # the supervised server stays up: it was not a crash loop
        time.sleep(1.0)
        assert b.proc.poll() is None
    finally:
        for c in list(mon.children.values()):
            mon.stop_child(c)


# -------------------------------------------------------------------- TLS

def _make_certs(tmp, ca_cn="fdbtpu-ca"):
    def run(*args):
        subprocess.run(args, check=True, capture_output=True, timeout=60)
    ca_key, ca_crt = tmp / "ca.key", tmp / "ca.crt"
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(ca_key), "-out", str(ca_crt), "-days", "1",
        "-subj", f"/CN={ca_cn}")
    out = {}
    for name in ("server", "client"):
        key, csr, crt = (tmp / f"{name}.key", tmp / f"{name}.csr",
                         tmp / f"{name}.crt")
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(key), "-out", str(csr), "-subj", f"/CN={name}")
        run("openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
            "-CAkey", str(ca_key), "-CAcreateserial", "-out", str(crt),
            "-days", "1")
        out[name] = (str(crt), str(key))
    return str(ca_crt), out


def test_transport_tls_mutual_auth_and_verify_peers(tmp_path):
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.net.tls import TLSConfig
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    try:
        ca, certs = _make_certs(tmp_path)
    except (FileNotFoundError, subprocess.CalledProcessError):
        pytest.skip("openssl unavailable")

    loop = RealEventLoop()
    server_tls = TLSConfig(*certs["server"], ca_path=ca,
                           verify_peers="Check.Valid=1,I.CN=fdbtpu-ca")
    client_tls = TLSConfig(*certs["client"], ca_path=ca)
    srv = NetTransport(loop, free_addr(), tls=server_tls)
    cli = NetTransport(loop, free_addr(), tls=client_tls)
    srv.start()
    cli.start()
    srv.process.register(7001, lambda req, reply: reply.send(req + b"!"))
    bad = None
    try:
        async def roundtrip():
            return await cli.request(cli.process,
                                     Endpoint(srv.address, 7001), b"hello")
        assert loop.run_future(loop.spawn(roundtrip()),
                               max_time=30.0) == b"hello!"

        # an un-authenticated (wrong-CA) client is rejected by the handshake
        (tmp_path / "other").mkdir(exist_ok=True)
        ca2, certs2 = _make_certs(tmp_path / "other", ca_cn="evil-ca")
        bad = NetTransport(loop, free_addr(),
                           tls=TLSConfig(*certs2["client"], ca_path=ca2))
        bad.start()

        async def bad_roundtrip():
            return await loop.timeout(
                bad.request(bad.process, Endpoint(srv.address, 7001), b"x"),
                5.0)
        with pytest.raises(FDBError):
            loop.run_future(loop.spawn(bad_roundtrip()), max_time=30.0)
    finally:
        for t in (cli, bad, srv):
            if t is not None:
                t.close()

    peer = {"subject": ((("commonName", "client"),),),
            "issuer": ((("commonName", "fdbtpu-ca"),),)}
    assert not TLSConfig(*certs["server"], ca_path=ca,
                         verify_peers="Check.Valid=1,S.CN=somebody-else"
                         ).check_peer(peer)
    assert TLSConfig(*certs["server"], ca_path=ca,
                     verify_peers="Check.Valid=1,S.CN=client").check_peer(peer)
    # unknown clauses fail closed; no certificate fails a CN clause
    assert not TLSConfig("c", "k", verify_peers="O.X=1").check_peer(peer)
    assert not TLSConfig("c", "k", verify_peers="S.CN=client").check_peer(
        None)


# --------------------------------------------------------------- profiler

def test_sampling_profiler_finds_the_hot_function():
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.profiler import SamplingProfiler

    def hot_spin(deadline):
        x = 0
        while time.monotonic() < deadline:
            x += 1
        return x

    p = SamplingProfiler(interval=0.001)
    p.start()
    hot_spin(time.monotonic() + 0.4)
    report = p.stop()
    assert p.total_samples > 20
    hottest = p.hottest_functions(top=3)
    assert any("hot_spin" in label for label, _n in hottest), hottest
    assert report and report[0][1] >= 1
    got = []
    trace.set_sink(got.append)
    try:
        p.trace_report(who="test")
    finally:
        trace.set_sink(None)
    assert got and {e["Type"] for e in got} == {"ProfilerSample"}
    assert any("hot_spin" in e["Where"] for e in got)


# -------------------------------------------------------------- fdbbackup

def test_fdbbackup_main_against_real_processes(tmp_path):
    """fdbbackup's main opens a NetTransport client to a port cluster of
    real processes (the device backend on the CPU): `start` snapshots into
    a directory container, `status` reads the backup's state keys, `stop`
    makes it restorable; the container restores into a simulated cluster
    with the rows written before the backup."""
    from foundationdb_tpu_torch.backup import RestoreAgent
    from foundationdb_tpu_torch.backup.container import DirBackupContainer
    from foundationdb_tpu_torch.server.cluster import SimCluster
    from foundationdb_tpu_torch.tools import fdbbackup

    from test_torch_transport import port_client, write_and_read

    knobs = {"CONFLICT_BACKEND": "device", "CONFLICT_DEVICE": "cpu",
             **SHAPE_KNOBS}
    specs = cluster_specs(tmp_path, knobs)
    proxy, storage = specs[0]["listen"], specs[1]["listen"]
    rows = [(b"bk%02d" % i, b"v%02d" % i) for i in range(12)]
    procs = []
    try:
        for spec in specs:
            procs.append(start_server("foundationdb_tpu_torch.net.server_main",
                                      spec))
        loop, client, db = port_client(proxy, storage)
        try:
            loop.run_future(loop.spawn(write_and_read(db, rows)),
                            max_time=60.0)
        finally:
            client.close()
        backup_dir = str(tmp_path / "backup")
        said = {}
        for cmd in (["status"], ["start", "-d", backup_dir], ["status"],
                    ["stop", "-d", backup_dir]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert fdbbackup.main(["--cluster", proxy, "--storage",
                                       storage, *cmd]) == 0
            said.setdefault(cmd[0], []).append(buf.getvalue().strip())
    finally:
        rcs = stop_servers(procs)
    assert rcs == [0, 0]
    assert said["status"][0] == "no backup has ever been started"
    assert said["start"] == [
        "backup started; snapshot complete; log tee active"]
    assert said["status"][1].startswith("state: ")
    assert said["stop"][0].startswith("backup stopped; restorable at "
                                      "end_version ")

    TKNOBS.set("CONFLICT_BACKEND", "oracle")
    c = SimCluster(seed=3)
    rdb = c.database()

    async def restore():
        await RestoreAgent(rdb, DirBackupContainer(backup_dir)).restore()

        async def read(tr):
            return await tr.get_range(b"bk", b"bl")
        return await rdb.transact(read)
    got = c.run(c.loop.spawn(restore()), max_time=600.0)
    assert [tuple(kv) for kv in got] == rows
