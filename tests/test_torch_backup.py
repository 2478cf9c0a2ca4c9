"""The port's backup and restore against the JAX package's.

tests/test_backup.py's five tests and tests/test_backup_extras.py's two run
on both packages from the same seeds: the same clusters, the same backup
agents over the same kind of container, the same restores. Each run
records:

- every attempt's outcome: each commit's version or error name, and each
  error an attempt's body raised, with the virtual time it happened
  (test_torch_recovery.py's Recorder; DBInfos too, where a cluster
  controller publishes them);
- the container's files: each name with its bytes (the wire encoding of
  the chunk, the log entries, the meta file);
- the backup's end version, the source's contents at it, and the restored
  contents.

The two records must be equal, exactly, and the reference test's own
checks then hold on the port's run. The roundtrip test runs once more
under the device backend: the JAX side on its JAX engine
(CONFLICT_CPU_FALLBACK="jax", one compiled program), the port's engine on
its plain PyTorch versions (CONFLICT_DEVICE="cpu").

Cross-package checks: the port's table-driven CRC-32C equals the JAX
package's (its C extension where built) on seeded byte strings; each
package's HTTP client speaks to the other's blob store; and a directory
container one package's agent wrote restores through the other's.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_recovery as rec
from foundationdb_tpu import backup as j_backup
from foundationdb_tpu.backup import agent as j_agent
from foundationdb_tpu.backup import container as j_container
from foundationdb_tpu.backup import taskbucket as j_taskbucket
from foundationdb_tpu.net import http as j_http
from foundationdb_tpu.tools import fdbbackup as j_fdbbackup
from foundationdb_tpu.utils import rng as j_rng
from foundationdb_tpu.utils import types as j_types
from foundationdb_tpu_torch import backup as t_backup
from foundationdb_tpu_torch.backup import agent as t_agent
from foundationdb_tpu_torch.backup import container as t_container
from foundationdb_tpu_torch.backup import taskbucket as t_taskbucket
from foundationdb_tpu_torch.net import http as t_http
from foundationdb_tpu_torch.tools import fdbbackup as t_fdbbackup
from foundationdb_tpu_torch.utils import rng as t_rng
from foundationdb_tpu_torch.utils import types as t_types

# test_torch_coordination.py adds names to rec.PORT and rec.JAX when it
# is imported: extend copies of whatever they hold
PORT = SimpleNamespace(**{**vars(rec.PORT), **dict(
    backup=t_backup, agent=t_agent, container=t_container,
    taskbucket=t_taskbucket, http=t_http, fdbbackup=t_fdbbackup, rng=t_rng,
    types=t_types)})
JAX = SimpleNamespace(**{**vars(rec.JAX), **dict(
    backup=j_backup, agent=j_agent, container=j_container,
    taskbucket=j_taskbucket, http=j_http, fdbbackup=j_fdbbackup, rng=j_rng,
    types=j_types)})

_knobs = rec._knobs  # the autouse fixture: both banks on the oracle


def record(S, go):
    """Run `go(S)` under the Recorder's hooks, the recorder's clock
    following whichever cluster runs; returns the attempts, the DBInfos
    and what `go` returned."""
    with pytest.MonkeyPatch.context() as mp:
        r = rec.Recorder(S, mp)
        for cls in (S.cluster.SimCluster, S.cluster.RecoverableCluster):
            def run(c, future, max_time=1000.0, fn=cls.run):
                r.loop = c.loop
                return fn(c, future, max_time)
            mp.setattr(cls, "run", run)
        result = go(S, r)
    return SimpleNamespace(attempts=r.attempts, dbinfos=r.dbinfos,
                           result=result)


def both(go):
    """`go` on the port, then on the JAX package, held equal; the port's
    run."""
    port = record(PORT, go)
    jax = record(JAX, go)
    assert port.attempts == jax.attempts
    assert port.dbinfos == jax.dbinfos
    assert port.result == jax.result
    assert port.attempts  # something was compared
    return port


def files_of(container):
    """A container's files: name -> the bytes it holds."""
    if hasattr(container, "_files"):
        return dict(container._files)
    if hasattr(container, "path"):
        out = {}
        for name in container.list_files():
            with open(os.path.join(container.path, name), "rb") as f:
                out[name] = f.read()
        return out
    raise TypeError(type(container).__name__)


def user_rows(rows):
    return [(k, v) for k, v in rows if not k.startswith(b"\xff")]


# ---------------------------------------------------------------------------
# tests/test_backup.py
# ---------------------------------------------------------------------------

def taskbucket_scenario(S, r):
    c = S.cluster.SimCluster(seed=8, n_proxies=1, n_resolvers=1, n_tlogs=1,
                             n_storage=1)
    db = c.database()
    seen = []

    async def t():
        tb = S.taskbucket.TaskBucket(db, lease_seconds=2.0)
        seen.append(await tb.add({"n": 1}))
        seen.append(await tb.add({"n": 2}))
        k1, t1 = await tb.pop()
        k2, t2 = await tb.pop()
        assert {t1["n"], t2["n"]} == {1, 2}
        assert await tb.pop() is None  # both leased
        await tb.finish(k1)
        assert not await tb.is_empty()
        # k2's lease expires -> poppable again (crash-safety)
        await c.loop.delay(2.5)
        k3, t3 = await tb.pop()
        assert t3["n"] == t2["n"]
        await tb.finish(k3)
        assert await tb.is_empty()
        seen.extend([k1, k2, k3, t1, t2, t3])

    c.run(c.loop.spawn(t()), max_time=600.0)
    return seen, c.loop.now()


def test_taskbucket_pop_is_exclusive_and_leases_expire():
    port = both(taskbucket_scenario)
    keys = port.result[0]
    assert all(k.startswith(t_taskbucket.PREFIX) for k in keys[:5])


def roundtrip_scenario(S, r):
    """test_backup.py's roundtrip: a backup taken while writes land, two
    agents racing on the TaskBucket, a log tailer; restored into a fresh
    cluster."""
    MutationType = S.types.MutationType
    src = S.cluster.SimCluster(seed=9, n_proxies=2, n_resolvers=2,
                               n_tlogs=1, n_storage=2)
    db = src.database()
    container = S.backup.BackupContainer()
    ends = []

    async def t():
        async def seed(tr):
            for i in range(50):
                tr.set(b"pre/%03d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=200)

        agent = S.backup.BackupAgent(db, container, chunks=4)
        await agent.start()
        state = {"stop": False}

        async def writer():
            n = 0
            while not state["stop"]:
                async def w(tr, n=n):
                    tr.set(b"live/%04d" % n, b"x%d" % n)
                    tr.set(b"pre/%03d" % (n % 50), b"updated%d" % n)
                    if n % 7 == 0:
                        tr.clear_range(b"live/%04d" % max(0, n - 5),
                                       b"live/%04d" % max(1, n - 4))
                    tr.atomic_op(MutationType.ADD_VALUE, b"counter",
                                 (1).to_bytes(8, "little"))
                await db.transact(w, max_retries=200)
                n += 1
                await src.loop.delay(0.05)
        wtask = src.loop.spawn(writer(), name="bgwriter")

        a1 = src.loop.spawn(agent.run_agent(), name="agent1")
        a2 = src.loop.spawn(agent.run_agent(), name="agent2")
        tailer = src.loop.spawn(agent.run_log_tailer(), name="tailer")
        await a1
        await a2

        await src.loop.delay(1.0)
        end_version = await agent.stop()
        ends.append(end_version)
        await tailer

        async def late(tr):
            tr.set(b"late/after-stop", b"nope")
        await db.transact(late, max_retries=200)

        async def readall(tr):
            tr._read_version = end_version
            return await tr.get_range(b"", b"\xff")
        truth = user_rows(await db.transact(readall, max_retries=200))

        state["stop"] = True
        await wtask
        return truth

    truth = src.run(src.loop.spawn(t()), max_time=600_000.0)
    dst = S.cluster.SimCluster(seed=10, n_proxies=1, n_resolvers=1,
                               n_tlogs=1, n_storage=2)
    db2 = dst.database()

    async def restore():
        applied = await S.backup.RestoreAgent(db2, container).restore()

        async def readall(tr):
            return await tr.get_range(b"", b"\xff")
        return applied, user_rows(await db2.transact(readall,
                                                     max_retries=200))

    applied, got = dst.run(dst.loop.spawn(restore()), max_time=600_000.0)
    return dict(files=files_of(container), end_version=ends[0],
                truth=truth, applied=applied, restored=got,
                src_end=src.loop.now(), dst_end=dst.loop.now())


def check_roundtrip(out):
    """test_backup.py's own checks on one run."""
    got, truth = out["restored"], out["truth"]
    assert got == truth, (
        f"restore mismatch: {len(got)} vs {len(truth)} rows; "
        f"missing={set(dict(truth)) - set(dict(got))} "
        f"extra={set(dict(got)) - set(dict(truth))}")
    assert not any(k.startswith(b"late/") for k, _v in got)
    names = sorted(out["files"])
    assert "meta" in names and any(n.startswith("log-") for n in names)
    assert sum(n.startswith("kvrange-") for n in names) >= 4
    assert out["applied"] > 0


def test_backup_restore_roundtrip_under_write_load():
    port = both(roundtrip_scenario)
    check_roundtrip(port.result)


def test_backup_restore_roundtrip_under_the_device_backend(monkeypatch):
    """The roundtrip with every resolver of both clusters on the device
    backend: the port's engines on their plain versions, the JAX side on
    its JAX engine, at test_torch_cluster.py's small shape."""
    import test_torch_cluster as tc
    rec.set_knobs(CONFLICT_BACKEND="device", **tc.SHAPE_KNOBS)
    port = both(roundtrip_scenario)
    check_roundtrip(port.result)


def recovery_midstream_scenario(S, r):
    S.knobs.set("DD_INTERVAL_SECONDS", 3600.0)
    src = S.cluster.RecoverableCluster(seed=41, n_workers=5, n_proxies=2,
                                       n_tlogs=2, n_storage=2, n_replicas=1)
    db = src.database()
    container = S.backup.BackupContainer()
    ends = []

    async def t():
        await db.refresh()

        async def seed(tr):
            for i in range(30):
                tr.set(b"k%03d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=500)

        agent = S.backup.BackupAgent(db, container, chunks=2)
        await agent.start()
        a1 = src.loop.spawn(agent.run_agent(), name="agent1")
        await a1

        cc = src.current_cc()
        src.net.kill(cc.dbinfo.master, S.sim.KillType.RebootProcess)

        for i in range(30, 60):
            async def w(tr, i=i):
                tr.set(b"k%03d" % i, b"v%d" % i)
            await db.transact(w, max_retries=500)

        tailer = src.loop.spawn(agent.run_log_tailer(), name="tailer")
        end_version = await agent.stop()
        ends.append(end_version)
        await tailer

        async def readall(tr):
            tr._read_version = end_version
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db.transact(readall, max_retries=500))

    truth = src.run(src.loop.spawn(t()), max_time=600_000.0)
    dst = S.cluster.SimCluster(seed=12, n_proxies=1, n_resolvers=1,
                               n_tlogs=1, n_storage=1)
    db2 = dst.database()

    async def restore():
        await S.backup.RestoreAgent(db2, container).restore()

        async def readall(tr):
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db2.transact(readall, max_retries=200))

    got = dst.run(dst.loop.spawn(restore()), max_time=600_000.0)
    return dict(files=files_of(container), end_version=ends[0],
                truth=truth, restored=got, src_end=src.loop.now())


def test_backup_survives_recovery_midstream():
    port = both(recovery_midstream_scenario)
    out = port.result
    assert len([k for k, _ in out["truth"] if k.startswith(b"k")]) == 60
    assert out["restored"] == out["truth"]
    assert port.dbinfos  # the kill forced a recovery: DBInfos were compared


def cli_scenario(tmp_path):
    def go(S, r):
        B = S.fdbbackup
        src = S.cluster.SimCluster(seed=21, n_proxies=1, n_resolvers=1,
                                   n_tlogs=1, n_storage=1)
        db = src.database()
        d = str(tmp_path / f"container-{S.name}")
        said = []

        async def t():
            async def seed(tr):
                for i in range(20):
                    tr.set(b"b%02d" % i, b"v%d" % i)
            await db.transact(seed, max_retries=200)
            said.append(await B.run_command(db, ["status"]))
            said.append(await B.run_command(db, ["start", "-d", d]))
            said.append(await B.run_command(db, ["status"]))

            async def more(tr):
                tr.set(b"b99", b"late")
            await db.transact(more, max_retries=200)
            said.append(await B.run_command(db, ["stop", "-d", d]))
            said.append(await B.run_command(db, ["status"]))
        src.run(src.loop.spawn(t()), max_time=600_000.0)

        dst = S.cluster.SimCluster(seed=22, n_proxies=1, n_resolvers=1,
                                   n_tlogs=1, n_storage=1)
        db2 = dst.database()

        async def restore():
            said.append(await B.run_command(db2, ["restore", "-d", d]))

            async def readall(tr):
                return await tr.get_range(b"", b"\xff")
            return user_rows(await db2.transact(readall, max_retries=200))
        rows = dst.run(dst.loop.spawn(restore()), max_time=600_000.0)
        return dict(said=said, rows=rows,
                    files=files_of(S.container.DirBackupContainer(d)))
    return go


def test_fdbbackup_cli_commands(tmp_path):
    port = both(cli_scenario(tmp_path))
    said = port.result["said"]
    assert "no backup" in said[0]
    assert "snapshot complete" in said[1]
    assert "state: active" in said[2]
    assert "restorable" in said[3]
    assert "state: stopped" in said[4]
    keys = dict(port.result["rows"])
    assert keys.get(b"b99") == b"late"
    assert len([k for k in keys if k.startswith(b"b")]) == 21


def fault_cocktail_scenario(S, r):
    KillType = S.sim.KillType
    FDBError = S.errors.FDBError
    MutationType = S.types.MutationType
    src = S.cluster.RecoverableCluster(seed=43, n_workers=5, n_proxies=2,
                                       n_tlogs=2, n_storage=2, n_replicas=1)
    db = src.database()
    container = S.backup.BackupContainer()
    rng = S.rng.DeterministicRandom(4302)
    ends = []

    async def t():
        await db.refresh(max_wait=120.0)

        async def seed(tr):
            for i in range(40):
                tr.set(b"fc/%03d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=500)

        agent = S.backup.BackupAgent(db, container, chunks=3)
        await agent.start()
        state = {"stop": False}

        async def writer():
            n = 0
            while not state["stop"]:
                async def w(tr, n=n):
                    tr.set(b"fc/live/%04d" % n, b"x%d" % n)
                    tr.set(b"fc/%03d" % (n % 40), b"u%d" % n)
                    if n % 5 == 0:
                        tr.clear_range(b"fc/live/%04d" % max(0, n - 4),
                                       b"fc/live/%04d" % max(1, n - 3))
                    tr.atomic_op(MutationType.ADD_VALUE, b"fc/ctr",
                                 (1).to_bytes(8, "little"))
                try:
                    await db.transact(w, max_retries=1000)
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
                n += 1
                await src.loop.delay(0.1)
        wtask = src.loop.spawn(writer(), name="fcWriter")

        async def faults():
            workers = [p.address for p in src.worker_procs]
            everyone = workers + [p.address
                                  for p in src.storage_worker_procs]
            for _ in range(6):
                await src.loop.delay(1.5 + rng.random())
                a = everyone[rng.randint(0, len(everyone) - 1)]
                b = everyone[rng.randint(0, len(everyone) - 1)]
                if a != b:
                    src.net.clog_pair(a, b, 2.0 * rng.random())
                if rng.coinflip(0.5):
                    victim = workers[rng.randint(0, len(workers) - 1)]
                    src.net.kill(victim, KillType.RebootProcess)
        ftask = src.loop.spawn(faults(), name="fcFaults")

        a1 = src.loop.spawn(agent.run_agent(), name="agent1")
        tailer = src.loop.spawn(agent.run_log_tailer(), name="tailer")
        await a1
        await ftask
        src.net.heal()
        src.net.reboot_dead([p.address for p in src.cluster_procs()])
        await src.loop.delay(1.0)

        state["stop"] = True
        await wtask
        end_version = await agent.stop()
        ends.append(end_version)
        await tailer

        async def readall(tr):
            tr._read_version = end_version
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db.transact(readall, max_retries=500))

    truth = src.run(src.loop.spawn(t()), max_time=600_000.0)
    dst = S.cluster.SimCluster(seed=44, n_proxies=1, n_resolvers=1,
                               n_tlogs=1, n_storage=2)
    db2 = dst.database()

    async def restore():
        await S.backup.RestoreAgent(db2, container).restore()

        async def readall(tr):
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db2.transact(readall, max_retries=200))

    got = dst.run(dst.loop.spawn(restore()), max_time=600_000.0)
    return dict(files=files_of(container), end_version=ends[0],
                truth=truth, restored=got, src_end=src.loop.now())


def test_backup_restore_under_fault_cocktail():
    port = both(fault_cocktail_scenario)
    got, truth = port.result["restored"], port.result["truth"]
    assert len(truth) > 40, "fault cocktail starved the workload"
    assert got == truth, (
        f"restore mismatch under faults: {len(got)} vs {len(truth)} rows; "
        f"missing={set(dict(truth)) - set(dict(got))} "
        f"extra={set(dict(got)) - set(dict(truth))}")


# ---------------------------------------------------------------------------
# tests/test_backup_extras.py
# ---------------------------------------------------------------------------

def blob_protocol(conn):
    """test_backup_extras.py's protocol exchange over one connection; the
    (status, body, has checksum) of every request."""
    out = []

    def req(*a):
        st, h, body = conn.request(*a)
        out.append((st, body, "x-crc32c" in h))
    req("PUT", "/b/x%20y", {"x-crc32c": "0"}, b"payload")
    req("GET", "/b/x%20y")
    req("GET", "/b/missing")
    req("PUT", "/b/log-1", {}, b"a")
    req("PUT", "/b/log-2", {}, b"b")
    req("GET", "/b?prefix=log-")
    req("DELETE", "/b/log-1")
    req("GET", "/b?prefix=log-")
    conn.close()
    return out


def check_blob_protocol(out):
    assert out[0][0] == 200
    assert out[1] == (200, b"payload", True)
    assert out[2][0] == 404
    assert out[5][:2] == (200, b"log-1\nlog-2")
    assert out[7][1] == b"log-2"


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("jax", "jax"), ("jax", "port"), ("port", "jax")])
def test_blobstore_http_protocol(server_pkg, client_pkg):
    """The HTTP client and the object store speak the S3-ish subset, each
    package's client to each package's server alike; the checksum the
    server sends is the client package's CRC-32C of the body."""
    pkg = {"port": PORT, "jax": JAX}
    srv = pkg[server_pkg].http.BlobStoreServer()
    try:
        client = pkg[client_pkg].http
        out = blob_protocol(client.HTTPConnection(srv.host, srv.port))
        check_blob_protocol(out)
        conn = client.HTTPConnection(srv.host, srv.port)
        conn.request("PUT", "/b/sum", {}, b"checked bytes")
        _st, h, body = conn.request("GET", "/b/sum")
        conn.close()
        assert int(h["x-crc32c"]) == client._crc32c(body)
    finally:
        srv.close()
    if server_pkg == client_pkg == "port":
        srv = JAX.http.BlobStoreServer()
        try:
            assert out == blob_protocol(
                JAX.http.HTTPConnection(srv.host, srv.port))
        finally:
            srv.close()


def test_crc32c_equals_the_jax_package_on_seeded_bytes():
    """The port's table-driven CRC-32C equals the JAX package's (its C
    extension where built, else its table) on seeded byte strings of 0 to
    64 KB: a blob either package writes passes the other's check."""
    rng = np.random.default_rng(18)
    sizes = [0, 1, 2, 3, 7, 8, 9, 63, 64, 65, 1000, 4096, 65536]
    sizes += rng.integers(0, 65537, 12).tolist()
    for n in sizes:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_http._crc32c(data) == j_http._crc32c(data), n
    # the standard check value of CRC-32C
    assert t_http._crc32c(b"123456789") == 0xE3069283


def pit_scenario(S, r):
    """test_backup_extras.py's point-in-time restore: a backup through the
    blob store under write load, restored into a live (dirty) cluster at
    a version inside the window, then at the end version, then refused
    below the window."""
    MutationType = S.types.MutationType
    FDBError = S.errors.FDBError
    srv = S.http.BlobStoreServer()
    try:
        src = S.cluster.SimCluster(seed=21, n_proxies=2, n_storage=2)
        db = src.database()
        container = S.container.BlobStoreBackupContainer(srv.url)

        async def read_all(db):
            async def rd(tr):
                return await tr.get_range(b"", b"\xff", limit=100_000)
            return user_rows(await db.transact(rd, max_retries=500))

        async def t():
            async def seed(tr):
                for i in range(60):
                    tr.set(b"pre/%03d" % i, b"v%d" % i)
            await db.transact(seed, max_retries=200)

            agent = S.backup.BackupAgent(db, container, chunks=4)
            await agent.start()
            await agent.run_agent()
            tailer = src.loop.spawn(agent.run_log_tailer(), name="tailer")

            async def phase_a(tr):
                for i in range(20):
                    tr.set(b"live/a%03d" % i, b"A%d" % i)
                tr.clear_range(b"pre/000", b"pre/005")
                tr.atomic_op(MutationType.ADD_VALUE, b"ctr",
                             (3).to_bytes(8, "little"))
            await db.transact(phase_a, max_retries=200)
            marker_tr = [None]

            async def marker(tr):
                marker_tr[0] = tr
                tr.set(b"\xff/pit-fence", b"x")
            await db.transact(marker, max_retries=200)
            t_a = marker_tr[0].committed_version
            expected_a = await read_all(db)

            async def phase_b(tr):
                for i in range(10):
                    tr.set(b"live/b%03d" % i, b"B%d" % i)
                tr.clear_range(b"live/a000", b"live/a003")
                tr.atomic_op(MutationType.ADD_VALUE, b"ctr",
                             (9).to_bytes(8, "little"))
            await db.transact(phase_b, max_retries=200)
            end_version = await agent.stop()
            await tailer
            expected_full = await read_all(db)

            dst = S.cluster.SimCluster(seed=22, n_storage=2, loop=src.loop,
                                       net=src.net, name_prefix="dst-")
            ddb = dst.database("clientD:0")

            async def dirty(tr):
                for i in range(30):
                    tr.set(b"pre/%03d" % i, b"JUNK")
                    tr.set(b"live/a%03d" % i, b"JUNK")
                tr.set(b"ctr", b"JUNK8byte")
            await ddb.transact(dirty, max_retries=200)

            restore = S.backup.RestoreAgent(ddb, container)
            await restore.restore(target_version=t_a)
            got_a = await read_all(ddb)
            await restore.restore()
            got_full = await read_all(ddb)
            refused = None
            try:
                await restore.restore(target_version=1)
            except FDBError as e:
                refused = e.name
            return dict(t_a=t_a, end_version=end_version,
                        expected_a=expected_a, expected_full=expected_full,
                        got_a=got_a, got_full=got_full, refused=refused)

        out = src.run(src.loop.spawn(t()), max_time=600_000.0)
        with srv._lock:
            out["objects"] = dict(srv._objects)
        out["end"] = src.loop.now()
        return out
    finally:
        srv.close()


def test_backup_to_blobstore_and_pit_restore_into_live_cluster():
    port = both(pit_scenario)
    out = port.result
    assert out["expected_full"] != out["expected_a"]
    assert out["got_a"] == out["expected_a"], (
        f"PIT restore diverges: {len(out['got_a'])} vs "
        f"{len(out['expected_a'])} rows")
    assert out["got_full"] == out["expected_full"]
    assert out["refused"] == "restore_invalid_version"
    assert any(k.startswith("backup/kvrange-") for k in out["objects"])


# ---------------------------------------------------------------------------
# a directory container across the packages
# ---------------------------------------------------------------------------

def dir_backup(S, d):
    """Back up a loaded SimCluster into directory `d` with `S`'s agent
    under a few live writes; the source's user rows at the end version."""
    MutationType = S.types.MutationType
    src = S.cluster.SimCluster(seed=31, n_proxies=2, n_resolvers=2,
                               n_storage=2)
    db = src.database()
    container = S.container.DirBackupContainer(d)

    async def t():
        async def seed(tr):
            for i in range(40):
                tr.set(b"x/%03d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=200)
        agent = S.backup.BackupAgent(db, container, chunks=3)
        await agent.start()
        tailer = src.loop.spawn(agent.run_log_tailer(), name="tailer")
        await agent.run_agent()
        for n in range(6):
            async def w(tr, n=n):
                tr.set(b"x/%03d" % (n * 5), b"u%d" % n)
                tr.clear_range(b"x/%03d" % (n * 5 + 1),
                               b"x/%03d" % (n * 5 + 2))
                tr.atomic_op(MutationType.ADD_VALUE, b"x/ctr",
                             (2).to_bytes(8, "little"))
            await db.transact(w, max_retries=200)
        end_version = await agent.stop()
        await tailer

        async def readall(tr):
            tr._read_version = end_version
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db.transact(readall, max_retries=200))
    return src.run(src.loop.spawn(t()), max_time=600_000.0)


def dir_restore(S, d):
    dst = S.cluster.SimCluster(seed=32, n_storage=2)
    db = dst.database()

    async def t():
        await S.backup.RestoreAgent(db, S.container.DirBackupContainer(
            d)).restore()

        async def readall(tr):
            return await tr.get_range(b"", b"\xff")
        return user_rows(await db.transact(readall, max_retries=200))
    return dst.run(dst.loop.spawn(t()), max_time=600_000.0)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_directory_container_restores_across_packages(tmp_path, writer,
                                                      reader):
    """A directory container one package's agent wrote restores through
    the other's to the source's rows at the end version; both packages
    write the same files byte for byte."""
    pkg = {"port": PORT, "jax": JAX}
    d = str(tmp_path / "c")
    truth = dir_backup(pkg[writer], d)
    assert len(truth) > 30
    assert dir_restore(pkg[reader], d) == truth
    d2 = str(tmp_path / "c2")
    assert dir_backup(pkg[reader], d2) == truth
    assert files_of(t_container.DirBackupContainer(d)) == \
        files_of(t_container.DirBackupContainer(d2))


def test_backup_dr_layers_and_tools_import_neither_jax_nor_the_jax_package():
    import pathlib
    import subprocess
    import sys
    code = ("import sys\n"
            "import foundationdb_tpu_torch.backup\n"
            "import foundationdb_tpu_torch.backup.dr\n"
            "import foundationdb_tpu_torch.net.http\n"
            "import foundationdb_tpu_torch.tools.fdbbackup\n"
            "import foundationdb_tpu_torch.tools.fdbcli\n"
            "import foundationdb_tpu_torch.layers\n"
            "import foundationdb_tpu_torch.layers.recipes\n"
            "import foundationdb_tpu_torch.testing\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'foundationdb_tpu')]\n"
            "assert not bad, bad\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)
