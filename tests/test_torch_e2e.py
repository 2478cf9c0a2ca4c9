"""End-to-end tests of the port's commit pipeline under the simulator.

The scenarios of tests/test_e2e.py, with the same assertions, driven
through the port's public Transaction API against the port's SimCluster
(SURVEY.md §4's workload strategy): Cycle (Cycle.actor.cpp
serializability ring), AtomicOps, WriteDuringRead (RYW semantics),
Watches. Every scenario runs under the oracle conflict backend; the ones
that decide commits through the resolver (round trip, conflict, Cycle,
multi-resolver, too-old, multi-tlog/multi-storage) also run under the
device backend, the port's engine on its plain PyTorch versions
(CONFLICT_DEVICE=cpu) at a small shape.
"""

import pytest

from foundationdb_tpu_torch.core.sim import KillType, SimFile
from foundationdb_tpu_torch.server.cluster import SimCluster
from foundationdb_tpu_torch.server.interfaces import KeySelector
from foundationdb_tpu_torch.storage.diskqueue import DiskQueue
from foundationdb_tpu_torch.storage.kvstore import MemoryKeyValueStore
from foundationdb_tpu_torch.utils import trace
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom
from foundationdb_tpu_torch.utils.types import MutationType

BACKENDS = pytest.mark.parametrize("backend", ["oracle", "device"],
                                   indirect=True)


def make_cluster(**kw):
    kw.setdefault("seed", 1)
    return SimCluster(**kw)


@pytest.fixture(autouse=True)
def _oracle_backend():
    # the port's knob bank is not the one the conftest resets
    KNOBS.reset()
    KNOBS.set("CONFLICT_BACKEND", "oracle")
    trace.set_sink(lambda _fields: None)
    yield
    trace.set_sink(None)
    KNOBS.reset()


@pytest.fixture
def backend(request):
    KNOBS.set("CONFLICT_BACKEND", request.param)
    if request.param == "device":
        KNOBS.overrides(CONFLICT_DEVICE="cpu", CONFLICT_STATE_CAPACITY=1024,
                        CONFLICT_BATCH_TXNS=64)
    return request.param


@BACKENDS
def test_set_and_get_roundtrip(backend):
    c = make_cluster()
    db = c.database()

    async def writer():
        tr = db.create_transaction()
        tr.set(b"hello", b"world")
        tr.set(b"foo", b"bar")
        await tr.commit()
        assert tr.committed_version is not None and tr.committed_version > 0

    async def reader():
        tr = db.create_transaction()
        assert await tr.get(b"hello") == b"world"
        assert await tr.get(b"foo") == b"bar"
        assert await tr.get(b"missing") is None

    c.run(c.loop.spawn(writer()))
    c.run(c.loop.spawn(reader()))


def test_read_your_writes_and_clears():
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        tr.set(b"a", b"1")
        assert await tr.get(b"a") == b"1"  # uncommitted write visible
        tr.clear(b"a")
        assert await tr.get(b"a") is None
        tr.set(b"b", b"2")
        tr.clear_range(b"a", b"c")
        assert await tr.get(b"b") is None
        tr.set(b"b", b"3")  # set after clear wins
        assert await tr.get(b"b") == b"3"
        await tr.commit()

        tr2 = db.create_transaction()
        assert await tr2.get(b"a") is None
        assert await tr2.get(b"b") == b"3"

    c.run(c.loop.spawn(t()))


@BACKENDS
def test_conflict_between_transactions(backend):
    c = make_cluster()
    db = c.database()
    outcome = {}

    async def t():
        t1 = db.create_transaction()
        t2 = db.create_transaction()
        # both read k, both write k: second committer must abort
        await t1.get(b"k")
        await t2.get(b"k")
        t1.set(b"k", b"t1")
        t2.set(b"k", b"t2")
        await t1.commit()
        try:
            await t2.commit()
            outcome["t2"] = "committed"
        except FDBError as e:
            outcome["t2"] = e.name

    c.run(c.loop.spawn(t()))
    assert outcome["t2"] == "not_committed"


def test_snapshot_read_does_not_conflict():
    c = make_cluster()
    db = c.database()

    async def t():
        t1 = db.create_transaction()
        t2 = db.create_transaction()
        await t1.get(b"k", snapshot=True)  # snapshot: no read conflict
        await t2.get(b"k")
        t1.set(b"k", b"t1")
        t2.set(b"other", b"x")
        await t2.commit()
        await t1.commit()  # would abort if the read were conflict-checked

    c.run(c.loop.spawn(t()))


def test_transact_retry_loop():
    c = make_cluster()
    db = c.database()
    counter_key = b"counter"

    async def incr(tr):
        v = await tr.get(counter_key)
        n = int(v or b"0")
        tr.set(counter_key, str(n + 1).encode())

    async def t():
        # 10 concurrent increments; the retry loop must serialize them
        from foundationdb_tpu_torch.core.future import all_of
        tasks = [c.loop.spawn(db.transact(incr), name=f"incr{i}")
                 for i in range(10)]
        await all_of(tasks)
        tr = db.create_transaction()
        assert await tr.get(counter_key) == b"10"

    c.run(c.loop.spawn(t()), max_time=10_000.0)


def test_atomic_ops():
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        tr.atomic_op(MutationType.ADD_VALUE, b"n", (5).to_bytes(8, "little"))
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(MutationType.ADD_VALUE, b"n", (7).to_bytes(8, "little"))
        # RYW of an unresolved atomic op fetches the base and applies
        assert int.from_bytes((await tr.get(b"n")), "little") == 12
        await tr.commit()
        tr = db.create_transaction()
        assert int.from_bytes((await tr.get(b"n")), "little") == 12
        tr.atomic_op(MutationType.BYTE_MAX, b"s", b"mmm")
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(MutationType.BYTE_MAX, b"s", b"zzz")
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get(b"s") == b"zzz"

    c.run(c.loop.spawn(t()))


def test_range_reads_with_selectors_and_limits():
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        for i in range(20):
            tr.set(b"k%02d" % i, b"v%d" % i)
        await tr.commit()

        tr = db.create_transaction()
        rows = await tr.get_range(b"k05", b"k10")
        assert [k for k, _ in rows] == [b"k05", b"k06", b"k07", b"k08", b"k09"]
        rows = await tr.get_range(b"k05", b"k10", limit=2)
        assert [k for k, _ in rows] == [b"k05", b"k06"]
        rows = await tr.get_range(b"k05", b"k10", reverse=True, limit=2)
        assert [k for k, _ in rows] == [b"k09", b"k08"]
        # RYW merge inside a range
        tr.set(b"k07x", b"new")
        tr.clear(b"k06")
        rows = await tr.get_range(b"k05", b"k09")
        assert [k for k, _ in rows] == [b"k05", b"k07", b"k07x", b"k08"]
        # selectors (resolved against the RYW view: k06 is cleared above)
        k = await tr.get_key(KeySelector.first_greater_than(b"k05"))
        assert k == b"k07"
        k = await tr.get_key(KeySelector.last_less_than(b"k05"))
        assert k == b"k04"
        k = await tr.get_key(KeySelector.first_greater_or_equal(b"k06"))
        assert k == b"k07"

    c.run(c.loop.spawn(t()))


def test_versionstamped_value():
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        # value = 10 placeholder bytes + 4-byte LE offset 0
        tr.atomic_op(MutationType.SET_VERSIONSTAMPED_VALUE, b"vs",
                     b"\x00" * 10 + (0).to_bytes(4, "little"))
        await tr.commit()
        cv = tr.committed_version
        tr = db.create_transaction()
        v = await tr.get(b"vs")
        assert len(v) == 10
        assert int.from_bytes(v[:8], "big") == cv

    c.run(c.loop.spawn(t()))


def test_watch_fires_on_change():
    c = make_cluster()
    db = c.database()
    fired = {}

    async def t():
        tr = db.create_transaction()
        tr.set(b"w", b"0")
        await tr.commit()

        tr = db.create_transaction()
        w = await tr.watch(b"w")
        assert not w.is_ready()

        tr2 = db.create_transaction()
        tr2.set(b"w", b"1")
        await tr2.commit()
        await w
        fired["ok"] = True

    c.run(c.loop.spawn(t()))
    assert fired.get("ok")


@BACKENDS
def test_cycle_workload_serializability(backend):
    """Cycle workload (Cycle.actor.cpp:27-80): N keys form a ring by value;
    transactional 3-key rotations must preserve the ring invariant."""
    c = make_cluster()
    db = c.database()
    N = 6

    def key(i):
        return b"cycle/%02d" % i

    async def setup(tr):
        for i in range(N):
            tr.set(key(i), b"%02d" % ((i + 1) % N))

    async def rotate(tr):
        # pick a random start, rotate the chain a->b->c to a->c->b's target
        r = c.rng.randint(0, N - 1)
        a = key(r)
        b_idx = int(await tr.get(a))
        b = key(b_idx)
        c_idx = int(await tr.get(b))
        cc = key(c_idx)
        d_idx = int(await tr.get(cc))
        tr.set(a, b"%02d" % c_idx)
        tr.set(b, b"%02d" % d_idx)
        tr.set(cc, b"%02d" % b_idx)

    async def check():
        tr = db.create_transaction()
        seen = set()
        i = 0
        for _ in range(N):
            seen.add(i)
            i = int(await tr.get(key(i)))
        assert i == 0 and len(seen) == N, f"ring broken: {seen}"

    async def t():
        await db.transact(setup)
        from foundationdb_tpu_torch.core.future import all_of
        tasks = [c.loop.spawn(db.transact(rotate), name=f"rot{i}")
                 for i in range(20)]
        await all_of(tasks)
        await check()

    c.run(c.loop.spawn(t()), max_time=10_000.0)


@BACKENDS
def test_too_old_transaction(backend):
    c = make_cluster()
    db = c.database()

    async def t():
        tr_old = db.create_transaction()
        await tr_old.get(b"x")  # pins an early read version

        # push many committed versions past the MVCC window
        KNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 1000)
        tr = db.create_transaction()
        tr.set(b"x", b"1")
        await tr.commit()
        # advance virtual time so the next commit version jumps the window
        await c.loop.delay(1.0)  # 1s = 1e6 versions >> 1000
        tr = db.create_transaction()
        tr.set(b"x", b"2")
        await tr.commit()

        tr_old.set(b"x", b"old")
        try:
            await tr_old.commit()
            raise AssertionError("expected transaction_too_old")
        except FDBError as e:
            assert e.name == "transaction_too_old"

    c.run(c.loop.spawn(t()))


@BACKENDS
def test_multi_resolver_commit(backend):
    """Conflict ranges split across resolvers; commit iff all agree."""
    c = make_cluster(n_resolvers=4)
    db = c.database()

    async def t():
        tr = db.create_transaction()
        # writes spanning all resolver partitions
        for prefix in (b"\x01", b"\x41", b"\x81", b"\xc1"):
            tr.set(prefix + b"key", b"v")
        await tr.commit()

        t1 = db.create_transaction()
        t2 = db.create_transaction()
        await t1.get(b"\x01key")
        await t2.get(b"\xc1key")
        t1.set(b"\xc1key", b"t1")  # t1 writes what t2 read
        t2.set(b"\x01key", b"t2")  # t2 writes what t1 read
        await t1.commit()
        try:
            await t2.commit()
            raise AssertionError("expected not_committed")
        except FDBError as e:
            assert e.name == "not_committed"

    c.run(c.loop.spawn(t()))


@BACKENDS
def test_multi_tlog_quorum_and_multi_storage(backend):
    c = make_cluster(n_tlogs=2, n_storage=2)
    db = c.database()

    async def t():
        tr = db.create_transaction()
        tr.set(b"\x01a", b"shard0")
        tr.set(b"\x90z", b"shard1")
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get(b"\x01a") == b"shard0"
        assert await tr.get(b"\x90z") == b"shard1"

    c.run(c.loop.spawn(t()))


def test_determinism_same_seed_same_trace():
    def run_once(seed):
        c = make_cluster(seed=seed)
        db = c.database()
        log = []

        async def t():
            for i in range(5):
                tr = db.create_transaction()
                tr.set(b"k%d" % i, b"v")
                await tr.commit()
                log.append((i, tr.committed_version, c.loop.now()))

        c.run(c.loop.spawn(t()))
        return log

    assert run_once(7) == run_once(7)
    assert run_once(7) != run_once(8)  # different seed -> different timings


def test_limited_range_read_survives_overlay_clears():
    """Regression: overlay clears must not starve a limited range read —
    the client continues fetching past limit-cut storage replies."""
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        for i in range(20):
            tr.set(b"k%02d" % i, b"v")
        await tr.commit()

        tr = db.create_transaction()
        tr.clear_range(b"k00", b"k15")  # clears everything a small fetch sees
        rows = await tr.get_range(b"k00", b"k99", limit=3)
        assert [k for k, _ in rows] == [b"k15", b"k16", b"k17"]
        rows = await tr.get_range(b"k00", b"k99", limit=3, reverse=True)
        assert [k for k, _ in rows] == [b"k19", b"k18", b"k17"]

    c.run(c.loop.spawn(t()))


def test_multi_proxy_read_after_commit():
    """Regression: GRV must confirm committed versions across ALL proxies
    (getLiveCommittedVersion), or a read can miss the client's own commit."""
    c = make_cluster(n_proxies=3)
    db = c.database()

    async def t():
        for i in range(10):
            tr = db.create_transaction()
            tr.set(b"rac", b"%d" % i)
            await tr.commit()
            tr2 = db.create_transaction()  # may hit a different proxy
            assert await tr2.get(b"rac") == b"%d" % i

    c.run(c.loop.spawn(t()))


def test_backward_end_selector_with_overlay():
    """Regression: backward/non-canonical end selectors resolve against the
    merged RYW view, not a conservative byte ceiling."""
    c = make_cluster()
    db = c.database()

    async def t():
        tr = db.create_transaction()
        tr.set(b"a", b"1")
        tr.set(b"b", b"2")
        await tr.commit()
        tr = db.create_transaction()
        tr.set(b"y", b"3")  # overlay key beyond the resolved end
        rows = await tr.get_range(b"a", KeySelector.last_less_than(b"z"))
        # end resolves to y (merged view); range [a, y) -> a, b
        assert [k for k, _ in rows] == [b"a", b"b"]

    c.run(c.loop.spawn(t()))


def test_cross_shard_range_reads():
    """Range reads spanning 4 storage shards return exactly the right rows
    in both directions, with and without limits (NativeAPI
    getKeyRangeLocations :1083 + wrong_shard_server contract): routing a
    range to its begin-key owner only would silently truncate the result."""
    c = make_cluster(n_storage=4, n_tlogs=2)
    db = c.database()
    # keys spread across all 4 shards (boundaries at 0x40, 0x80, 0xc0)
    keys = [bytes([16 * i]) + b"/k%02d" % i for i in range(16)]

    async def t():
        async def setup(tr):
            for i, k in enumerate(keys):
                tr.set(k, b"v%02d" % i)
        await db.transact(setup)

        tr = db.create_transaction()
        rows = await tr.get_range(b"", b"\xff")
        assert [k for k, _v in rows] == keys
        assert [v for _k, v in rows] == [b"v%02d" % i for i in range(16)]

        rows = await tr.get_range(b"", b"\xff", reverse=True)
        assert [k for k, _v in rows] == keys[::-1]

        # limited reads stopping mid-shard and mid-keyspace
        rows = await tr.get_range(b"", b"\xff", limit=5)
        assert [k for k, _v in rows] == keys[:5]
        rows = await tr.get_range(b"", b"\xff", limit=11, reverse=True)
        assert [k for k, _v in rows] == keys[::-1][:11]

        # window straddling two shard boundaries
        rows = await tr.get_range(keys[2], keys[13])
        assert [k for k, _v in rows] == keys[2:13]

        # selector resolution across shards
        from foundationdb_tpu_torch.server.interfaces import KeySelector
        k = await tr.get_key(KeySelector.first_greater_than(keys[6]))
        assert k == keys[7]

    c.run(c.loop.spawn(t()), max_time=5_000.0)


def test_wrong_shard_server_rejected():
    """A read routed to the wrong storage server must error, not silently
    return rows from the wrong shard (the server-side half of the
    location-cache contract)."""
    c = make_cluster(n_storage=2)
    db = c.database()

    async def t():
        async def setup(tr):
            tr.set(b"\x10a", b"1")
            tr.set(b"\xf0b", b"2")
        await db.transact(setup)
        # corrupt the location cache: swap the two shard teams
        db.locations.teams = db.locations.teams[::-1]
        tr = db.create_transaction()
        try:
            await tr.get(b"\x10a")
            raise AssertionError("stale-cache read did not error")
        except FDBError as e:
            assert e.name == "wrong_shard_server"

    c.run(c.loop.spawn(t()), max_time=5_000.0)


def test_get_many_matches_individual_gets():
    """tr.get_many returns the same values, in order, as per-key gets —
    on both its paths: the batched fast path (read version known, no
    overlay) and the composed get_future path (no read version yet)."""
    c = make_cluster()
    db = c.database()
    keys = [b"gm%02d" % i for i in range(8)]

    async def t():
        async def setup(tr):
            for i, k in enumerate(keys):
                tr.set(k, b"v%02d" % i)
        await db.transact(setup)

        probe = keys + [b"gm-missing"]
        expect = [b"v%02d" % i for i in range(8)] + [None]

        tr = db.create_transaction()
        assert await tr.get_many(probe) == expect  # no GRV yet: composed

        tr2 = db.create_transaction()
        await tr2.get_read_version()
        assert await tr2.get_many(probe) == expect  # batched fast path
        assert await tr2.get_many([]) == []

    c.run(c.loop.spawn(t()), max_time=5_000.0)


def test_get_many_sees_uncommitted_writes():
    c = make_cluster()
    db = c.database()

    async def t():
        async def setup(tr):
            tr.set(b"a", b"old")
            tr.set(b"b", b"keep")
        await db.transact(setup)

        tr = db.create_transaction()
        await tr.get_read_version()
        tr.set(b"a", b"new")
        tr.clear(b"b")
        assert await tr.get_many([b"a", b"b", b"c"]) == [b"new", None, None]

    c.run(c.loop.spawn(t()), max_time=5_000.0)


def test_get_many_adds_read_conflicts():
    """A non-snapshot multiget must conflict with a concurrent write to any
    of its keys; a snapshot multiget must not."""
    c = make_cluster()
    db = c.database()
    outcome = {}

    async def t():
        t1 = db.create_transaction()
        await t1.get_read_version()
        await t1.get_many([b"k1", b"k2"])
        t2 = db.create_transaction()
        t2.set(b"k2", b"other")
        await t2.commit()
        t1.set(b"unrelated", b"x")
        try:
            await t1.commit()
            outcome["t1"] = "committed"
        except FDBError as e:
            outcome["t1"] = e.name

        t3 = db.create_transaction()
        await t3.get_read_version()
        await t3.get_many([b"k1", b"k2"], snapshot=True)
        t4 = db.create_transaction()
        t4.set(b"k1", b"again")
        await t4.commit()
        t3.set(b"unrelated2", b"y")
        await t3.commit()  # would abort if snapshot reads conflicted

    c.run(c.loop.spawn(t()), max_time=5_000.0)
    assert outcome["t1"] == "not_committed"


def test_get_many_across_shards():
    """A multiget whose keys live on different storage teams decomposes into
    per-team reads and reassembles in order (the _send_read_batches split)."""
    c = make_cluster(n_storage=4, n_tlogs=2)
    db = c.database()
    keys = [bytes([16 * i]) + b"/gm%02d" % i for i in range(16)]

    async def t():
        async def setup(tr):
            for i, k in enumerate(keys):
                tr.set(k, b"v%02d" % i)
        await db.transact(setup)

        tr = db.create_transaction()
        await tr.get_read_version()
        got = await tr.get_many(keys + [b"\x55missing"])
        assert got == [b"v%02d" % i for i in range(16)] + [None]

    c.run(c.loop.spawn(t()), max_time=5_000.0)


# ---------------------------------------------------------------------------
# Durability: the cases of tests/test_durability.py on the port's DiskQueue,
# KV engines (redwood is not ported) and SimCluster reboots
# ---------------------------------------------------------------------------

def _files(n=2, seed=0):
    rng = DeterministicRandom(seed)
    return [SimFile(f"f{i}", rng.fork()) for i in range(n)]


# ---------------------------------------------------------------------------
# DiskQueue
# ---------------------------------------------------------------------------

def test_diskqueue_push_commit_recover():
    f0, f1 = _files()
    q = DiskQueue(f0, f1)
    for i in range(10):
        q.push(f"entry{i}".encode())
    q.commit()
    q2 = DiskQueue(f0, f1)
    entries = q2.recover()
    assert [p for _s, p in entries] == [f"entry{i}".encode() for i in range(10)]
    assert q2.next_seq == 10


def test_diskqueue_uncommitted_lost_on_kill():
    f0, f1 = _files(seed=3)
    q = DiskQueue(f0, f1)
    q.push(b"durable")
    q.commit()
    q.push(b"lost1")
    q.push(b"lost2")
    f0.on_kill()  # unsynced appends dropped (possibly a prefix survives)
    f1.on_kill()
    entries = DiskQueue(f0, f1).recover()
    payloads = [p for _s, p in entries]
    assert payloads[0] == b"durable"
    # suffix-only loss: if lost2 survived, lost1 must have too
    if b"lost2" in payloads:
        assert b"lost1" in payloads


def test_diskqueue_pop_truncates_and_alternates():
    f0, f1 = _files()
    q = DiskQueue(f0, f1)
    for i in range(100):
        q.push(bytes([i]))
    q.commit()
    q.pop(90)  # front file fully popped -> truncate + swap
    assert q.active == 1  # writes now land in the emptied file
    for i in range(100, 110):
        q.push(bytes([i % 256]))
    q.commit()
    entries = DiskQueue(f0, f1).recover()
    seqs = [s for s, _p in entries]
    assert seqs[0] >= 90 or len(seqs) == 20  # popped prefix gone from disk
    payloads = [p for _s, p in entries]
    assert bytes([109]) in payloads


def test_diskqueue_torn_page_truncates_suffix():
    f0, f1 = _files()
    q = DiskQueue(f0, f1)
    for i in range(5):
        q.push(bytes([i]) * 10)
    q.commit()
    # corrupt the middle of the raw file: recovery must stop there
    raw = f0.durable
    f0.durable = raw[: len(raw) // 2] + b"\xde\xad" + raw[len(raw) // 2 + 2:]
    entries = DiskQueue(f0, f1).recover()
    assert len(entries) < 5


# ---------------------------------------------------------------------------
# Memory KV engine
# ---------------------------------------------------------------------------

def test_memory_kvstore_recover():
    f0, f1 = _files()
    s = MemoryKeyValueStore(f0, f1)
    s.set(b"a", b"1")
    s.set(b"b", b"2")
    s.set(b"c", b"3")
    s.clear_range(b"b", b"c")
    s.set_metadata("durableVersion", b"42")
    s.commit()
    s2 = MemoryKeyValueStore(f0, f1)
    s2.recover()
    assert s2.get(b"a") == b"1"
    assert s2.get(b"b") is None
    assert s2.get(b"c") == b"3"
    assert s2.get_range(b"", b"\xff") == [(b"a", b"1"), (b"c", b"3")]
    assert s2.get_metadata("durableVersion") == b"42"


def test_memory_kvstore_snapshot_compaction():
    f0, f1 = _files()
    s = MemoryKeyValueStore(f0, f1)
    s.SNAPSHOT_OPS = 10
    for i in range(25):
        s.set(f"k{i}".encode(), f"v{i}".encode())
        s.commit()
    # snapshots happened; a fresh recover still sees everything
    s2 = MemoryKeyValueStore(f0, f1)
    s2.recover()
    for i in range(25):
        assert s2.get(f"k{i}".encode()) == f"v{i}".encode()
    # and the disk footprint was compacted (all entries fit post-snapshot)
    assert len(s.queue.live_entries) < 25


def test_ssd_kvstore(tmp_path):
    from foundationdb_tpu_torch.storage.kvstore import SSDKeyValueStore
    s = SSDKeyValueStore(str(tmp_path / "kv.sqlite"))
    s.set(b"x", b"1")
    s.set(b"y", b"2")
    s.commit()
    s2 = SSDKeyValueStore(str(tmp_path / "kv.sqlite"))
    assert s2.get(b"x") == b"1"
    assert s2.get_range(b"", b"\xff") == [(b"x", b"1"), (b"y", b"2")]
    s2.clear_range(b"x", b"y")
    s2.commit()
    assert s2.get(b"x") is None


# ---------------------------------------------------------------------------
# Storage server restart recovery (whole-cluster, through the client API)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["memory", "ssd"])
def test_storage_server_reboot_preserves_durable_data(engine, tmp_path):
    # small MVCC window so durability advances quickly; the storage role
    # opens the configured engine via open_kv_store (IKeyValueStore.h:66)
    KNOBS.set("MAX_READ_TRANSACTION_LIFE_VERSIONS", 50)
    KNOBS.set("MAX_VERSIONS_IN_FLIGHT", 1_000_000_000)
    KNOBS.set("STORAGE_ENGINE", engine)
    KNOBS.set("SSD_DATA_DIR", str(tmp_path))
    c = SimCluster(seed=5)
    db = c.database()
    ss_addr = c.storage_procs[0].address

    async def scenario():
        # phase 1: write data, push versions forward so it becomes durable
        for i in range(30):
            tr = db.create_transaction()
            tr.set(f"key{i:03d}".encode(), f"val{i}".encode())
            await tr.commit()
        await c.loop.delay(1.0)

        # phase 2: reboot the storage server (durable files survive,
        # unsynced tails may be lost)
        c.net.kill(ss_addr, KillType.RebootProcess)
        await c.loop.delay(5.0)

        # phase 3: all committed data must still be readable
        tr = db.create_transaction()
        for i in range(30):
            v = await tr.get(f"key{i:03d}".encode())
            assert v == f"val{i}".encode(), (i, v)

    c.run(c.loop.spawn(scenario()), max_time=300.0)


def test_tlog_reboot_preserves_unpopped_mutations():
    KNOBS.set("MAX_READ_TRANSACTION_LIFE_VERSIONS", 50)
    KNOBS.set("MAX_VERSIONS_IN_FLIGHT", 1_000_000_000)
    c = SimCluster(seed=6)
    db = c.database()
    tlog_addr = c.tlog_procs[0].address

    async def scenario():
        tr = db.create_transaction()
        tr.set(b"before", b"1")
        await tr.commit()
        await c.loop.delay(0.5)

        c.net.kill(tlog_addr, KillType.RebootProcess)
        await c.loop.delay(5.0)

        # data committed before the crash still readable (either already
        # durable at the SS, or re-peeked from the recovered TLog)
        tr = db.create_transaction()
        assert await tr.get(b"before") == b"1"

        # and the pipeline still works end-to-end after recovery
        tr2 = db.create_transaction()
        tr2.set(b"after", b"2")
        await tr2.commit()
        tr3 = db.create_transaction()
        assert await tr3.get(b"after") == b"2"

    c.run(c.loop.spawn(scenario()), max_time=300.0)
