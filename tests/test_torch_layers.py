"""The port's client layers and fdbcli against the JAX package's.

tests/test_layers.py's tests run on both packages: the tuple layer's
round trip, order and ranges, the subspace, the directory layer, the
counters, the status document with fdbcli, and the three recipes. Each
run records what the layer returned (packed bytes, prefixes, listings,
fdbcli's output lines, the status document) and every attempt's outcome
with its virtual time (test_torch_recovery.py's Recorder). The records
must be equal, exactly, and the reference test's own checks then hold on
the port's run. Tuple packing is also held byte for byte across the
packages on a seeded corpus of ints (big ones too), floats, bytes,
strings, nested tuples, booleans and None.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_recovery as rec
from foundationdb_tpu.core import future as j_future
from foundationdb_tpu.layers import directory as j_directory
from foundationdb_tpu.layers import recipes as j_recipes
from foundationdb_tpu.layers import subspace as j_subspace
from foundationdb_tpu.layers import tuple as j_tuple
from foundationdb_tpu.tools import fdbcli as j_fdbcli
from foundationdb_tpu.utils import rng as j_rng
from foundationdb_tpu.utils import stats as j_stats
from foundationdb_tpu_torch.core import future as t_future
from foundationdb_tpu_torch.layers import directory as t_directory
from foundationdb_tpu_torch.layers import recipes as t_recipes
from foundationdb_tpu_torch.layers import subspace as t_subspace
from foundationdb_tpu_torch.layers import tuple as t_tuple
from foundationdb_tpu_torch.testing import simulated_cluster as t_sim
from foundationdb_tpu_torch.tools import fdbcli as t_fdbcli
from foundationdb_tpu_torch.utils import errors as t_errors
from foundationdb_tpu_torch.utils import rng as t_rng
from foundationdb_tpu_torch.utils import stats as t_stats

# test_torch_coordination.py adds names to rec.PORT and rec.JAX when it
# is imported: extend copies of whatever they hold
PORT = SimpleNamespace(**{**vars(rec.PORT), **dict(
    T=t_tuple, subspace=t_subspace, directory=t_directory,
    recipes=t_recipes, fdbcli=t_fdbcli, rng=t_rng, stats=t_stats,
    all_of=t_future.all_of)})
JAX = SimpleNamespace(**{**vars(rec.JAX), **dict(
    T=j_tuple, subspace=j_subspace, directory=j_directory,
    recipes=j_recipes, fdbcli=j_fdbcli, rng=j_rng, stats=j_stats,
    all_of=j_future.all_of)})

_knobs = rec._knobs  # the autouse fixture: both banks on the oracle


def record(S, go):
    with pytest.MonkeyPatch.context() as mp:
        r = rec.Recorder(S, mp)
        for cls in (S.cluster.SimCluster, S.cluster.RecoverableCluster):
            def run(c, future, max_time=1000.0, fn=cls.run):
                r.loop = c.loop
                return fn(c, future, max_time)
            mp.setattr(cls, "run", run)
        result = go(S)
    return SimpleNamespace(attempts=r.attempts, dbinfos=r.dbinfos,
                           result=result)


def both(go, cluster=True):
    """`go` on the port, then on the JAX package, held equal; the port's
    result."""
    port = record(PORT, go)
    jax = record(JAX, go)
    assert port.result == jax.result
    assert port.attempts == jax.attempts
    assert port.dbinfos == jax.dbinfos
    if cluster:
        assert port.attempts  # something went through a cluster
    return port.result


# -- tuple layer --

TUPLE_CASES = [
    (),
    (None,),
    (b"bytes", "string", 0, 1, -1, 255, -255, 65536, -65536,
     (1 << 60), -(1 << 60)),
    (3.14, -3.14, 0.0, float("inf"), float("-inf")),
    (True, False),
    (("nested", (None, b"\x00deep\x00")), "after"),
    (b"\x00\x01\xff", "uniécode"),
]


def test_tuple_roundtrip():
    def go(S):
        out = []
        for t in TUPLE_CASES:
            packed = S.T.pack(t)
            assert S.T.unpack(packed) == t, t
            out.append(packed)
        return out
    assert both(go, cluster=False)


def rand_elem(rng, depth=0):
    k = rng.randint(0, 5 if depth else 6)
    if k == 0:
        return None
    if k == 1:
        return rng.random_bytes(rng.randint(0, 6))
    if k == 2:
        return "".join(chr(97 + rng.randint(0, 25))
                       for _ in range(rng.randint(0, 5)))
    if k == 3:
        return rng.randint(-(1 << 40), 1 << 40)
    if k == 4:
        return rng.random() * 2000 - 1000
    if k == 5:
        return bool(rng.coinflip())
    return tuple(rand_elem(rng, depth + 1) for _ in range(rng.randint(0, 3)))


def type_rank(e):
    if e is None:
        return 0
    if isinstance(e, bytes):
        return 1
    if isinstance(e, str):
        return 2
    if isinstance(e, tuple):
        return 3
    if isinstance(e, bool):
        return 6
    if isinstance(e, int):
        return 4
    return 5


def logical_key(t):
    return tuple((type_rank(e),
                  logical_key(e) if isinstance(e, tuple)
                  else (e if not isinstance(e, bool) else int(e)))
                 for e in t)


def test_tuple_order_preserving():
    """Packed byte order equals logical element order, on each package's
    own seeded draw of 300 tuples (test_layers.py's)."""
    def go(S):
        rng = S.rng.DeterministicRandom(5)
        tuples = [tuple(rand_elem(rng) for _ in range(rng.randint(0, 3)))
                  for _ in range(300)]
        by_packed = sorted(tuples, key=lambda t: S.T.pack(t))
        by_logic = sorted(tuples, key=logical_key)
        assert [S.T.pack(t) for t in by_packed] == \
            [S.T.pack(t) for t in by_logic]
        return [S.T.pack(t) for t in by_packed]
    assert len(both(go, cluster=False)) == 300


def test_tuple_range():
    def go(S):
        lo, hi = S.T.range_of(("users",))
        assert lo < S.T.pack(("users", 1)) < hi
        assert lo < S.T.pack(("users", "zz", "deep")) < hi
        assert not (lo < S.T.pack(("userz",)) < hi)
        return lo, hi
    both(go, cluster=False)


def corpus(seed, n=400):
    """Seeded tuples of every kind the layer packs: small and big ints
    (to 64 bits), floats (signed zeros and infinities too), bytes with
    NULs, strings beyond ASCII, booleans, None and nested tuples."""
    rng = np.random.default_rng(seed)
    specials = [0.0, -0.0, float("inf"), float("-inf"), 1e-300, -1e300]

    def elem(depth):
        k = int(rng.integers(0, 9 if depth < 2 else 8))
        if k == 0:
            return None
        if k == 1:
            return int(rng.integers(-(1 << 62), 1 << 62)) >> int(
                rng.integers(0, 62))
        if k == 2:  # up to the 8 bytes the layer encodes
            sign = -1 if rng.random() < 0.5 else 1
            return sign * ((1 << int(rng.integers(56, 64)))
                           + int(rng.integers(0, 1 << 55)))
        if k == 3:
            return specials[int(rng.integers(0, len(specials)))] \
                if rng.random() < 0.2 else float(rng.normal() * 1e6)
        if k == 4:
            return rng.integers(0, 256, int(rng.integers(0, 12)),
                                dtype=np.uint8).tobytes()
        if k == 5:
            return "".join(chr(int(c)) for c in rng.integers(
                1, 0x3000, int(rng.integers(0, 8))))
        if k == 6:
            return bool(rng.random() < 0.5)
        if k == 7:
            return b"\x00" * int(rng.integers(1, 4))
        return tuple(elem(depth + 1) for _ in range(int(rng.integers(0, 4))))
    return [tuple(elem(0) for _ in range(int(rng.integers(0, 5))))
            for _ in range(n)]


def same_value(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(map(same_value, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tuple_packing_is_byte_equal_across_packages(seed):
    """Every tuple of a seeded corpus packs to the same bytes in both
    packages, with and without a prefix, and each package unpacks the
    other's bytes to the tuple."""
    for t in corpus(seed):
        packed = t_tuple.pack(t)
        assert packed == j_tuple.pack(t), t
        assert t_tuple.pack(t, b"pre") == j_tuple.pack(t, b"pre")
        assert same_value(t_tuple.unpack(packed), t), t
        assert same_value(j_tuple.unpack(packed), t), t
        assert t_tuple.range_of(t) == j_tuple.range_of(t)
    # past 8 bytes both refuse an int alike
    for v in (1 << 64, -(1 << 64)):
        for T in (t_tuple, j_tuple):
            with pytest.raises(ValueError, match="int too large"):
                T.pack((v,))


# -- subspace --

def test_subspace():
    def go(S):
        users = S.subspace.Subspace(("app", "users"))
        k = users.pack((42, "bob"))
        assert users.contains(k)
        assert users.unpack(k) == (42, "bob")
        sub = users[42]
        assert sub.contains(users.pack((42, "x")))
        lo, hi = users.range()
        assert lo < k < hi
        with pytest.raises(ValueError):
            users.unpack(b"not-in-subspace")
        return users.key, k, sub.key, lo, hi, repr(users)
    both(go, cluster=False)


# -- directory --

def test_directory_layer():
    def go(S):
        c = S.cluster.SimCluster(seed=9)
        db = c.database()
        dl = S.directory.DirectoryLayer()
        seen = []

        async def t():
            async def mk(tr):
                d = await dl.create_or_open(tr, ("app", "events"))
                tr.set(d.pack((1,)), b"first")
                return d
            d = await db.transact(mk)

            async def reopen(tr):
                return await dl.create_or_open(tr, ("app", "events"))
            d2 = await db.transact(reopen)
            assert d2.key == d.key, "reopen must return the same prefix"

            async def read(tr):
                return await tr.get(d.pack((1,)))
            assert await db.transact(read) == b"first"

            async def other(tr):
                return await dl.create_or_open(tr, ("app", "users"))
            d3 = await db.transact(other)
            assert d3.key != d.key

            async def ls(tr):
                return await dl.list(tr, ("app",))
            listed = sorted(await db.transact(ls))
            assert listed == ["events", "users"]

            async def rm(tr):
                return await dl.remove(tr, ("app", "events"))
            assert await db.transact(rm)

            async def gone(tr):
                return (await dl.open(tr, ("app", "events")),
                        await tr.get(d.pack((1,))))
            node, val = await db.transact(gone)
            assert node is None and val is None
            seen.extend([d.key, d3.key, d.path, listed])

        c.run(c.loop.spawn(t()), max_time=10_000.0)
        return seen, c.loop.now()
    both(go)


# -- counters --

def test_counters():
    def go(S):
        cc = S.stats.CounterCollection("ProxyStats", "proxy:0")
        commits = cc.counter("Commits")
        commits += 5
        conflicts = S.stats.Counter("Conflicts", cc)
        conflicts.increment(2)
        assert cc.as_dict() == {"Commits": 5, "Conflicts": 2}
        cc.trace(now=10.0)
        commits += 5
        cc.trace(now=12.0)  # rate = 5/2
        assert commits.rate_since_dump(2.0) == 0.0  # just dumped
        return cc.as_dict()
    both(go, cluster=False)


# -- status + fdbcli --

def test_status_and_fdbcli():
    def go(S):
        c = S.cluster.RecoverableCluster(seed=77, n_workers=4, n_proxies=2,
                                         n_tlogs=2, n_storage=2)
        db = c.database()

        async def boot():
            await db.refresh()
        c.run(c.loop.spawn(boot()), max_time=60_000.0)

        cli = S.fdbcli.FdbCli(c, db)
        said = [cli.execute(line) for line in (
            "set a 1", "writemode on", "set hello world", "get hello",
            "set hellp x", "getrange hell hellz 10", "clear hellp",
            "get hellp", "status", "help", "nosuchcommand", "get",
            "coordinators", "exclude", "configure")]

        async def status_json():
            return await db.get_status()
        status = c.run(c.loop.spawn(status_json()), max_time=60_000.0)
        # a resolver reports its engine's counters, which differ by
        # design: the port's count its kernels' launches
        engine = [role.pop("counters") for role in status["cluster"]["roles"]
                  if role["role"] == "resolver"]
        assert engine
        return said, json.dumps(status, sort_keys=True, default=str)

    said, status = both(go)
    assert any("ERROR: writemode" in line for line in said[0])
    assert said[2] == ["Committed"]
    assert said[3] == ["`hello' is `world'"]
    assert "`hello' is `world'" in said[5][1]
    assert any("hellp" in line for line in said[5])
    assert said[7] == ["`hellp': not found"]
    assert any("accepting_commits" in line for line in said[8])
    assert any("Storage servers - 2" in line for line in said[8])
    assert said[10][0].startswith("ERROR: unknown command")
    assert said[11][0].startswith("ERROR: `get' is missing arguments")
    cl = json.loads(status)["cluster"]
    assert cl["recovery_state"]["name"] == "accepting_commits"
    assert len(cl["layers"]["proxies"]) == 2
    assert len(cl["layers"]["storages"]) == 2
    assert "transactions_per_second_limit" in cl["qos"]


def test_fdbcli_main_boots_a_simulated_cluster(monkeypatch, capsys):
    """fdbcli's main boots the port's RecoverableCluster at the caller's
    knobs (the device backend, here on the CPU's plain versions at the
    harness's small engine shape) and runs the REPL over stdin until
    `exit`."""
    rec.TKNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE="cpu",
                         **t_sim._ACCEL_FAST_SHAPE)
    lines = iter(["writemode on", "set k v", "get k", "exit"])
    monkeypatch.setattr("builtins.input", lambda _prompt: next(lines))
    t_fdbcli.main()
    out = capsys.readouterr().out
    assert "`k' is `v'" in out and "Committed" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a box "
                    "without CUDA")
def test_fdbcli_main_refuses_the_card_without_one(monkeypatch):
    """At the port's defaults (the device backend on cuda) main refuses
    with platform_error where there is no card, before a cluster boots:
    it never falls back to the oracle."""
    rec.TKNOBS.reset()
    booted = []
    monkeypatch.setattr(
        "foundationdb_tpu_torch.server.cluster.RecoverableCluster",
        lambda *a, **kw: booted.append(1))
    with pytest.raises(t_errors.FDBError) as e:
        t_fdbcli.main()
    assert e.value.name == "platform_error" and not booted


class TestRecipes:
    """Layer recipes (design-recipes docs): counters, queues, secondary
    indexes as plain transactions over subspaces."""

    @staticmethod
    def _cluster(S):
        S.knobs.set("CONFLICT_BACKEND", "oracle")
        c = S.cluster.SimCluster(seed=33)
        return c, c.database()

    def test_counter_concurrent_adds_never_conflict(self):
        def go(S):
            c, db = self._cluster(S)
            ctr = S.recipes.Counter(S.subspace.Subspace(("ctr",)))

            async def one(delta):
                async def fn(tr):
                    ctr.add(tr, delta)
                await db.transact(fn)

            async def t():
                await S.all_of([c.loop.spawn(one(i + 1), name=f"a{i}")
                                for i in range(20)])

                async def rd(tr):
                    return await ctr.value(tr)
                return await db.transact(rd)
            return c.run(c.loop.spawn(t()), max_time=600.0), c.loop.now()
        value, _end = both(go)
        assert value == sum(range(1, 21))

    def test_queue_fifo_under_concurrent_pushers(self):
        def go(S):
            c, db = self._cluster(S)
            q = S.recipes.Queue(S.subspace.Subspace(("q",)))

            async def t():
                for i in range(6):
                    async def push(tr, i=i):
                        q.push(tr, b"item%d" % i)
                    await db.transact(push)
                got = []
                for _ in range(6):
                    async def pop(tr):
                        return await q.pop(tr)
                    got.append(await db.transact(pop))

                async def empty(tr):
                    return await q.pop(tr)
                return got, await db.transact(empty)
            return c.run(c.loop.spawn(t()), max_time=600.0)
        got, last = both(go)
        assert got == [b"item%d" % i for i in range(6)]
        assert last is None

    def test_index_stays_consistent_through_updates(self):
        def go(S):
            c, db = self._cluster(S)
            ix = S.recipes.Index(S.subspace.Subspace(("rows",)),
                                 S.subspace.Subspace(("by_city",)))

            async def t():
                async def w1(tr):
                    await ix.set(tr, "alice", b"a-data", "tokyo")
                    await ix.set(tr, "bob", b"b-data", "paris")
                    await ix.set(tr, "carol", b"c-data", "tokyo")
                await db.transact(w1)

                async def q1(tr):
                    return await ix.query(tr, "tokyo")
                first = sorted(await db.transact(q1))

                async def w2(tr):
                    await ix.set(tr, "alice", b"a2", "paris")
                await db.transact(w2)

                async def q2(tr):
                    return (await ix.query(tr, "tokyo"),
                            sorted(await ix.query(tr, "paris")),
                            await ix.get(tr, "alice"))
                return first, await db.transact(q2)
            return c.run(c.loop.spawn(t()), max_time=600.0)
        first, (tokyo, paris, alice) = both(go)
        assert first == ["alice", "carol"]
        assert tokyo == ["carol"]
        assert paris == ["alice", "bob"]
        assert alice == b"a2"
