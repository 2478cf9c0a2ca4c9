"""The port's redwood engine (storage/redwood.py) against the JAX one.

- tests/test_redwood.py's Python cases on the port's store: the block
  codec, flush and compaction against a dict model, recovery after a clean
  shutdown, a kill, a half-finished compaction and a torn run, WAL
  reclamation, range-tombstone shadowing, and the pinned struct layouts;
- tests/test_kvstore_parity.py over the port's three engines;
- a seeded fuzz: the port's CRC-32C, block codec and bloom filters give the
  JAX package's bytes (its Python codec, and its C codec where the JAX
  package's extension is built);
- the same mutation stream on both packages' stores leaves byte-identical
  files, and a store either package wrote recovers in the other.
"""

import pytest

from foundationdb_tpu.core.sim import SimFile as JSimFile
from foundationdb_tpu.storage import redwood as JR
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu.utils.rng import DeterministicRandom as JRandom
from foundationdb_tpu_torch.core.sim import SimFile
from foundationdb_tpu_torch.storage import kvstore
from foundationdb_tpu_torch.storage import redwood as R
from foundationdb_tpu_torch.storage.kvstore import (MemoryKeyValueStore,
                                                    SSDKeyValueStore)
from foundationdb_tpu_torch.storage.redwood import RedwoodKeyValueStore
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

TINY = dict(REDWOOD_MEMTABLE_BYTES=512, REDWOOD_BLOCK_BYTES=128,
            REDWOOD_COMPACTION_FAN_IN=2)


@pytest.fixture(autouse=True)
def _tiny_budgets():
    # small enough that a few hundred mutations exercise flush AND multiple
    # compaction levels (test_redwood.py's budgets), on both banks
    KNOBS.reset()
    KNOBS.overrides(**TINY)
    JKNOBS.overrides(**TINY)
    yield
    KNOBS.reset()


class _Files:
    """SimFile surface for the engine: WAL pair + named run files, of
    either package (`SimFile`, `Random`)."""

    def __init__(self, seed=0, sim_file=SimFile, random=DeterministicRandom):
        self.rng = random(seed)
        self.sim_file = sim_file
        self.files: dict = {}

    def open(self, name):
        if name not in self.files:
            self.files[name] = self.sim_file(name, self.rng.fork())
        return self.files[name]

    def existing(self):
        return [n for n in self.files if n.startswith("rw.")]

    def store(self, module=R):
        return module.RedwoodKeyValueStore(
            self.open("wal.0"), self.open("wal.1"), self.open, self.existing)

    def kill_all(self):
        for f in self.files.values():
            f.on_kill()

    def image(self):
        return {n: (f.durable, list(f.pending))
                for n, f in sorted(self.files.items())}

    def copy_into(self, other):
        """`other` (a _Files of either package) holds these files' bytes."""
        for n, f in self.files.items():
            g = other.open(n)
            g.durable, g.pending = f.durable, list(f.pending)


# ---------------------------------------------------------------------------
# block codec, CRC, bloom filters
# ---------------------------------------------------------------------------

def _random_items(rng, n):
    keys = sorted({bytes(rng.randint(97, 103) for _ in range(
        rng.randint(1, 12))) for _ in range(n)})
    return [(k, bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 20))))
            for k in keys]


def test_block_codec_roundtrip_python():
    rng = DeterministicRandom(1)
    for _ in range(50):
        items = _random_items(rng, rng.randint(0, 30))
        assert R.py_decode_block(R.py_encode_block(items)) == items
        assert R.decode_block(R.encode_block(items)) == items


def test_block_codec_rejects_corruption():
    img = bytearray(R.py_encode_block([(b"a", b"1"), (b"ab", b"2")]))
    img[-1] ^= 0xFF
    with pytest.raises(Exception, match="checksum|corrupt"):
        R.py_decode_block(bytes(img))


def _jax_native():
    from foundationdb_tpu import native
    return native.mod if native.available() else None


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_codec_crc_and_bloom_give_the_jax_bytes(seed):
    """Seeded fuzz: the port's block images, CRCs and bloom sections are
    byte for byte the JAX package's Python ones, and its C ones where the
    JAX extension is built (the binding authority is the Python side)."""
    rng = DeterministicRandom(seed)
    mod = _jax_native()
    for _ in range(60):
        items = _random_items(rng, rng.randint(0, 40))
        img = R.encode_block(items)
        assert img == JR.py_encode_block(items) == JR.encode_block(items)
        if mod is not None and hasattr(mod, "redwood_encode_block"):
            assert img == mod.redwood_encode_block(items)
        assert R.decode_block(JR.encode_block(items)) == items
        data = bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 300)))
        assert R.crc32c(data) == JR.crc32c(data)
        keys = [k for k, _v in items]
        bits, hashes = rng.randint(1, 16), rng.randint(1, 12)
        bloom = R.bloom_build(keys, bits, hashes)
        assert bloom == JR.py_bloom_build(keys, bits, hashes)
        assert bloom == JR.bloom_build(keys, bits, hashes)
        probe = keys + [bytes(rng.randint(97, 103) for _ in range(5))
                        for _ in range(10)]
        for k in probe:
            assert R.bloom_query(bloom, k) == JR.py_bloom_query(bloom, k)
            if k in keys:
                assert R.bloom_query(bloom, k)
    assert R.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_struct_layouts_are_the_jax_ones():
    """Byte sizes and field lists are the on-disk format: pinned as
    test_redwood.py pins them, and equal to the JAX module's."""
    assert R._BLOCK_HEADER.size == 16
    assert R._BLOCK_ENTRY.size == 8
    assert R._RUN_HEADER.size == 52
    assert R._RUN_INDEX.size == 10
    assert R._BLOOM_HEADER.size == 24
    for name in ("BLOCK_HEADER_FIELDS", "BLOCK_ENTRY_FIELDS",
                 "RUN_HEADER_FIELDS", "RUN_INDEX_FIELDS",
                 "BLOOM_HEADER_FIELDS", "BLOCK_MAGIC", "RUN_MAGIC",
                 "RUN_FORMAT_VERSION", "BLOOM_MAGIC"):
        assert getattr(R, name) == getattr(JR, name), name
    for name in ("_BLOCK_HEADER", "_BLOCK_ENTRY", "_RUN_HEADER",
                 "_RUN_INDEX", "_BLOOM_HEADER"):
        assert getattr(R, name).format == getattr(JR, name).format, name


# ---------------------------------------------------------------------------
# life-cycle: flush, compaction, model equality (test_redwood.py)
# ---------------------------------------------------------------------------

def _mutate(rng, store, model, n_ops):
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.70:
            k = f"k{rng.randint(0, 200):04d}".encode()
            v = bytes(rng.randint(0, 255) for _ in range(rng.randint(1, 15)))
            store.set(k, v)
            model[k] = v
        elif r < 0.85:
            a, b = sorted((rng.randint(0, 200), rng.randint(0, 200)))
            begin, end = f"k{a:04d}".encode(), f"k{b:04d}".encode()
            store.clear_range(begin, end)
            for k in [k for k in model if begin <= k < end]:
                del model[k]
        else:
            store.commit()
            store.maintain()


def _assert_equal(store, model):
    items = sorted(model.items())
    assert store.get_range(b"", b"\xff" * 8) == items
    assert store.get_range(b"", b"\xff" * 8, reverse=True) == \
        items[::-1]
    assert store.get_range(b"", b"\xff" * 8, limit=5) == items[:5]
    assert store.get_range(b"", b"\xff" * 8, limit=0) == []
    for k in list(model)[:50]:
        assert store.get(k) == model[k]
    assert store.get(b"nonexistent-key") is None
    keys = list(model)[:20] + [b"nonexistent-key"]
    assert store.get_batch(keys) == [store.get(k) for k in keys]


def test_flush_compaction_and_reads_match_model():
    files = _Files(seed=7)
    store = files.store()
    model: dict[bytes, bytes] = {}
    rng = DeterministicRandom(7)
    _mutate(rng, store, model, 600)
    store.commit()
    store.maintain()
    assert any(lv >= 1 for lv in store.level_shape()), store.level_shape()
    _assert_equal(store, model)
    stats = store.read_stats()
    assert stats["native_gets"] == 0 and stats["fallback_gets"] > 0


def test_recover_after_clean_shutdown():
    files = _Files(seed=8)
    store = files.store()
    model: dict[bytes, bytes] = {}
    rng = DeterministicRandom(8)
    _mutate(rng, store, model, 400)
    store.set_metadata("durableVersion", b"123")
    store.commit()
    store2 = files.store()
    store2.recover()
    _assert_equal(store2, model)
    assert store2.get_metadata("durableVersion") == b"123"


def test_recover_after_kill_preserves_committed_state():
    files = _Files(seed=9)
    store = files.store()
    model: dict[bytes, bytes] = {}
    rng = DeterministicRandom(9)
    _mutate(rng, store, model, 400)
    store.commit()
    store.set(b"uncommitted", b"x")
    files.kill_all()
    store2 = files.store()
    store2.recover()
    for k, v in model.items():
        assert store2.get(k) == v, k
    got = dict(store2.get_range(b"", b"\xff" * 8))
    for k in got:
        assert k in model or k == b"uncommitted"


def test_recovery_heals_half_finished_compaction():
    files = _Files(seed=10)
    store = files.store()
    model: dict[bytes, bytes] = {}
    for round_ in range(2):
        for i in range(40):
            k = f"h{round_}{i:03d}".encode()
            store.set(k, b"v" * 8)
            model[k] = b"v" * 8
        store.commit()
        plan = store.plan_maintenance()
        assert plan is not None and plan.kind == "flush"
        store.apply_maintenance(plan, plan.build())
    assert store.level_shape() == {0: 2}
    plan = store.plan_maintenance()
    assert plan is not None and plan.kind == "compact"
    image = plan.build()
    f = files.open(f"rw.{plan.run_id}")
    f.append(image)
    f.sync()
    store2 = files.store()
    store2.recover()
    assert store2.level_shape() == {1: 1}
    for src in plan.source_ids:
        assert files.files[f"rw.{src}"].read_all() == b""
    for k, v in model.items():
        assert store2.get(k) == v


def test_torn_run_file_is_ignored_and_truncated():
    files = _Files(seed=11)
    store = files.store()
    for i in range(60):
        store.set(f"t{i:03d}".encode(), b"v" * 8)
    store.commit()
    store.maintain()
    names = store.run_names()
    assert names
    torn = files.files[names[0]]
    torn.durable = torn.durable[: len(torn.durable) // 2]
    store2 = files.store()
    store2.recover()
    assert torn.read_all() == b""
    for i in range(60):
        assert store2.get(f"t{i:03d}".encode()) == b"v" * 8


def test_metadata_only_churn_flushes_and_reclaims_wal():
    files = _Files(seed=12)
    store = files.store()
    store.set(b"seed", b"1")
    store.commit()
    for v in range(400):
        store.set_metadata("durableVersion", str(v).encode())
        store.commit()
        store.maintain()
    assert len(store.queue.live_entries) < 400
    store2 = files.store()
    store2.recover()
    assert store2.get_metadata("durableVersion") == b"399"
    assert store2.get(b"seed") == b"1"


def test_clear_range_shadows_older_runs():
    files = _Files(seed=13)
    store = files.store()
    for i in range(40):
        store.set(f"s{i:03d}".encode(), b"old")
    store.commit()
    store.maintain()
    store.clear_range(b"s010", b"s020")
    store.set(b"s012", b"new")
    store.commit()
    assert store.get(b"s011") is None
    assert store.get(b"s012") == b"new"
    assert store.get(b"s009") == b"old"
    keys = [k for k, _ in store.get_range(b"s005", b"s025")]
    assert b"s011" not in keys and b"s012" in keys
    store.maintain()
    store2 = files.store()
    store2.recover()
    assert store2.get(b"s011") is None
    assert store2.get(b"s012") == b"new"


def test_open_kv_store_builds_redwood():
    files = _Files(seed=14)
    store = kvstore.open_kv_store(
        "redwood", file0=files.open("wal.0"), file1=files.open("wal.1"),
        open_file=files.open, existing_files=files.existing)
    assert isinstance(store, RedwoodKeyValueStore)
    with pytest.raises(FDBError) as ei:
        kvstore.validate_storage_engine("btree")
    assert ei.value.name == "invalid_option"


# ---------------------------------------------------------------------------
# both packages on one mutation stream; a store opens in the other package
# ---------------------------------------------------------------------------

PORT_FILES = dict(sim_file=SimFile, random=DeterministicRandom)
JAX_FILES = dict(sim_file=JSimFile, random=JRandom)


def _drive(files, module, seed, n_ops=500, kill=False):
    """One seeded mutation stream into a store of `module`; the model."""
    store = files.store(module)
    model: dict[bytes, bytes] = {}
    _mutate(DeterministicRandom(seed), store, model, n_ops)
    store.set_metadata("durableVersion", b"%d" % seed)
    store.commit()
    store.maintain()
    if kill:
        store.set(b"uncommitted", b"x")
        files.kill_all()
    return store, model


@pytest.mark.parametrize("seed", [31, 32])
def test_same_stream_leaves_the_jax_files(seed):
    """Flushes and compactions are decided by byte and run counts, so the
    same stream writes the same files, byte for byte, in both packages."""
    port_files = _Files(seed, **PORT_FILES)
    jax_files = _Files(seed, **JAX_FILES)
    port, model = _drive(port_files, R, seed)
    jax, jmodel = _drive(jax_files, JR, seed)
    assert model == jmodel
    assert port.level_shape() == jax.level_shape()
    assert port.run_names() == jax.run_names()
    assert port_files.image() == jax_files.image()
    assert port.get_range(b"", b"\xff" * 8) == jax.get_range(b"", b"\xff" * 8)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kill", [False, True], ids=["clean", "killed"])
def test_a_store_written_by_either_package_opens_in_the_other(writer, kill):
    seed = 41 + kill
    src = _Files(seed, **(JAX_FILES if writer == "jax" else PORT_FILES))
    dst = _Files(seed, **(PORT_FILES if writer == "jax" else JAX_FILES))
    _store, model = _drive(src, JR if writer == "jax" else R, seed,
                           kill=kill)
    assert any(n.startswith("rw.") for n in src.files)
    src.copy_into(dst)
    reader = dst.store(R if writer == "jax" else JR)
    reader.recover()
    again = src.store(JR if writer == "jax" else R)
    again.recover()
    rows = reader.get_range(b"", b"\xff" * 8)
    assert rows == again.get_range(b"", b"\xff" * 8)
    assert reader.get_metadata("durableVersion") == b"%d" % seed
    if kill:
        for k, v in model.items():
            assert reader.get(k) == v, k
    else:
        _assert_equal(reader, model)


# ---------------------------------------------------------------------------
# tests/test_kvstore_parity.py over the port's three engines
# ---------------------------------------------------------------------------

class _Trio:
    """The three engines side by side over one mutation surface."""

    def __init__(self, tmp_path, seed):
        self.rng = DeterministicRandom(seed)
        self.sim_files: dict[str, SimFile] = {}
        self.ssd_path = str(tmp_path / "parity.sqlite")
        self.memory = MemoryKeyValueStore(self._file("mem.0"),
                                          self._file("mem.1"))
        self.ssd = SSDKeyValueStore(self.ssd_path)
        self.redwood = self._open_redwood()

    def _file(self, name):
        if name not in self.sim_files:
            self.sim_files[name] = SimFile(name, self.rng.fork())
        return self.sim_files[name]

    def _open_redwood(self):
        return RedwoodKeyValueStore(
            self._file("rw.wal.0"), self._file("rw.wal.1"),
            self._file,
            lambda: [n for n in self.sim_files if n.startswith("rw.")
                     and not n.startswith("rw.wal")])

    def all(self):
        return [("memory", self.memory), ("ssd", self.ssd),
                ("redwood", self.redwood)]

    def reopen(self):
        self.memory = MemoryKeyValueStore(self._file("mem.0"),
                                          self._file("mem.1"))
        self.memory.recover()
        self.ssd.db.close()
        self.ssd = SSDKeyValueStore(self.ssd_path)
        self.redwood = self._open_redwood()
        self.redwood.recover()


def _check_parity(trio, rng):
    ref = trio.memory.get_range(b"", b"\xff" * 8)
    for name, eng in trio.all():
        assert eng.get_range(b"", b"\xff" * 8) == ref, name
        assert eng.get_range(b"", b"\xff" * 8, reverse=True) == \
            ref[::-1], name
        assert eng.get_range(b"", b"\xff" * 8, limit=7) == ref[:7], name
        assert eng.get_range(b"", b"\xff" * 8, limit=0) == [], name
    for _ in range(5):
        a = f"k{rng.randint(0, 150):04d}".encode()
        b = f"k{rng.randint(0, 150):04d}".encode()
        begin, end = min(a, b), max(a, b)
        sub = trio.memory.get_range(begin, end)
        pt = trio.memory.get(a)
        for name, eng in trio.all():
            assert eng.get_range(begin, end) == sub, name
            assert eng.get(a) == pt, name
    meta = trio.memory.get_metadata("durableVersion")
    for name, eng in trio.all():
        assert eng.get_metadata("durableVersion") == meta, name


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_three_engines_same_stream_same_reads(tmp_path, seed):
    trio = _Trio(tmp_path, seed)
    rng = DeterministicRandom(seed * 7 + 1)
    trio.memory.SNAPSHOT_OPS = 50
    for step in range(500):
        r = rng.random()
        if r < 0.65:
            k = f"k{rng.randint(0, 150):04d}".encode()
            v = bytes(rng.randint(0, 255)
                      for _ in range(rng.randint(1, 12)))
            for _n, eng in trio.all():
                eng.set(k, v)
        elif r < 0.80:
            a = f"k{rng.randint(0, 150):04d}".encode()
            b = f"k{rng.randint(0, 150):04d}".encode()
            begin, end = min(a, b), max(a, b)
            for _n, eng in trio.all():
                eng.clear_range(begin, end)
        elif r < 0.90:
            for _n, eng in trio.all():
                eng.set_metadata("durableVersion", str(step).encode())
        else:
            for _n, eng in trio.all():
                eng.commit()
            trio.redwood.maintain()
            _check_parity(trio, rng)
            if rng.random() < 0.3:
                trio.reopen()
                _check_parity(trio, rng)
    for _n, eng in trio.all():
        eng.commit()
    trio.reopen()
    _check_parity(trio, rng)
    assert trio.redwood.run_names(), "no runs flushed — budgets too large?"
