"""Native redwood read-path parity: the C RedwoodRun handle, per-run bloom
filters, and the batched GetValuesReply encoder must agree with their
pure-Python fallbacks on every decision and every byte, over randomized
flush/compact/reopen cycles including torn-run and superseded-run recovery
states.

The port's copy of tests/test_redwood_native.py, run on the port's own C
extension; it skips only where there is no C compiler.
"""

import os
import shutil

import pytest

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.core.sim import SimFile
from foundationdb_tpu_torch.storage import redwood as R
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

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


class _Files:
    """SimFile surface for the port's engine: WAL pair + named run files
    (tests/test_redwood.py's helper over the port's SimFile and store)."""

    def __init__(self, seed=0):
        self.rng = DeterministicRandom(seed)
        self.files: dict = {}

    def open(self, name):
        if name not in self.files:
            self.files[name] = SimFile(name, self.rng.fork())
        return self.files[name]

    def existing(self):
        return [n for n in self.files if n.startswith("rw.")]

    def store(self) -> R.RedwoodKeyValueStore:
        return R.RedwoodKeyValueStore(self.open("wal.0"), self.open("wal.1"),
                                      self.open, self.existing)

    def kill_all(self):
        for f in self.files.values():
            f.on_kill()


def _rand_key(rng):
    return bytes(rng.randint(97, 105) for _ in range(rng.randint(1, 10)))


def _rand_entries(rng, n):
    keys = sorted({_rand_key(rng) for _ in range(n)})
    return [(k, bytes(rng.randint(0, 255)
                      for _ in range(rng.randint(0, 24)))) for k in keys]


def _rand_clears(rng, n):
    out = []
    for _ in range(n):
        b, e = sorted((_rand_key(rng), _rand_key(rng)))
        if b != e:
            out.append((b, e))
    return out


def _ref_run_lookup(entries_map, clears, key):
    """Single-run reference decision: (status, value) with the C contract —
    1 = found (an in-run entry beats the run's own clears), 2 = shadowed,
    0 = miss."""
    if key in entries_map:
        return 1, entries_map[key]
    if any(b <= key < e for b, e in clears):
        return 2, None
    return 0, None


def _build_image(rng, entries, clears, run_id=1, bpk=10, nh=6):
    return R.build_run_image(
        entries, clears, meta={}, run_id=run_id, meta_seq=run_id,
        level=0, sources=(), block_bytes=rng.random_choice([64, 128, 512]),
        bloom_bits_per_key=bpk, bloom_hashes=nh)


# ---------------------------------------------------------------------------
# bloom filters: byte + decision parity, never-false-negative
# ---------------------------------------------------------------------------

def fuzz_bloom_parity(seed=0, rounds=60):
    rng = DeterministicRandom(seed)
    for _ in range(rounds):
        keys = [k for k, _v in _rand_entries(rng, rng.randint(0, 40))]
        bpk = rng.randint(1, 16)
        nh = rng.randint(1, 12)
        c_sec = native.mod.redwood_bloom_build(keys, bpk, nh)
        py_sec = R.py_bloom_build(keys, bpk, nh)
        assert c_sec == py_sec  # byte-identical, not just equivalent
        for k in keys:  # members: NEVER a false negative, either side
            assert native.mod.redwood_bloom_query(c_sec, k) is True
            assert R.py_bloom_query(py_sec, k) is True
        for _ in range(30):  # non-members: identical (maybe-False) verdicts
            probe = _rand_key(rng)
            assert (native.mod.redwood_bloom_query(c_sec, probe)
                    == R.py_bloom_query(py_sec, probe))


def test_bloom_parity_fuzz():
    fuzz_bloom_parity(seed=101)


def test_bloom_rejects_bad_inputs():
    for fn in (native.mod.redwood_bloom_build, R.py_bloom_build):
        with pytest.raises(ValueError):
            fn([b"k"], 0, 6)  # bits_per_key < 1
        with pytest.raises(ValueError):
            fn([b"k"], 10, 0)  # n_hashes out of range
        with pytest.raises(ValueError):
            fn([b"k"], 10, 65)
    sec = R.py_bloom_build([b"alpha", b"beta"], 10, 6)
    for bad in (b"", sec[:10], sec + b"\x00", b"\x00" * len(sec)):
        with pytest.raises(ValueError):
            native.mod.redwood_bloom_query(bad, b"alpha")
        with pytest.raises(ValueError):
            R.py_bloom_query(bad, b"alpha")


# ---------------------------------------------------------------------------
# run handle: open/get parity over randomized runs, corruption rejection
# ---------------------------------------------------------------------------

def fuzz_run_handle_parity(seed=0, rounds=40):
    rng = DeterministicRandom(seed)
    for _ in range(rounds):
        entries = _rand_entries(rng, rng.randint(0, 60))
        clears = _rand_clears(rng, rng.randint(0, 4))
        bpk = rng.random_choice([0, 10])  # with and without a bloom section
        image = _build_image(rng, entries, clears, bpk=bpk)
        handle = native.mod.redwood_run_open(
            image, [tuple(c) for c in clears], rng.randint(1, 8))
        emap = dict(entries)
        probes = [k for k, _v in entries] + [_rand_key(rng)
                                             for _ in range(80)]
        for k in probes:
            st, val = handle.get(k)
            ref_st, ref_val = _ref_run_lookup(emap, clears, k)
            assert (st, val) == (ref_st, ref_val), (k, st, ref_st)
            if bpk:  # bloom verdicts agree between C handle and Python
                bloom = R.py_bloom_build([k for k, _v in entries], bpk, 6)
                if not R.py_bloom_query(bloom, k):
                    assert st in (0, 2)  # a negative can never hide a hit
        stats = handle.stats()
        assert stats["blocks_decoded"] <= stats["block_cache_misses"] + 1
        handle.close()
        handle.close()  # idempotent
        with pytest.raises(ValueError):
            handle.get(b"x")  # closed handle refuses reads


def test_run_handle_parity_fuzz():
    fuzz_run_handle_parity(seed=202)


def fuzz_run_open_rejects_corrupt(seed=0, rounds=40):
    rng = DeterministicRandom(seed)
    entries = _rand_entries(rng, 30)
    image = _build_image(rng, entries, [])
    for _ in range(rounds):
        mode = rng.randint(0, 2)
        if mode == 0:  # truncation anywhere
            bad = image[:rng.randint(0, len(image) - 1)]
        elif mode == 1:  # body byte flip -> CRC mismatch
            i = rng.randint(R._RUN_HEADER.size, len(image) - 1)
            bad = image[:i] + bytes([image[i] ^ 0xFF]) + image[i + 1:]
        else:  # header magic/version stomp
            i = rng.randint(0, 7)
            bad = image[:i] + bytes([image[i] ^ 0xFF]) + image[i + 1:]
        with pytest.raises(ValueError):
            native.mod.redwood_run_open(bad, [], 4)
        assert R.parse_run(bad, None, "") is None  # Python agrees: unusable


def test_run_open_rejects_corrupt_images():
    fuzz_run_open_rejects_corrupt(seed=303)


def fuzz_runs_cascade_parity(seed=0, rounds=25):
    """Multi-run newest-first cascade (redwood_runs_get / get_batch) vs a
    Python fold over the same shadowing rules."""
    rng = DeterministicRandom(seed)
    for _ in range(rounds):
        runs = []  # newest first: (entries_map, clears, handle)
        for run_id in range(rng.randint(1, 4), 0, -1):
            entries = _rand_entries(rng, rng.randint(0, 40))
            clears = _rand_clears(rng, rng.randint(0, 3))
            image = _build_image(rng, entries, clears, run_id=run_id,
                                 bpk=rng.random_choice([0, 10]))
            handle = native.mod.redwood_run_open(image, clears, 4)
            runs.append((dict(entries), clears, handle))
        handles = [h for _e, _c, h in runs]

        def ref_get(key):
            for emap, clears, _h in runs:  # newest -> oldest
                st, val = _ref_run_lookup(emap, clears, key)
                if st == 1:
                    return val
                if st == 2:
                    return None
            return None

        probes = [_rand_key(rng) for _ in range(120)]
        for k in probes:
            assert native.mod.redwood_runs_get(handles, k) == ref_get(k)
        batch = native.mod.redwood_runs_get_batch(handles, probes)
        assert batch == [ref_get(k) for k in probes]
        for h in handles:
            h.close()


def test_runs_cascade_parity_fuzz():
    fuzz_runs_cascade_parity(seed=404)


# ---------------------------------------------------------------------------
# store-level lifecycle parity: native vs Python fallback vs dict model over
# flush/compact/reopen cycles, torn tails, superseded sources
# ---------------------------------------------------------------------------

def _store_knobs():
    KNOBS.set("REDWOOD_MEMTABLE_BYTES", 512)
    KNOBS.set("REDWOOD_BLOCK_BYTES", 128)
    KNOBS.set("REDWOOD_COMPACTION_FAN_IN", 2)
    KNOBS.set("REDWOOD_BLOCK_CACHE_BLOCKS", 8)


def fuzz_store_lifecycle_parity(seed=0, ops=500, kills=2):
    """One mutation stream -> a dict model, reads cross-checked with the
    native path ON and OFF after every maintenance step, through sim kills
    (torn WAL/run tails) and recovery."""
    _store_knobs()
    try:
        rng = DeterministicRandom(seed)
        fs = _Files(seed)
        st = fs.store()
        model: dict[bytes, bytes] = {}
        synced: dict[bytes, bytes] = {}
        for i in range(ops):
            k = b"k%03d" % rng.randint(0, 149)
            if rng.randint(0, 9) == 0:
                b, e = sorted((b"k%03d" % rng.randint(0, 149),
                               b"k%03d" % rng.randint(0, 149)))
                st.clear_range(b, e)
                for kk in [kk for kk in model if b <= kk < e]:
                    del model[kk]
            else:
                v = b"v%05d" % i
                st.set(k, v)
                model[k] = v
            if rng.randint(0, 3) == 0:
                st.commit()
                st.maintain()
                synced = dict(model)
            if kills and rng.randint(0, ops // (kills + 1)) == 0:
                kills -= 1
                fs.kill_all()
                st = fs.store()
                st.recover()
                model = dict(synced)
        st.commit()
        st.maintain()
        probes = sorted({b"k%03d" % i for i in range(150)}
                        | {_rand_key(rng) for _ in range(50)})
        KNOBS.set("REDWOOD_NATIVE_READS", 1)
        native_reads = [st.get(k) for k in probes]
        native_batch = st.get_batch(probes)
        KNOBS.set("REDWOOD_NATIVE_READS", 0)
        py_reads = [st.get(k) for k in probes]
        expect = [model.get(k) for k in probes]
        assert native_reads == expect
        assert native_batch == expect
        assert py_reads == expect
        # reopen once more: recovery reopens native handles from disk
        st2 = fs.store()
        st2.recover()
        KNOBS.set("REDWOOD_NATIVE_READS", 1)
        assert [st2.get(k) for k in probes] == expect
    finally:
        KNOBS.reset()


def test_store_lifecycle_parity_fuzz():
    fuzz_store_lifecycle_parity(seed=505)


def test_superseded_run_recovery_retires_native_handles():
    """A crash between a compacted run's sync and its source truncation
    leaves both on disk; recovery must drop the sources (and their C
    handles) and serve only the merged run — on both read paths."""
    _store_knobs()
    fs = _Files(7)
    # manufacture the state directly: two level-0 sources + the merged run
    a = R.build_run_image([(b"a", b"1"), (b"b", b"stale")], [], {},
                          run_id=1, meta_seq=1, level=0, sources=(),
                          block_bytes=128)
    b = R.build_run_image([(b"b", b"2"), (b"c", b"3")], [], {},
                          run_id=2, meta_seq=2, level=0, sources=(),
                          block_bytes=128)
    merged = R.build_run_image(
        [(b"a", b"1"), (b"b", b"2"), (b"c", b"3")], [], {},
        run_id=3, meta_seq=2, level=1, sources=(1, 2), block_bytes=128)
    for name, img in (("rw.1", a), ("rw.2", b), ("rw.3", merged)):
        f = fs.open(name)
        f.append(img)
        f.sync()
    st = fs.store()
    st.recover()
    assert st.run_names() == ["rw.3"]
    for knob in (1, 0):
        KNOBS.set("REDWOOD_NATIVE_READS", knob)
        assert st.get(b"a") == b"1"
        assert st.get(b"b") == b"2"
        assert st.get(b"c") == b"3"
        assert st.get(b"zz") is None


# ---------------------------------------------------------------------------
# batched encoded replies: byte parity with the Python wire encoder
# ---------------------------------------------------------------------------

def fuzz_batched_encode_parity(seed=0, rounds=6):
    from foundationdb_tpu_torch.server.interfaces import GetValuesReply
    from foundationdb_tpu_torch.utils import wire
    _store_knobs()
    try:
        tid = wire.type_id(GetValuesReply)
        rng = DeterministicRandom(seed)
        for _ in range(rounds):
            fs = _Files(rng.randint(0, 1 << 30))
            st = fs.store()
            model: dict[bytes, bytes] = {}
            for i in range(rng.randint(50, 300)):
                k = b"k%03d" % rng.randint(0, 99)
                v = b"v%05d" % i
                st.set(k, v)
                model[k] = v
                if rng.randint(0, 4) == 0:
                    st.commit()
                    st.maintain()
            st.commit()
            st.maintain()
            oldest = 50
            reads = [(b"k%03d" % rng.randint(0, 120),
                      rng.randint(0, 100)) for _ in range(150)]
            enc = st.get_batch_encoded(reads, oldest, tid)
            assert enc is not None  # all runs carry native handles here
            results = [(1, "transaction_too_old") if v < oldest
                       else (0, model.get(k)) for k, v in reads]
            assert enc == wire.dumps(GetValuesReply(results=results))
    finally:
        KNOBS.reset()


def test_batched_encode_parity_fuzz():
    fuzz_batched_encode_parity(seed=606)


# ---------------------------------------------------------------------------
# acceptance: blooms measurably cut blocks decoded on cold misses
# ---------------------------------------------------------------------------

def _cold_miss_blocks(bpk, native_reads):
    KNOBS.set("REDWOOD_MEMTABLE_BYTES", 512)
    KNOBS.set("REDWOOD_BLOCK_BYTES", 128)
    KNOBS.set("REDWOOD_COMPACTION_FAN_IN", 4)  # keep several runs live
    KNOBS.set("REDWOOD_BLOOM_BITS_PER_KEY", bpk)
    KNOBS.set("REDWOOD_NATIVE_READS", native_reads)
    fs = _Files(11)
    st = fs.store()
    for i in range(400):
        st.set(b"k%04dp" % i, b"v%04d" % i)
        if i % 60 == 59:
            st.commit()
            st.maintain()
    st.commit()
    st.maintain()
    st2 = fs.store()  # fresh store: every block cache is cold
    st2.recover()
    for i in range(400):
        # interleaved misses: each bisects into a different block, so
        # without a bloom every one decodes a cold block
        assert st2.get(b"k%04dx" % i) is None
    return st2.read_stats()


@pytest.mark.parametrize("native_reads", [1, 0])
def test_bloom_reduces_cold_miss_block_decodes(native_reads):
    with_bloom = _cold_miss_blocks(10, native_reads)
    without = _cold_miss_blocks(0, native_reads)
    assert with_bloom["bloom_negatives"] > 0
    assert with_bloom["blocks_decoded"] < without["blocks_decoded"]
    if native_reads:
        assert with_bloom["native_gets"] > 0
        assert with_bloom["fallback_gets"] == 0
    else:
        assert with_bloom["native_gets"] == 0
        assert with_bloom["fallback_gets"] > 0


# ---------------------------------------------------------------------------
# across packages: one run file, either package's C handle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_run_written_by_one_package_opens_in_the_other(writer):
    """A run image (blocks, index, bloom) built by either package equals
    the other's byte for byte, and opens in both packages' C handles with
    equal answers; the block and bloom codecs of the two extensions write
    the same bytes."""
    from foundationdb_tpu import native as j_native
    from foundationdb_tpu.storage import redwood as JR

    rng = DeterministicRandom(31 + (writer == "jax"))
    for _ in range(12):
        entries = _rand_entries(rng, rng.randint(0, 50))
        clears = _rand_clears(rng, rng.randint(0, 3))
        kw = dict(meta={}, run_id=3, meta_seq=3, level=1, sources=(),
                  block_bytes=rng.random_choice([64, 256]),
                  bloom_bits_per_key=rng.random_choice([0, 10]),
                  bloom_hashes=6)
        image = (R if writer == "port" else JR).build_run_image(
            entries, clears, **kw)
        other = (JR if writer == "port" else R).build_run_image(
            entries, clears, **kw)
        assert image == other
        handles = [m.redwood_run_open(image, [tuple(c) for c in clears], 4)
                   for m in (native.mod, j_native.mod)]
        probes = [k for k, _v in entries] + [_rand_key(rng)
                                             for _ in range(40)]
        for k in probes:
            assert handles[0].get(k) == handles[1].get(k), k
        for h in handles:
            h.close()
        assert native.mod.redwood_encode_block(entries) == \
            j_native.mod.redwood_encode_block(entries)
        keys = [k for k, _v in entries]
        assert native.mod.redwood_bloom_build(keys, 10, 6) == \
            j_native.mod.redwood_bloom_build(keys, 10, 6)
