"""The port's C extension (foundationdb_tpu_torch/native/): its build, its
conflict chunk encoder, and the modules that take its path.

- The loader builds from scratch into a directory, and two processes that
  build into one empty directory at once both load the one library.
- The C encoder (`encode_conflict_ranges`) writes the packed batch buffer
  byte for byte as the numpy encoder does: pooled and strided layouts, all
  four shape buckets, keys longer than `key_bytes` (the round-up rule),
  empty keys, skip masks, snapshots below NEG and above 2^31; its limbs are
  the JAX package's `_encode_batch_c` limbs with the sign bit flipped, and
  the port's engine on the CPU decides seeded batches as the JAX engine
  does with the C encoder serving every chunk.
- Both packages' extensions load side by side, each with its own wire
  registry, and write equal bytes; natlint finds nothing in the port's C
  that it does not find in the JAX package's file.
- Where the extension is built, the versioned map, IndexedSet, the wire
  codec, CRC-32C and redwood take the C path; the port's native modules
  import neither jax nor the JAX package.

The module skips only where there is no C compiler.
"""

import os
import pathlib
import random
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.ops import conflict as tconf
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import (BatchEncoder, ConflictShapes,
                                                 DeviceConflictSet)
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
HAVE_CC = shutil.which(os.environ.get("CC", "cc")) is not None
pytestmark = pytest.mark.skipif(
    not HAVE_CC, reason="no C compiler: the port's extension cannot be built")

NEG = -(1 << 30)


@pytest.fixture(autouse=True)
def _port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)


# ----------------------------------------------------------------- build

def test_extension_is_built_where_a_compiler_exists():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    lib = pathlib.Path(native.mod.__file__)
    assert lib.parent == native.BUILD_DIR
    assert lib.name == native.library_name()
    assert sys.modules.get("fdb_native") is not native.mod


def test_build_from_scratch_into_a_directory(tmp_path):
    lib = native.build(tmp_path / "b")
    assert lib == tmp_path / "b" / native.library_name()
    m = native.load(lib)
    assert m.crc32c(b"123456789") == 0xE3069283
    assert m is not native.mod
    # nothing half-written is left beside the library
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, ".fdb_native.lock"])
    assert native.build(tmp_path / "b") == lib  # found, not rebuilt


def test_two_processes_build_one_empty_directory_at_once(tmp_path):
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from foundationdb_tpu_torch import native\n"
            "lib = native.build(Path(sys.argv[1]))\n"
            "m = native.load(lib)\n"
            "assert m.crc32c(b'123456789') == 0xE3069283\n"
            "print(lib.name)\n")
    out = tmp_path / "shared"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              cwd=ROOT, env=env()) for _ in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, results):
        assert p.returncode == 0, e.decode()[-2000:]
    names = {o.decode().strip() for o, _e in results}
    assert names == {native.library_name()}
    assert [p.name for p in out.iterdir() if p.suffix == ".so"] == [
        native.library_name()]
    assert not [p for p in out.iterdir() if p.name.endswith(".tmp")]


def test_both_packages_extensions_load_side_by_side():
    """Each package's extension is its own module with its own static wire
    registry; a struct of either package dumps to the same bytes through
    its own extension."""
    from foundationdb_tpu import native as j_native
    from foundationdb_tpu.server import interfaces as JI
    from foundationdb_tpu.utils import wire as j_wire
    from foundationdb_tpu_torch.server import interfaces as TI
    from foundationdb_tpu_torch.utils import wire as t_wire

    assert j_native.available() and native.available()
    assert j_native.mod is not native.mod
    assert sys.modules.get("fdb_native") is not native.mod
    assert j_native.mod.__file__ != native.mod.__file__
    t_wire._ensure_registry()
    j_wire._ensure_registry()
    assert t_wire._native is native.mod and j_wire._native is j_native.mod
    t_obj = TI.GetValueRequest(key=b"k", version=7)
    j_obj = JI.GetValueRequest(key=b"k", version=7)
    assert native.mod.wire_dumps(t_obj) == j_native.mod.wire_dumps(j_obj)
    # each registry knows its own package's class only
    with pytest.raises(Exception):
        native.mod.wire_dumps(j_obj)
    assert type(native.mod.wire_loads(
        native.mod.wire_dumps(t_obj))) is TI.GetValueRequest
    assert type(j_native.mod.wire_loads(
        j_native.mod.wire_dumps(j_obj))) is JI.GetValueRequest


def test_natlint_finds_nothing_the_jax_file_does_not():
    from foundationdb_tpu.analysis.natlint import analyze_c_source
    root = pathlib.Path(ROOT)
    rel = "foundationdb_tpu/native/fdb_native.c"

    def keys(path):
        return Counter((f.rule, f.symbol, f.detail) for f in analyze_c_source(
            (root / path).read_text(), rel))
    port = keys("foundationdb_tpu_torch/native/fdb_native.c")
    jax = keys(rel)
    assert not port - jax, sorted(port - jax)


def test_native_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from foundationdb_tpu_torch import native\n"
            "import foundationdb_tpu_torch.net.transport\n"
            "import foundationdb_tpu_torch.server.storage\n"
            "import foundationdb_tpu_torch.ops.conflict\n"
            "assert native.available(), native.build_error()\n"
            "native.build(native.BUILD_DIR)\n"
            "from foundationdb_tpu_torch.utils import wire\n"
            "wire._ensure_registry()\n"
            "assert wire._native is native.mod\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'foundationdb_tpu')]\n"
            "print(bad)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       cwd=ROOT, env=env(), timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert p.stdout.decode().strip() == "[]"


# ------------------------------------------------------- the C path serves

def test_every_module_takes_the_c_path():
    from foundationdb_tpu_torch.net import http
    from foundationdb_tpu_torch.net import native_transport as nt
    from foundationdb_tpu_torch.server.versioned_map import (
        NativeVersionedMap, make_versioned_map)
    from foundationdb_tpu_torch.storage import redwood as R
    from foundationdb_tpu_torch.utils import wire
    from foundationdb_tpu_torch.utils.indexedset import make_indexed_set

    assert isinstance(make_versioned_map(), NativeVersionedMap)
    assert type(make_indexed_set()) is native.mod.IndexedSet
    wire._ensure_registry()
    assert wire._native is native.mod
    assert nt.available() and nt.client_available()
    calls = []
    real = native.mod

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(real, name)
    native.mod = Spy()
    try:
        data = b"x" * 1000
        assert nt.crc32c(data) == http._crc32c(data) == R.crc32c(data) \
            == nt._py_crc32c(data)
        items = [(b"a", b"1"), (b"b", b"2")]
        assert R.decode_block(R.encode_block(items)) == items
        sec = R.bloom_build([b"a", b"b"], 10, 6)
        assert R.bloom_query(sec, b"a")
        assert nt.frame(1, 2, 0, b"x") == nt.py_frame(1, 2, 0, b"x")
    finally:
        native.mod = real
    assert {"crc32c", "redwood_encode_block", "redwood_decode_block",
            "redwood_bloom_build", "redwood_bloom_query",
            "transport_frame"} <= set(calls)


# -------------------------------------------------------- the chunk encoder

def rand_key(rng, kb):
    n = rng.choice([0, 1, 3, kb - 1, kb, kb + 1, kb + 9, 40])
    return bytes(rng.randrange(256) for _ in range(max(n, 0)))


def rand_txns(rng, n, kb, rpt, wpt, snaps):
    return [TxnConflictInfo(
        rng.choice(snaps),
        [(rand_key(rng, kb), rand_key(rng, kb))
         for _ in range(rng.randrange(0, rpt + 1))],
        [(rand_key(rng, kb), rand_key(rng, kb))
         for _ in range(rng.randrange(0, wpt + 1))]) for _ in range(n)]


def encode_both(enc, txns, skip, sh, version=5_000):
    """(C buffer, numpy buffer) of one chunk through `enc`'s one slot: the
    numpy one as where the extension is not built."""
    out = []
    for built in (True, False):
        before = tconf.kernel_metrics.as_dict()
        with pytest.MonkeyPatch.context() as mp:
            if not built:
                mp.setattr(native, "available", lambda: False)
            enc.encode_batch(txns, version, skip, sh)
        after = tconf.kernel_metrics.as_dict()
        key = "EncodedChunksC" if built else "EncodedChunksPy"
        assert after[key] == before[key] + 1
        slot = enc._slot(sh)
        out.append(slot["buf"].numpy().copy())
    return out


BASE = 1 << 32
SNAPS = (BASE, BASE + 17, BASE - 1, BASE + (1 << 31) + 5, BASE + (1 << 40),
         BASE + NEG - 3, 0, BASE + NEG)


@pytest.mark.parametrize("case", ["mixed", "long_keys", "empty_keys",
                                  "skip", "snapshots"])
@pytest.mark.parametrize("bucket", ["full", "small_reads", "small_writes",
                                    "small"])
def test_c_encoder_equals_numpy_pooled(bucket, case):
    rng = random.Random(f"{bucket}/{case}")
    kb = 24 if case != "long_keys" else 8
    sh = ConflictShapes(capacity=256, txns=32, reads=128, writes=128,
                        key_bytes=kb)
    enc = BatchEncoder(sh, torch.device("cpu"), base_version=BASE)
    r, w = {"full": (200, 200), "small_reads": (8, 200),
            "small_writes": (200, 8), "small": (8, 8)}[bucket]
    sub = enc.bucket_shapes(min(r, 128), min(w, 128))
    assert (sub.reads < 128) == (r == 8) and (sub.writes < 128) == (w == 8)
    for _ in range(12):
        txns, total_r, total_w = [], 0, 0
        for t in rand_txns(rng, rng.randrange(0, 33), kb, 4, 4, SNAPS):
            if case == "empty_keys":
                t = TxnConflictInfo(t.read_snapshot,
                                    [(b"", e) for _b, e in t.read_ranges],
                                    [(b, b"") for b, _e in t.write_ranges])
            if (total_r + len(t.read_ranges) > sub.reads
                    or total_w + len(t.write_ranges) > sub.writes):
                break
            total_r += len(t.read_ranges)
            total_w += len(t.write_ranges)
            txns.append(t)
        skip = ([rng.random() < 0.4 for _ in txns]
                if case in ("skip", "mixed") else None)
        c_buf, np_buf = encode_both(enc, txns, skip, sub)
        assert c_buf.tobytes() == np_buf.tobytes()


@pytest.mark.parametrize("case", ["mixed", "long_keys", "skip", "full"])
def test_c_encoder_equals_numpy_strided(case):
    rng = random.Random(len(case))
    kb = 16 if case != "long_keys" else 4
    sh = ConflictShapes(capacity=256, txns=16, reads=64, writes=48,
                        key_bytes=kb, strided=True)
    enc = BatchEncoder(sh, torch.device("cpu"), base_version=BASE)
    for _ in range(12):
        n = 16 if case == "full" else rng.randrange(0, 17)
        txns = rand_txns(rng, n, kb, 4, 3, SNAPS)
        skip = [rng.random() < 0.3 for _ in txns] if case != "full" else None
        c_buf, np_buf = encode_both(enc, txns, skip, sh)
        assert c_buf.tobytes() == np_buf.tobytes()


def test_c_encoder_raises_as_numpy_does():
    from foundationdb_tpu_torch.utils.errors import FDBError
    sh = ConflictShapes(capacity=64, txns=4, reads=8, writes=8)
    enc = BatchEncoder(sh, torch.device("cpu"))
    big = [TxnConflictInfo(0, [(b"a", b"b")] * 5, []) for _ in range(2)]
    for built in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not built:
                mp.setattr(native, "available", lambda: False)
            with pytest.raises(FDBError) as ei:
                enc.encode_batch(big, 1)
            assert ei.value.name == "internal_error"
            with pytest.raises(FDBError):
                enc.encode_batch([TxnConflictInfo(0, [], [])] * 5, 1)


@pytest.mark.parametrize("strided", [False, True])
def test_c_encoder_limbs_are_the_jax_encoders_flipped(strided):
    """The JAX package's encoder (its C pass in the pooled layout, its
    encode_keys_into in the strided one) and the port's C pass: the port's
    limbs are JAX's with the sign bit flipped, and the owners, snapshots
    and valid flags are equal."""
    from foundationdb_tpu import native as j_native
    from foundationdb_tpu.ops import conflict as jconf
    from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn

    assert j_native.available()
    rng = random.Random(7 + strided)
    kw = dict(capacity=256, txns=16, reads=64, writes=64, key_bytes=24,
              strided=strided)
    j_enc = jconf.BatchEncoder(jconf.ConflictShapes(**kw), base_version=BASE)
    t_enc = BatchEncoder(ConflictShapes(**kw), torch.device("cpu"),
                         base_version=BASE)
    for _ in range(10):
        txns = rand_txns(rng, rng.randrange(0, 17), 24, 4, 4, SNAPS)
        skip = [rng.random() < 0.3 for _ in txns]
        j = j_enc.encode_batch([JTxn(t.read_snapshot, t.read_ranges,
                                     t.write_ranges) for t in txns], 5, skip)
        t = t_enc.encode_batch(txns, 5, skip)
        for name in ("rb", "re", "wb", "we"):
            assert np.array_equal(t[name].numpy(),
                                  keylib.to_signed_limbs(np.asarray(j[name])))
        for name in ("rtxn", "wtxn", "snapshot"):
            assert np.array_equal(t[name].numpy(), np.asarray(j[name]))
        assert np.array_equal(t["txn_valid"].numpy(),
                              np.asarray(j["txn_valid"]))


def test_engine_with_the_c_encoder_decides_as_the_jax_engine(monkeypatch):
    """The port's engine on the CPU, every chunk encoded by the C pass,
    against the JAX engine (one compiled program) on seeded batches that
    chunk, skip too-old txns and conflict."""
    from foundationdb_tpu.ops import conflict as jconf
    from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn

    small = dict(capacity=1024, txns=64, reads_per_txn=4, writes_per_txn=4)

    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, 5_000_000, *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    jax = jconf.DeviceConflictSet(**small)
    port = DeviceConflictSet(device="cpu", **small)
    rng = np.random.default_rng(20)
    keys = [b"k%03d" % i + bytes(rng.integers(0, 256, int(rng.integers(0, 30)),
                                              dtype=np.uint8))
            for i in range(120)]
    before = tconf.kernel_metrics.as_dict()
    version, decided = 1_000_000, 0
    for _ in range(12):
        version += 100_000
        batch = []
        for _t in range(int(rng.integers(1, 100))):
            reads = [(keys[i], keys[i] + b"\x00")
                     for i in rng.integers(0, 120, int(rng.integers(0, 4)))]
            writes = [(keys[i], keys[i] + b"\x01")
                      for i in rng.integers(0, 120, int(rng.integers(0, 4)))]
            snap = version - int(rng.integers(1, 6_000_000))
            batch.append(TxnConflictInfo(snap, reads, writes))
        got = port.detect(batch, version)
        want = jax.detect([JTxn(t.read_snapshot, t.read_ranges,
                                t.write_ranges) for t in batch], version)
        assert got == want
        decided += len(got)
    after = tconf.kernel_metrics.as_dict()
    chunks = after["KernelDispatches"] - before["KernelDispatches"]
    assert chunks > 12  # batches past T=64 chunk
    assert after["EncodedChunksC"] - before["EncodedChunksC"] == chunks
    assert after["EncodedChunksPy"] == before["EncodedChunksPy"]
    assert decided > 0


def test_encoder_takes_numpy_where_the_extension_is_not_built(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    sh = ConflictShapes(capacity=64, txns=4, reads=8, writes=8)
    enc = BatchEncoder(sh, torch.device("cpu"))
    before = tconf.kernel_metrics.as_dict()
    enc.encode_batch([TxnConflictInfo(0, [(b"a", b"b")], [])], 1)
    after = tconf.kernel_metrics.as_dict()
    assert after["EncodedChunksPy"] == before["EncodedChunksPy"] + 1
    assert after["EncodedChunksC"] == before["EncodedChunksC"]


def test_c_wire_codecs_write_equal_bytes_over_every_wire_type():
    """A seeded fuzz over every registered wire type: the port's C codec
    and the JAX package's write the same bytes for twin structs (or both
    hand the value to their Python codec), each decodes the other's
    bytes, and the Python codecs agree with them."""
    from foundationdb_tpu import native as j_native
    from foundationdb_tpu.utils import wire as j_wire
    from foundationdb_tpu_torch.utils import wire as t_wire
    from test_torch_transport import _random_value, _twin_structs

    rng = np.random.default_rng(20)
    native_frames = 0
    for _round in range(3):
        for tid, t_obj, j_obj in _twin_structs(rng, t_wire, j_wire):
            extra = _random_value(rng)
            outs = []
            for m, obj in ((native.mod, t_obj), (j_native.mod, j_obj)):
                try:
                    outs.append(m.wire_dumps([obj, extra]))
                except Exception as e:  # noqa: BLE001
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1], tid
            body = t_wire._py_dumps([t_obj, extra])
            assert body == j_wire._py_dumps([j_obj, extra])
            if isinstance(outs[0], bytes):
                native_frames += 1
                assert outs[0] == body
                back = native.mod.wire_loads(outs[1])
                assert type(back[0]).__name__ == type(t_obj).__name__
                assert t_wire._py_dumps(back) == body
    assert native_frames > 0
