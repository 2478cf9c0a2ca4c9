"""Parity fuzz: the C VStore read path vs the pure-Python VersionedMap.

The native store (native/fdb_native.c VStore, wrapped by NativeVersionedMap)
must be observationally identical to VersionedMap — it is chosen silently by
make_versioned_map(), so any divergence is a storage-corruption bug. The fuzz
drives both through identical mutation/clear/GC interleavings and then
cross-checks every read surface at random versions: point gets, batched gets
(including transaction_too_old results), all four key-selector base forms
with offsets, range reads with limit/byte-limit/reverse, and the wire frames
the C store emits directly (must byte-equal the canonical Python codec's
encoding of the fallback's reply).

The port's copy of tests/test_vstore_parity.py, run on the port's own C
extension; it skips only where there is no C compiler.
"""

from __future__ import annotations

import os
import random
import shutil

import pytest

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.server.interfaces import (
    GetKeyValuesReply, GetValuesReply, KeySelector)
from foundationdb_tpu_torch.server.versioned_map import (
    NativeVersionedMap, VersionedMap, make_versioned_map)
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.types import Mutation, MutationType

HAVE_CC = shutil.which(os.environ.get("CC", "cc")) is not None
HAVE_NATIVE = HAVE_CC and native.available()

KEYSPACE = [b"k%03d" % i for i in range(40)] + [b"", b"\x00", b"\xfe\xff"]


def _rand_key(rng: random.Random) -> bytes:
    return rng.choice(KEYSPACE)


def _rand_value(rng: random.Random) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 24)))


def _mutate_both(rng: random.Random, maps, version: int):
    roll = rng.random()
    if roll < 0.55:
        m = Mutation(MutationType.SET_VALUE, _rand_key(rng), _rand_value(rng))
    elif roll < 0.75:
        a, b = _rand_key(rng), _rand_key(rng)
        if a > b:
            a, b = b, a
        m = Mutation(MutationType.CLEAR_RANGE, a, b + b"\x00")
    elif roll < 0.9:
        op = rng.choice([MutationType.ADD_VALUE, MutationType.BYTE_MAX,
                         MutationType.APPEND_IF_FITS])
        m = Mutation(op, _rand_key(rng), _rand_value(rng)[:8])
    else:
        m = Mutation(MutationType.SET_VALUE, _rand_key(rng), None)
        m = Mutation(MutationType.CLEAR_RANGE, m.param1, m.param1 + b"\x00")
    for vm in maps:
        vm.apply(version, m)


def _check_reads(rng: random.Random, py: VersionedMap, nat, version: int):
    key = _rand_key(rng)
    assert py.get(key, version) == nat.get(key, version)

    reads = [(_rand_key(rng), rng.randrange(max(0, version - 30), version + 1))
             for _ in range(rng.randrange(1, 6))]
    assert py.get_batch(reads) == nat.get_batch(reads)

    sel = KeySelector(key=_rand_key(rng), or_equal=rng.random() < 0.5,
                      offset=rng.randrange(-3, 4))
    assert py.resolve_selector(sel, version) == nat.resolve_selector(
        sel, version), sel

    a, b = _rand_key(rng), _rand_key(rng)
    if a > b:
        a, b = b, a
    limit = rng.choice([0, 1, 2, 5])
    limit_bytes = rng.choice([0, 0, 30, 200])
    reverse = rng.random() < 0.3
    assert py.range_read(a, b + b"\x00", version, limit, limit_bytes,
                         reverse) == nat.range_read(
        a, b + b"\x00", version, limit, limit_bytes, reverse)


def _check_encoded(rng: random.Random, py: VersionedMap, nat, version: int):
    """The C store's one-pass wire frames must byte-equal the canonical
    Python codec run over the fallback's reply objects."""
    reads = [(_rand_key(rng), rng.randrange(max(0, version - 30), version + 1))
             for _ in range(rng.randrange(1, 6))]
    frame = nat.get_batch_encoded(reads)
    assert frame == wire._py_dumps(GetValuesReply(results=py.get_batch(reads)))
    assert wire.loads(frame) == GetValuesReply(results=py.get_batch(reads))

    a, b = _rand_key(rng), _rand_key(rng)
    if a > b:
        a, b = b, a
    limit, reverse = rng.choice([0, 3]), rng.random() < 0.3
    data, more = py.range_read(a, b + b"\x00", version, limit, 0, reverse)
    frame = nat.range_read_encoded(a, b + b"\x00", version, limit, 0, reverse)
    assert frame == wire._py_dumps(
        GetKeyValuesReply(data=data, more=more, version=version))


@pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_vstore_parity_fuzz(seed):
    rng = random.Random(seed)
    py = VersionedMap()
    nat = NativeVersionedMap()
    version = 0
    for step in range(1200):
        roll = rng.random()
        if roll < 0.45:
            version += rng.randrange(1, 4)
            _mutate_both(rng, (py, nat), version)
        elif roll < 0.5 and version > 0:
            v = rng.randrange(0, version + 1)
            py.forget_before(v)
            nat.forget_before(v)
            assert py.oldest_version == nat.oldest_version
        elif roll < 0.53 and version > 0:
            v = rng.randrange(max(0, version - 10), version + 1)
            py.rollback(v)
            nat.rollback(v)
            version = max(py.latest_version, py.oldest_version)
            assert py.latest_version == nat.latest_version
        else:
            _check_reads(rng, py, nat, rng.randrange(
                py.oldest_version, version + 1) if version else 0)
        if step % 97 == 0:
            assert py.key_count() == nat.key_count()
            assert py.byte_size() == nat.byte_size()
    assert py.key_count() == nat.key_count()
    assert py.byte_size() == nat.byte_size()


@pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")
def test_vstore_too_old_parity():
    py, nat = VersionedMap(), NativeVersionedMap()
    for vm in (py, nat):
        vm.apply(5, Mutation(MutationType.SET_VALUE, b"a", b"1"))
        vm.forget_before(5)
    for vm in (py, nat):
        with pytest.raises(FDBError) as ei:
            vm.get(b"a", 3)
        assert ei.value.name == "transaction_too_old"
        with pytest.raises(FDBError):
            vm.range_read(b"", b"z", 3)
        with pytest.raises(FDBError):
            vm.resolve_selector(KeySelector(b"a", False, 1), 3)
    # batched gets report staleness per-key, not as a batch error
    assert py.get_batch([(b"a", 3), (b"a", 5)]) \
        == nat.get_batch([(b"a", 3), (b"a", 5)]) \
        == [(1, "transaction_too_old"), (0, b"1")]


@pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")
@pytest.mark.parametrize("seed", [11, 12])
def test_vstore_encoded_reply_parity(seed):
    rng = random.Random(seed)
    py = VersionedMap()
    nat = NativeVersionedMap()
    version = 0
    for _ in range(300):
        if rng.random() < 0.5:
            version += rng.randrange(1, 3)
            _mutate_both(rng, (py, nat), version)
        elif version:
            _check_encoded(rng, py, nat,
                           rng.randrange(py.oldest_version, version + 1))


def test_selector_forms_parity():
    """All four KeySelector base forms (FDBTypes.h) ± offsets, against a
    fixed store — runs on the Python fallback alone when the extension is
    missing, so selector semantics stay pinned either way."""
    maps = [VersionedMap()]
    if HAVE_NATIVE:
        maps.append(NativeVersionedMap())
    for vm in maps:
        for i, k in enumerate([b"a", b"c", b"e", b"g"]):
            vm.apply(i + 1, Mutation(MutationType.SET_VALUE, k, b"v"))
        vm.apply(5, Mutation(MutationType.CLEAR_RANGE, b"e", b"e\x00"))
    cases = []
    for key in [b"", b"a", b"b", b"c", b"e", b"g", b"z"]:
        for or_equal, offset in [(False, 1), (True, 1),   # fge / fgt
                                 (True, 0), (False, 0),   # lle / llt
                                 (False, 3), (True, -2), (False, -1)]:
            cases.append(KeySelector(key, or_equal, offset))
    expect = {
        (b"b", False, 1): b"c",   # first_greater_or_equal(b) -> c
        (b"c", True, 1): b"g",    # first_greater_than(c) skips cleared e
        (b"e", True, 0): b"c",    # last_less_or_equal(e): e is cleared
        (b"z", False, 0): b"g",   # last_less_than(z)
        (b"z", False, 1): b"\xff\xff",
        (b"", False, 0): b"",
    }
    for sel in cases:
        results = [vm.resolve_selector(sel, 5) for vm in maps]
        assert all(r == results[0] for r in results), sel
        want = expect.get((sel.key, sel.or_equal, sel.offset))
        if want is not None:
            assert results[0] == want, sel


def test_python_fallback_always_constructible():
    """make_versioned_map must hand back a working store even when the
    extension is absent (the factory's whole point)."""
    vm = make_versioned_map()
    vm.apply(1, Mutation(MutationType.SET_VALUE, b"k", b"v"))
    assert vm.get(b"k", 1) == b"v"
    # and the pure-Python class itself serves the same surface
    py = VersionedMap()
    py.apply(1, Mutation(MutationType.SET_VALUE, b"k", b"v"))
    assert py.get_batch([(b"k", 1)]) == [(0, b"v")]
    assert py.resolve_selector(KeySelector(b"", False, 1), 1) == b"k"


@pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")
@pytest.mark.parametrize("seed", [21, 22])
def test_vstore_frames_equal_the_jax_extensions(seed):
    """The same mutations into the port's C VStore and the JAX package's:
    every read answers the same, and the one-pass wire frames
    (get_many_encode, range_read_encode) are equal byte for byte."""
    from foundationdb_tpu.server import versioned_map as j_vm
    from foundationdb_tpu.utils import types as j_types

    rng = random.Random(seed)
    port, jax = NativeVersionedMap(), j_vm.NativeVersionedMap()
    version = 0
    for _ in range(400):
        if rng.random() < 0.5:
            version += rng.randrange(1, 3)
            a, b = sorted((_rand_key(rng), _rand_key(rng)))
            roll, value = rng.random(), _rand_value(rng)
            if roll < 0.7:
                args = (MutationType.SET_VALUE, a, value)
            elif roll < 0.85:
                args = (MutationType.CLEAR_RANGE, a, b + b"\x00")
            else:
                args = (MutationType.ADD_VALUE, a, value[:8])
            port.apply(version, Mutation(*args))
            jax.apply(version, j_types.Mutation(
                j_types.MutationType(int(args[0])), *args[1:]))
        elif rng.random() < 0.1 and version:
            v = rng.randrange(0, version + 1)
            port.forget_before(v)
            jax.forget_before(v)
        elif version:
            v = rng.randrange(port.oldest_version, version + 1)
            reads = [(_rand_key(rng), rng.randrange(max(0, v - 30), v + 1))
                     for _ in range(rng.randrange(1, 6))]
            assert port.get_batch(reads) == jax.get_batch(reads)
            assert port.get_batch_encoded(reads) == \
                jax.get_batch_encoded(reads)
            a, b = sorted((_rand_key(rng), _rand_key(rng)))
            limit, reverse = rng.choice([0, 3]), rng.random() < 0.3
            assert port.range_read_encoded(a, b + b"\x00", v, limit, 0,
                                           reverse) == \
                jax.range_read_encoded(a, b + b"\x00", v, limit, 0, reverse)
    assert port.key_count() == jax.key_count()
    assert port.byte_size() == jax.byte_size()
