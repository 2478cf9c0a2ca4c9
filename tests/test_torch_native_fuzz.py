"""Fuzz bodies on the port's C extension that need neither torch nor jax.

Two parity fuzzes whose suites import torch or jax live here, so that the
sanitizer harness (`python -m foundationdb_tpu_torch.native.sanitize`)
runs the very bodies these tests run, on an ASan/UBSan build, in a process
that loads neither:

- `fuzz_codec_parity`: redwood's block codec, CRC-32C and bloom filters,
  the C paths against the port's Python ones byte for byte (and, where
  tests/test_torch_redwood.py hands it the JAX module, against JAX's);
- `fuzz_encoder_parity` and `encoder_refusals`: the C chunk encoder
  `encode_conflict_ranges` against the numpy encode (ops/encode_np.py)
  over both layouts, and what it refuses.

This module imports neither torch nor jax.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.net import native_transport as nt
from foundationdb_tpu_torch.ops import encode_np
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.storage import redwood as R
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

HAVE_NATIVE = native.available() and hasattr(native.mod,
                                             "encode_conflict_ranges")
needs_native = pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")


# ------------------------------------------------------------- block codec

def random_items(rng, n):
    keys = sorted({bytes(rng.randint(97, 103) for _ in range(
        rng.randint(1, 12))) for _ in range(n)})
    return [(k, bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 20))))
            for k in keys]


def fuzz_codec_parity(seed: int, rounds: int = 60, ref=None, ref_native=None):
    """Seeded fuzz: the port's block images, CRCs and bloom sections by its
    C paths equal its Python ones byte for byte, each decodes the other's,
    and every query answers alike. With `ref` (the JAX package's redwood
    module) they also equal its Python bytes and its dispatching ones, and
    `ref_native`'s (the JAX extension) C image."""
    rng = DeterministicRandom(seed)
    for _ in range(rounds):
        items = random_items(rng, rng.randint(0, 40))
        img = R.encode_block(items)
        assert img == R.py_encode_block(items)
        assert R.decode_block(img) == items
        assert R.py_decode_block(img) == items
        if ref is not None:
            assert img == ref.py_encode_block(items) == ref.encode_block(items)
            assert R.decode_block(ref.encode_block(items)) == items
        if ref_native is not None and hasattr(ref_native,
                                              "redwood_encode_block"):
            assert img == ref_native.redwood_encode_block(items)
        data = bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 300)))
        assert R.crc32c(data) == nt._py_crc32c(data)
        if ref is not None:
            assert R.crc32c(data) == ref.crc32c(data)
        keys = [k for k, _v in items]
        bits, hashes = rng.randint(1, 16), rng.randint(1, 12)
        bloom = R.bloom_build(keys, bits, hashes)
        assert bloom == R.py_bloom_build(keys, bits, hashes)
        if ref is not None:
            assert bloom == ref.py_bloom_build(keys, bits, hashes)
            assert bloom == ref.bloom_build(keys, bits, hashes)
        probe = keys + [bytes(rng.randint(97, 103) for _ in range(5))
                        for _ in range(10)]
        for k in probe:
            got = R.bloom_query(bloom, k)
            assert got == R.py_bloom_query(bloom, k)
            if ref is not None:
                assert got == ref.py_bloom_query(bloom, k)
            if k in keys:
                assert got
    assert R.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("seed", [5, 6])
def test_codec_parity_fuzz(seed):
    fuzz_codec_parity(seed)


# ----------------------------------------------------------- chunk encoder

def chunk_views(L: int, T: int, NR: int, NW: int, fill: int) -> dict:
    """One chunk's fields as numpy arrays of the engine's dtypes, every
    byte `fill` (so a field left unwritten shows)."""
    shapes = {"rb": (L, NR), "re": (L, NR), "wb": (L, NW), "we": (L, NW),
              "rtxn": (NR,), "wtxn": (NW,), "snapshot": (T,)}
    out = {k: np.full(s, fill * 0x01010101, np.uint32).view(np.int32)
           for k, s in shapes.items()}
    out["txn_valid"] = np.full((T,), fill, np.uint8)
    return out


def encode_c(host, txns, skip, key_bytes, base_version, rpt=0, wpt=0):
    return native.mod.encode_conflict_ranges(
        txns, skip, host["rb"], host["re"], host["wb"], host["we"],
        host["rtxn"], host["wtxn"], key_bytes, host["snapshot"],
        host["txn_valid"], base_version, rpt, wpt)


def _rand_key(rng, kb):
    n = rng.choice([0, 1, 3, kb - 1, kb, kb + 1, kb + 9, 40])
    return bytes(rng.randrange(256) for _ in range(max(n, 0)))


BASE = 1 << 32
SNAPS = (BASE, BASE + 17, BASE - 1, BASE + (1 << 31) + 5, BASE + (1 << 40),
         BASE + encode_np.NEG - 3, 0, BASE + encode_np.NEG)


def fuzz_encoder_parity(seed: int, rounds: int = 24):
    """Seeded chunks, pooled and strided, with skip masks, empty and long
    keys and snapshots past both clamps: the C pass writes every field
    byte for byte as the numpy encode does, over buffers that start with
    different bytes."""
    rng = random.Random(seed)
    for i in range(rounds):
        strided = i % 2 == 1
        kb = rng.choice([4, 8, 16, 24])
        L = kb // 4 + 1
        T = rng.choice([4, 16, 32])
        rpt, wpt = rng.randrange(1, 5), rng.randrange(1, 5)
        NR, NW = T * rpt, T * wpt
        n = rng.randrange(0, T + 1)
        txns = []
        for _ in range(n):
            reads = [(_rand_key(rng, kb), _rand_key(rng, kb))
                     for _ in range(rng.randrange(0, rpt + 1))]
            writes = [(_rand_key(rng, kb), _rand_key(rng, kb))
                      for _ in range(rng.randrange(0, wpt + 1))]
            txns.append(TxnConflictInfo(rng.choice(SNAPS), reads, writes))
        skip = [rng.random() < 0.3 for _ in txns] if rng.random() < 0.7 \
            else None
        c_host = chunk_views(L, T, NR, NW, 0x5A)
        n_host = chunk_views(L, T, NR, NW, 0xA5)
        nr, nw = encode_c(c_host, txns, skip, kb, BASE,
                          rpt if strided else 0, wpt if strided else 0)
        encode_np.encode_numpy(n_host, txns, skip, txns_per_chunk=T,
                               reads=NR, writes=NW, key_bytes=kb,
                               strided=strided, base_version=BASE)
        kept = [t for t, s in zip(txns, skip or [False] * len(txns))
                if not s]
        assert (nr, nw) == (sum(len(t.read_ranges) for t in kept),
                            sum(len(t.write_ranges) for t in kept))
        for name in n_host:
            assert c_host[name].tobytes() == n_host[name].tobytes(), \
                f"{name} differs (seed {seed}, round {i}, strided {strided})"


def encoder_refusals():
    """What the C pass refuses, each with its own error and no write past
    the buffers: a skip mask shorter than the txns, more txns or ranges
    than the chunk holds, a key that is not bytes, ranges that are not a
    sequence, a buffer that is not writable and contiguous, and a call
    with the wrong arity."""
    T, NR, NW, kb = 4, 8, 8, 24
    txns = [TxnConflictInfo(1, [(b"a", b"b")], [(b"c", b"d")])] * 3

    def call(txs, skip=None, **over):
        host = {**chunk_views(kb // 4 + 1, T, NR, NW, 0), **over}
        return encode_c(host, txs, skip, kb, 0)

    assert call(txns) == (3, 3)
    cases = [
        (ValueError, lambda: call(txns, skip=[False])),
        (ValueError, lambda: call([TxnConflictInfo(1, [(b"a", b"b")] * 9,
                                                   [])])),
        (ValueError, lambda: call([TxnConflictInfo(1, [], [])] * 5)),
        (ValueError, lambda: call(txns, snapshot=np.zeros(2, np.int32))),
        (TypeError, lambda: call([TxnConflictInfo(1, [(1, b"b")], [])])),
        (TypeError, lambda: call([TxnConflictInfo(1, None, [])])),
        (TypeError, lambda: call(txns, rb=np.zeros((NR, 7), np.int32).T)),
        (TypeError, lambda: native.mod.encode_conflict_ranges(txns)),
    ]
    for want, fn in cases:
        with pytest.raises(want):
            fn()


@needs_native
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_encoder_parity_fuzz(seed):
    fuzz_encoder_parity(seed)


@needs_native
def test_encoder_refusals():
    encoder_refusals()
