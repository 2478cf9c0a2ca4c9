"""Redwood: a log-structured versioned storage engine for real datasets.

Reference: fdbserver/VersionedBTree.actor.cpp (the `ssd-redwood-v1` engine) —
FDB's answer to multi-GB datasets the memory engine can't hold resident and
the sqlite shim serves too slowly. The shape reproduced here is Redwood's
write path rather than its B-tree page tree: an append-only WAL (the same
DiskQueue framing + CRC-32C the memory engine and TLog use) feeds an
in-memory memtable that flushes to immutable, prefix-compressed sorted
blocks with a block index, organized into levels and merged by background
compaction. Reads consult newest-to-oldest sources with range-tombstone
shadowing; recovery loads the surviving runs and replays the WAL tail.

On-disk layout — two regions, both CRC-32C checked:

  WAL          two alternating DiskQueue files (framing from diskqueue.py);
               one entry per commit() batch, ops tagged like the memory
               engine's WAL (_OP_SET / _OP_CLEAR / _OP_META).
  run files    one immutable file per flushed/compacted run, written once
               and synced. RedwoodRunHeader, then source run ids, a block
               index (last key + offset/length per block), an aux region
               (range tombstones + the metadata dict, wire-encoded), then
               the prefix-compressed blocks. Block and run header structs
               are pinned as PROTO005-style C-schema comments in
               native/fdb_native.c; the C and Python block codecs are
               bit-identical (tests/test_redwood.py parity fuzz).

Crash safety is ordering, not atomicity:

  flush     freeze memtable -> build run image (pure) -> append+sync the
            run file -> pop the WAL up to the freeze point. A crash between
            sync and pop replays WAL ops already in the run — idempotent
            (sets/clears/meta; atomics are resolved upstream by the storage
            server before they reach the engine).
  compact   build merged run -> append+sync -> truncate the source files.
            A crash in between leaves both; recovery drops any run listed
            as a source of a surviving valid run (and truncates it, healing
            the half-finished compaction).
  torn run  a partially-durable run file fails its body CRC and is ignored;
            its data is still covered by the WAL or by its source runs.

Maintenance is split so the storage server can drive it from its actor loop
without blocking (devlint DEV001 discipline, the resolver's
drain-off-the-loop idiom): `plan_maintenance()` freezes inputs on-loop and
returns a plan whose `.build()` is pure CPU+read-only-file work safe for
`loop.run_blocking`; `apply_maintenance(plan, image)` installs the result
on-loop. Decisions depend only on byte/run counts, so the same mutation
stream produces the same flush/compaction sequence — sim-deterministic.

This is the PyTorch port's copy of the JAX package's module. Like it, it
asks the C extension (the port's own, native/fdb_native.c) for the block
codec, the bloom filters and run handles wherever the extension is built,
and takes its Python branch elsewhere; the CRC is the transport's
(net/native_transport.py `crc32c`, C where built). The codecs are
bit-identical, so the on-disk format is the same: a store either package
wrote opens in the other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable

from foundationdb_tpu_torch.net import native_transport
from foundationdb_tpu_torch.storage.diskqueue import DiskQueue
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS

# WAL op tags — shared with the memory engine (storage/kvstore.py) so the
# two WALs stay mutually readable by eye and by tests
_OP_SET = 0
_OP_CLEAR = 1
_OP_META = 2

# ---------------------------------------------------------------------------
# block codec — bit-parity with native/fdb_native.c redwood_encode_block /
# redwood_decode_block (PROTO005 C-schema comments pin the structs there)
# ---------------------------------------------------------------------------

BLOCK_MAGIC = 0x5EDB10C5
RUN_MAGIC = 0x5EDB4513
RUN_FORMAT_VERSION = 2  # v2: per-run bloom section between aux and blocks
BLOOM_MAGIC = 0x5EDBB1F1

# RedwoodBlockHeader { magic: u32, n_entries: u32, payload_bytes: u32, crc: u32 }
_BLOCK_HEADER = struct.Struct("<IIII")
# RedwoodBlockEntry { shared: u16, suffix_len: u16, value_len: u32 }
_BLOCK_ENTRY = struct.Struct("<HHI")
# RedwoodRunHeader { magic: u32, format_version: u32, run_id: u64,
#                    meta_seq: u64, level: u32, n_blocks: u32, n_sources: u32,
#                    index_bytes: u32, aux_bytes: u32, bloom_bytes: u32,
#                    body_crc: u32 }
_RUN_HEADER = struct.Struct("<IIQQIIIIIII")
# RedwoodRunIndexEntry { offset: u32, length: u32, last_key_len: u16 }
_RUN_INDEX = struct.Struct("<IIH")
# RedwoodBloomHeader { magic: u32, n_hashes: u32, n_bits: u64, n_keys: u64 }
_BLOOM_HEADER = struct.Struct("<IIQQ")

# field lists the C-schema parity test (tests/test_redwood.py) cross-checks
# against the comments in fdb_native.c — this side is the binding authority
BLOCK_HEADER_FIELDS = ["magic", "n_entries", "payload_bytes", "crc"]
BLOCK_ENTRY_FIELDS = ["shared", "suffix_len", "value_len"]
RUN_HEADER_FIELDS = ["magic", "format_version", "run_id", "meta_seq",
                     "level", "n_blocks", "n_sources", "index_bytes",
                     "aux_bytes", "bloom_bytes", "body_crc"]
RUN_INDEX_FIELDS = ["offset", "length", "last_key_len"]
BLOOM_HEADER_FIELDS = ["magic", "n_hashes", "n_bits", "n_keys"]

def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the transport's: the C extension's where it is
    built, else the table-driven fallback. Both compute the SAME polynomial,
    so a store written by a native-enabled host verifies on a pure-Python
    host and vice versa (net/http.py makes the identical argument for its
    trailer checksums)."""
    return native_transport.crc32c(data)


def _shared_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b), 0xFFFF)
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def py_encode_block(items: list[tuple[bytes, bytes]]) -> bytes:
    """Pure-Python block encoder; MUST stay byte-identical to the C
    redwood_encode_block (the parity fuzz in tests/test_redwood.py is the
    gate). Keys must be pre-sorted; prefix compression is against the
    previous key in the block."""
    parts = []
    prev = b""
    for k, v in items:
        if len(k) > 0xFFFF:
            raise FDBError("invalid_option", "redwood key exceeds 64KiB")
        shared = _shared_prefix_len(prev, k)
        suffix = k[shared:]
        parts.append(_BLOCK_ENTRY.pack(shared, len(suffix), len(v)))
        parts.append(suffix)
        parts.append(v)
        prev = k
    payload = b"".join(parts)
    return _BLOCK_HEADER.pack(BLOCK_MAGIC, len(items), len(payload),
                              crc32c(payload)) + payload


def py_decode_block(data: bytes) -> list[tuple[bytes, bytes]]:
    if len(data) < _BLOCK_HEADER.size:
        raise FDBError("file_corrupt", "redwood block shorter than header")
    magic, n, plen, crc = _BLOCK_HEADER.unpack_from(data, 0)
    payload = data[_BLOCK_HEADER.size:]
    if magic != BLOCK_MAGIC or len(payload) != plen:
        raise FDBError("file_corrupt", "redwood block header mismatch")
    if crc32c(payload) != crc:
        raise FDBError("file_corrupt", "redwood block checksum mismatch")
    out: list[tuple[bytes, bytes]] = []
    prev = b""
    off = 0
    for _ in range(n):
        shared, slen, vlen = _BLOCK_ENTRY.unpack_from(payload, off)
        off += _BLOCK_ENTRY.size
        key = prev[:shared] + payload[off:off + slen]
        off += slen
        out.append((key, payload[off:off + vlen]))
        off += vlen
        prev = key
    if off != plen:
        raise FDBError("file_corrupt", "redwood block trailing bytes")
    return out


def encode_block(items: list[tuple[bytes, bytes]]) -> bytes:
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "redwood_encode_block"):
        return native.mod.redwood_encode_block(items)
    return py_encode_block(items)


def decode_block(data: bytes) -> list[tuple[bytes, bytes]]:
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "redwood_decode_block"):
        return native.mod.redwood_decode_block(data)
    return py_decode_block(data)


# ---------------------------------------------------------------------------
# per-run bloom filters — bit-parity with native/fdb_native.c
# redwood_bloom_build / redwood_bloom_query
# ---------------------------------------------------------------------------

# Double hashing over CRC-32C: bit_i = (h1 + i*h2) % n_bits with
# h1 = crc32c(key) and h2 = crc32c(key + salt). The C side streams the salt
# byte into h1's CRC state, which equals hashing the concatenation.
_BLOOM_SALT = b"\xb1"


def _bloom_hashes(key: bytes) -> tuple[int, int]:
    return crc32c(key), crc32c(key + _BLOOM_SALT)


def py_bloom_build(keys: list[bytes], bits_per_key: int,
                   n_hashes: int) -> bytes:
    """Pure-Python bloom builder; MUST stay byte-identical to the C
    redwood_bloom_build (tests/test_redwood_native.py parity fuzz is the
    gate). An empty key list still yields a 64-bit all-zero filter so every
    query answers False — a bloom can shadow nothing it doesn't hold."""
    if bits_per_key < 1 or not 1 <= n_hashes <= 64:
        raise ValueError("bad bloom parameters")
    n_bits = max(64, len(keys) * bits_per_key)
    bits = bytearray((n_bits + 7) // 8)
    for k in keys:
        h1, h2 = _bloom_hashes(k)
        for i in range(n_hashes):
            bit = (h1 + i * h2) % n_bits
            bits[bit >> 3] |= 1 << (bit & 7)
    return _BLOOM_HEADER.pack(BLOOM_MAGIC, n_hashes, n_bits,
                              len(keys)) + bytes(bits)


def py_bloom_query(section: bytes, key: bytes) -> bool:
    if len(section) < _BLOOM_HEADER.size:
        raise ValueError("corrupt redwood bloom section")
    magic, n_hashes, n_bits, _n_keys = _BLOOM_HEADER.unpack_from(section, 0)
    if (magic != BLOOM_MAGIC or n_bits == 0 or not 1 <= n_hashes <= 64
            or len(section) - _BLOOM_HEADER.size != (n_bits + 7) // 8):
        raise ValueError("corrupt redwood bloom section")
    bits = memoryview(section)[_BLOOM_HEADER.size:]
    h1, h2 = _bloom_hashes(key)
    for i in range(n_hashes):
        bit = (h1 + i * h2) % n_bits
        if not (bits[bit >> 3] >> (bit & 7)) & 1:
            return False
    return True


def bloom_build(keys: list[bytes], bits_per_key: int, n_hashes: int) -> bytes:
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "redwood_bloom_build"):
        return native.mod.redwood_bloom_build(keys, bits_per_key, n_hashes)
    return py_bloom_build(keys, bits_per_key, n_hashes)


def bloom_query(section: bytes, key: bytes) -> bool:
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "redwood_bloom_query"):
        return native.mod.redwood_bloom_query(section, key)
    return py_bloom_query(section, key)


# ---------------------------------------------------------------------------
# run container (Python-assembled; blocks inside come from the codec above)
# ---------------------------------------------------------------------------

def build_run_image(entries: list[tuple[bytes, bytes]],
                    clears: list[tuple[bytes, bytes]],
                    meta: dict[str, bytes],
                    run_id: int, meta_seq: int, level: int,
                    sources: tuple[int, ...], block_bytes: int,
                    bloom_bits_per_key: int | None = None,
                    bloom_hashes: int | None = None) -> bytes:
    """Assemble one immutable run file image (pure — safe off-loop).
    Bloom parameters default to the REDWOOD_BLOOM_* knobs; bits_per_key 0
    writes no bloom section at all (bloom_bytes == 0)."""
    blocks: list[bytes] = []
    index_parts: list[bytes] = []
    cur: list[tuple[bytes, bytes]] = []
    cur_bytes = 0
    off = 0

    def close_block():
        nonlocal off, cur, cur_bytes
        blk = encode_block(cur)
        last_key = cur[-1][0]
        index_parts.append(_RUN_INDEX.pack(off, len(blk), len(last_key)))
        index_parts.append(last_key)
        blocks.append(blk)
        off += len(blk)
        cur = []
        cur_bytes = 0

    for k, v in entries:
        cur.append((k, v))
        cur_bytes += len(k) + len(v) + _BLOCK_ENTRY.size
        if cur_bytes >= block_bytes:
            close_block()
    if cur:
        close_block()
    # deterministic aux bytes: meta sorted by key, clears in accumulation
    # order (itself deterministic under the sim's scheduling)
    aux = wire.dumps((list(clears),
                      sorted(meta.items())))
    src = struct.pack(f"<{len(sources)}Q", *sources) if sources else b""
    index = b"".join(index_parts)
    bpk = (KNOBS.REDWOOD_BLOOM_BITS_PER_KEY if bloom_bits_per_key is None
           else bloom_bits_per_key)
    nh = KNOBS.REDWOOD_BLOOM_HASHES if bloom_hashes is None else bloom_hashes
    bloom = bloom_build([k for k, _ in entries], bpk, nh) if bpk > 0 else b""
    body = src + index + aux + bloom + b"".join(blocks)
    header = _RUN_HEADER.pack(RUN_MAGIC, RUN_FORMAT_VERSION, run_id, meta_seq,
                              level, len(blocks), len(sources), len(index),
                              len(aux), len(bloom), crc32c(body))
    return header + body


@dataclass
class _Run:
    """One immutable on-disk run: header fields + decoded index, with block
    payloads fetched lazily through the store's block cache."""

    run_id: int
    meta_seq: int
    level: int
    sources: tuple[int, ...]
    index: list[tuple[int, int, bytes]]  # (offset, length, last_key)
    clears: list[tuple[bytes, bytes]]
    meta: dict[str, bytes]
    blocks_off: int  # absolute file offset of the blocks region
    file: object
    name: str
    raw: bytes | None = None  # full image kept only when file lacks pread
    bloom: bytes = b""        # bloom section (b"" when the run has none)
    native: object | None = None  # C RedwoodRun handle (None = Python path)

    def read_block_bytes(self, i: int) -> bytes:
        off, length, _lk = self.index[i]
        if self.raw is not None:
            return self.raw[self.blocks_off + off:
                            self.blocks_off + off + length]
        return self.file.read_range(self.blocks_off + off, length)

    def first_block_for(self, key: bytes) -> int:
        """Index of the first block whose last_key >= key (== len(index)
        when every block ends before key)."""
        lo, hi = 0, len(self.index)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.index[mid][2] < key:
                lo = mid + 1
            else:
                hi = mid
        return lo


def _native_run_handle(raw: bytes, clears: list[tuple[bytes, bytes]]):
    """C RedwoodRun handle for a validated image, or None (knob off, native
    unavailable, or the C open rejects it — degrade to the Python path, but
    never drop a run parse_run already accepted)."""
    if not KNOBS.REDWOOD_NATIVE_READS:
        return None
    from foundationdb_tpu_torch import native
    if not (native.available() and hasattr(native.mod, "redwood_run_open")):
        return None
    try:
        return native.mod.redwood_run_open(
            bytes(raw), clears, KNOBS.REDWOOD_BLOCK_CACHE_BLOCKS)
    except (ValueError, TypeError, MemoryError):
        return None


def parse_run(raw: bytes, file, name: str) -> _Run | None:
    """Validate + decode a run file; None for anything torn or foreign
    (a crashed apply leaves a partial file — recovery must shrug it off).
    `file=None` marks a short-lived reader (compaction input): no native
    handle is opened for those."""
    try:
        if len(raw) < _RUN_HEADER.size:
            return None
        (magic, ver, run_id, meta_seq, level, n_blocks, n_sources,
         index_bytes, aux_bytes, bloom_bytes,
         body_crc) = _RUN_HEADER.unpack_from(raw, 0)
        if magic != RUN_MAGIC or ver != RUN_FORMAT_VERSION:
            return None
        body = raw[_RUN_HEADER.size:]
        if crc32c(body) != body_crc:
            return None
        off = 0
        sources = (struct.unpack_from(f"<{n_sources}Q", body, off)
                   if n_sources else ())
        off += 8 * n_sources
        index: list[tuple[int, int, bytes]] = []
        index_end = off + index_bytes
        while off < index_end:
            boff, blen, klen = _RUN_INDEX.unpack_from(body, off)
            off += _RUN_INDEX.size
            index.append((boff, blen, bytes(body[off:off + klen])))
            off += klen
        if len(index) != n_blocks or off != index_end:
            return None
        aux = wire.loads(bytes(body[off:off + aux_bytes]))
        clears = [(b, e) for b, e in aux[0]]
        meta = {k: v for k, v in aux[1]}
        bloom = bytes(body[off + aux_bytes:off + aux_bytes + bloom_bytes])
        if len(bloom) != bloom_bytes:
            return None
        blocks_off = _RUN_HEADER.size + off + aux_bytes + bloom_bytes
        keep_raw = raw if not hasattr(file, "read_range") else None
        native_handle = (_native_run_handle(raw, clears)
                         if file is not None else None)
        return _Run(run_id=run_id, meta_seq=meta_seq, level=level,
                    sources=tuple(sources), index=index, clears=clears,
                    meta=meta, blocks_off=blocks_off, file=file, name=name,
                    raw=keep_raw, bloom=bloom, native=native_handle)
    except (struct.error, wire.WireError, ValueError, TypeError):
        return None


# ---------------------------------------------------------------------------
# maintenance plans
# ---------------------------------------------------------------------------

@dataclass
class MaintenancePlan:
    """One unit of background work. `build` is pure (CPU + reads of
    immutable files) so the storage server can run it through
    loop.run_blocking; `apply_maintenance` installs the result on-loop."""

    kind: str                      # "flush" | "compact"
    run_id: int
    level: int                     # level the new run lands at
    build: Callable[[], bytes] = field(repr=False, default=None)
    wal_upto: int = 0              # flush: WAL pop point after install
    source_ids: tuple[int, ...] = ()  # compact: runs consumed
    drop_tombstones: bool = False  # compact: output is the oldest data


@dataclass
class _Frozen:
    """Immutable memtable awaiting flush (reads still see it)."""

    entries: dict[bytes, bytes]
    index: object
    clears: list[tuple[bytes, bytes]]
    meta: dict[str, bytes]
    wal_upto: int


def _covered(key: bytes, clears: list[tuple[bytes, bytes]]) -> bool:
    return any(b <= key < e for b, e in clears)


class RedwoodKeyValueStore:
    """IKeyValueStore over WAL + memtable + leveled immutable runs.

    Files come through two callables so the engine is transport-agnostic:
    the sim hands it SimFiles (kill-injected torn tails), the real transport
    _LocalFiles (fsync + pread). `open_file(name)` creates-or-opens a run
    file; `existing_files()` lists run-file names found on disk at recovery.
    Run files are named "rw.<run_id>" under whatever prefix the caller's
    open_file applies.
    """

    def __init__(self, file0, file1, open_file: Callable[[str], object],
                 existing_files: Callable[[], list[str]] | None = None):
        from foundationdb_tpu_torch.utils.indexedset import make_indexed_set
        self.queue = DiskQueue(file0, file1)
        self._open_file = open_file
        self._existing_files = existing_files or (lambda: [])
        self._make_index = make_indexed_set
        self._mem: dict[bytes, bytes] = {}
        self._mem_index = make_indexed_set()
        self._mem_clears: list[tuple[bytes, bytes]] = []
        self._mem_bytes = 0
        self._imm: _Frozen | None = None
        self._meta: dict[str, bytes] = {}
        self._pending: list[tuple] = []
        self._levels: dict[int, list[_Run]] = {}  # newest-first per level
        self._next_run_id = 1
        self._wal_bytes = 0  # pushed since the last flush (meta churn bound)
        self._plan_active = False
        self._block_cache: dict[tuple[int, int], list] = {}
        # read-path observability; native per-handle counters are merged in
        # by read_stats() and folded here when a handle is retired
        self._read_stats: dict[str, int] = {
            "block_cache_hits": 0, "block_cache_misses": 0,
            "bloom_negatives": 0, "blocks_decoded": 0,
            "native_gets": 0, "fallback_gets": 0, "batch_gets": 0,
        }

    # -- mutation (same surface + WAL batching as the memory engine) --

    def set(self, key: bytes, value: bytes) -> None:
        self._apply_set(key, value)
        self._pending.append((_OP_SET, key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._apply_clear(begin, end)
        self._pending.append((_OP_CLEAR, begin, end))

    def set_metadata(self, key: str, value: bytes) -> None:
        self._meta[key] = value
        self._pending.append((_OP_META, key, value))

    def get_metadata(self, key: str) -> bytes | None:
        return self._meta.get(key)

    def _apply_set(self, key: bytes, value: bytes):
        old = self._mem.get(key)
        if old is not None:
            self._mem_bytes -= len(key) + len(old)
        self._mem_index.insert(key, len(key) + len(value))
        self._mem[key] = value
        self._mem_bytes += len(key) + len(value)

    def _apply_clear(self, begin: bytes, end: bytes):
        # eager delete inside the memtable, plus a range tombstone that
        # shadows the frozen memtable and every older run
        for k in self._mem_index.range_keys(begin, end):
            self._mem_bytes -= len(k) + len(self._mem[k])
            del self._mem[k]
            self._mem_index.discard(k)
        self._mem_clears.append((begin, end))
        self._mem_bytes += len(begin) + len(end)

    # -- reads: newest source wins; tombstones shadow older sources --

    def _runs_newest_first(self):
        for level in sorted(self._levels):
            for run in self._levels[level]:
                yield run

    def _mem_lookup(self, key: bytes) -> tuple[bool, bytes | None]:
        """Resolve against the memtable + frozen memtable only:
        (resolved, value). Unresolved keys fall through to the runs."""
        if key in self._mem:
            return True, self._mem[key]
        if _covered(key, self._mem_clears):
            return True, None
        imm = self._imm
        if imm is not None:
            if key in imm.entries:
                return True, imm.entries[key]
            if _covered(key, imm.clears):
                return True, None
        return False, None

    def get(self, key: bytes) -> bytes | None:
        resolved, val = self._mem_lookup(key)
        if resolved:
            return val
        for run in self._runs_newest_first():
            found, val, shadowed = self._run_lookup(run, key)
            if found:
                return val
            if shadowed:
                return None
        return None

    def _block(self, run: _Run, i: int) -> list[tuple[bytes, bytes]]:
        ck = (run.run_id, i)
        blk = self._block_cache.get(ck)
        if blk is None:
            self._read_stats["block_cache_misses"] += 1
            self._read_stats["blocks_decoded"] += 1
            blk = decode_block(run.read_block_bytes(i))
            cap = KNOBS.REDWOOD_BLOCK_CACHE_BLOCKS
            if len(self._block_cache) >= cap:
                # drop the oldest insertion (dict preserves order) — a cheap
                # FIFO approximation of LRU, deterministic under sim
                self._block_cache.pop(next(iter(self._block_cache)))
            self._block_cache[ck] = blk
        else:
            self._read_stats["block_cache_hits"] += 1
        return blk

    def _run_lookup(self, run: _Run,
                    key: bytes) -> tuple[bool, bytes | None, bool]:
        """(found, value, shadowed-by-this-run's-clears): one run consulted
        through the native handle when it has one, else the Python path.
        Decision parity between the two is fuzz-gated
        (tests/test_redwood_native.py)."""
        h = run.native
        if h is not None:
            self._read_stats["native_gets"] += 1
            status, val = h.get(key)
            return status == 1, val, status == 2
        self._read_stats["fallback_gets"] += 1
        found, val = self._run_get(run, key)
        if found:
            return True, val, False
        return False, None, _covered(key, run.clears)

    def _run_get(self, run: _Run, key: bytes) -> tuple[bool, bytes | None]:
        """Pure-Python in-run point lookup (the native fallback path)."""
        if run.bloom and not bloom_query(run.bloom, key):
            self._read_stats["bloom_negatives"] += 1
            return False, None
        i = run.first_block_for(key)
        if i >= len(run.index):
            return False, None
        blk = self._block(run, i)
        lo, hi = 0, len(blk)
        while lo < hi:
            mid = (lo + hi) // 2
            if blk[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(blk) and blk[lo][0] == key:
            return True, blk[lo][1]
        return False, None

    # -- batched reads (native fast path) --

    def _native_handles(self) -> list | None:
        """Newest-first C run handles, or None unless EVERY run has one —
        a mixed cascade would evaluate shadowing out of order."""
        if not KNOBS.REDWOOD_NATIVE_READS:
            return None
        hs = []
        for run in self._runs_newest_first():
            if run.native is None:
                return None
            hs.append(run.native)
        return hs

    def get_batch(self, keys: list[bytes]) -> list[bytes | None]:
        """Point-read a batch: memtable/imm resolved in Python, then ONE
        C call cascades every remaining key through all run handles.
        Falls back to per-key get() when any run lacks a handle."""
        hs = self._native_handles()
        if hs is None:
            return [self.get(k) for k in keys]
        self._read_stats["batch_gets"] += 1
        out: list[bytes | None] = [None] * len(keys)
        pending_idx: list[int] = []
        pending_keys: list[bytes] = []
        for i, k in enumerate(keys):
            resolved, val = self._mem_lookup(k)
            if resolved:
                out[i] = val
            else:
                pending_idx.append(i)
                pending_keys.append(k)
        if pending_keys and hs:
            from foundationdb_tpu_torch import native
            vals = native.mod.redwood_runs_get_batch(hs, pending_keys)
            for i, v in zip(pending_idx, vals):
                out[i] = v
            self._read_stats["native_gets"] += len(pending_keys)
        return out

    def get_batch_encoded(self, reads: list[tuple[bytes, int]], oldest: int,
                          tid: int) -> bytes | None:
        """Complete GetValuesReply wire frame for (key, version) pairs,
        serialized in one C call — values copied straight out of the mapped
        run images, never materialized as Python objects. Returns None when
        the native fast path is unavailable (caller encodes in Python)."""
        hs = self._native_handles()
        if hs is None:
            return None
        from foundationdb_tpu_torch import native
        if not hasattr(native.mod, "redwood_runs_get_many_encode"):
            return None
        # memtable/imm resolution stays in Python; False = "cascade the
        # runs in C" (too-old reads are decided by version in C first)
        prefilled: list = []
        for k, _v in reads:
            resolved, val = self._mem_lookup(k)
            prefilled.append(val if resolved else False)
        self._read_stats["batch_gets"] += 1
        self._read_stats["native_gets"] += len(reads)
        return native.mod.redwood_runs_get_many_encode(
            hs, reads, oldest, tid, prefilled)

    def read_stats(self) -> dict[str, int]:
        """Cumulative read-path counters: store-level tallies merged with
        every live native handle's per-handle counters (retired handles are
        folded into the store tallies at close)."""
        out = dict(self._read_stats)
        for run in self._runs_newest_first():
            if run.native is not None:
                s = run.native.stats()
                out["block_cache_hits"] += s["block_cache_hits"]
                out["block_cache_misses"] += s["block_cache_misses"]
                out["bloom_negatives"] += s["bloom_negatives"]
                out["blocks_decoded"] += s["blocks_decoded"]
        return out

    def _retire_run(self, run: _Run) -> None:
        """Fold a native handle's counters into the store tallies and
        release its image before the run is dropped."""
        h = run.native
        if h is None:
            return
        s = h.stats()
        self._read_stats["block_cache_hits"] += s["block_cache_hits"]
        self._read_stats["block_cache_misses"] += s["block_cache_misses"]
        self._read_stats["bloom_negatives"] += s["bloom_negatives"]
        self._read_stats["blocks_decoded"] += s["blocks_decoded"]
        h.close()
        run.native = None

    def _run_range(self, run: _Run, begin: bytes, end: bytes):
        i = run.first_block_for(begin)
        while i < len(run.index):
            for k, v in self._block(run, i):
                if k < begin:
                    continue
                if k >= end:
                    return
                yield k, v
            i += 1

    def get_range(self, begin: bytes, end: bytes, limit: int = -1,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]:
        if limit == 0:
            return []  # limit semantics: 0 rows; unlimited is limit < 0
        result: dict[bytes, bytes] = {}
        dead: set[bytes] = set()
        shadow: list[tuple[bytes, bytes]] = []

        def fold(pairs, clears):
            for k, v in pairs:
                if k in result or k in dead:
                    continue
                if _covered(k, shadow):
                    dead.add(k)
                    continue
                result[k] = v
            shadow.extend(clears)

        fold(((k, self._mem[k])
              for k in self._mem_index.range_keys(begin, end)),
             self._mem_clears)
        imm = self._imm
        if imm is not None:
            fold(((k, imm.entries[k])
                  for k in imm.index.range_keys(begin, end)), imm.clears)
        for run in self._runs_newest_first():
            fold(self._run_range(run, begin, end), run.clears)
        items = sorted(result.items(), reverse=reverse)
        if limit > 0:
            items = items[:limit]
        return items

    # -- durability --

    def commit(self) -> None:
        if self._pending:
            payload = wire.dumps(self._pending)
            self.queue.push(payload)
            self._wal_bytes += len(payload)
            self._pending = []
        self.queue.commit()

    # -- maintenance: plan on-loop, build off-loop, apply on-loop --

    def maintenance_due(self) -> bool:
        if self._plan_active:
            return False
        budget = KNOBS.REDWOOD_MEMTABLE_BYTES
        if self._imm is not None:
            return True
        if self._mem_bytes >= budget:
            return True
        # metadata-only churn (durable-version bumps) never fills the
        # memtable but grows the WAL forever; flush to reclaim it
        if self._wal_bytes >= 8 * budget and self.queue.live_entries:
            return True
        fan_in = KNOBS.REDWOOD_COMPACTION_FAN_IN
        return any(len(runs) >= fan_in for runs in self._levels.values())

    def plan_maintenance(self) -> MaintenancePlan | None:
        """Freeze inputs and return the next unit of work (None when
        nothing is due). One plan may be outstanding at a time."""
        if self._plan_active or not self.maintenance_due():
            return None
        if self._imm is None and (
                self._mem_bytes >= KNOBS.REDWOOD_MEMTABLE_BYTES
                or self._wal_bytes >= 8 * KNOBS.REDWOOD_MEMTABLE_BYTES):
            self._freeze()
        if self._imm is not None:
            return self._plan_flush()
        fan_in = KNOBS.REDWOOD_COMPACTION_FAN_IN
        for level in sorted(self._levels):
            if len(self._levels[level]) >= fan_in:
                return self._plan_compact(level)
        return None

    def _freeze(self):
        self._imm = _Frozen(entries=self._mem, index=self._mem_index,
                            clears=self._mem_clears, meta=dict(self._meta),
                            wal_upto=self.queue.next_seq)
        self._mem = {}
        self._mem_index = self._make_index()
        self._mem_clears = []
        self._mem_bytes = 0
        self._wal_bytes = 0

    def _plan_flush(self) -> MaintenancePlan:
        imm = self._imm
        run_id = self._next_run_id
        self._next_run_id += 1
        self._plan_active = True
        entries = sorted(imm.entries.items())
        block_bytes = KNOBS.REDWOOD_BLOCK_BYTES

        def build(entries=entries, clears=list(imm.clears),
                  meta=imm.meta, run_id=run_id, block_bytes=block_bytes):
            return build_run_image(entries, clears, meta, run_id=run_id,
                                   meta_seq=run_id, level=0, sources=(),
                                   block_bytes=block_bytes)

        return MaintenancePlan(kind="flush", run_id=run_id, level=0,
                               build=build, wal_upto=imm.wal_upto)

    def _plan_compact(self, level: int) -> MaintenancePlan:
        runs = list(self._levels[level])  # newest-first
        run_id = self._next_run_id
        self._next_run_id += 1
        self._plan_active = True
        # tombstones can be dropped only when nothing older remains below
        drop = not any(self._levels.get(deeper)
                       for deeper in self._levels if deeper > level)
        readers = [(r.meta_seq, r.clears, r.meta,
                    lambda r=r: r.raw if r.raw is not None else
                    r.file.read_all())
                   for r in runs]
        block_bytes = KNOBS.REDWOOD_BLOCK_BYTES
        source_ids = tuple(r.run_id for r in runs)

        def build(readers=readers, run_id=run_id, level=level, drop=drop,
                  source_ids=source_ids, block_bytes=block_bytes):
            merged: dict[bytes, bytes] = {}
            decided: set[bytes] = set()
            shadow: list[tuple[bytes, bytes]] = []
            all_clears: list[tuple[bytes, bytes]] = []
            for _ms, clears, _meta, read in readers:  # newest -> oldest
                run = parse_run(read(), file=None, name="")
                if run is None:
                    raise FDBError("file_corrupt",
                                   "redwood compaction source unreadable")
                for i in range(len(run.index)):
                    for k, v in decode_block(run.read_block_bytes(i)):
                        if k in decided:
                            continue
                        decided.add(k)
                        if _covered(k, shadow):
                            continue
                        merged[k] = v
                shadow.extend(clears)
                all_clears.extend(clears)
            meta_seq = max(ms for ms, _c, _m, _r in readers)
            meta = max(readers, key=lambda t: t[0])[2]
            out_clears = [] if drop else all_clears
            return build_run_image(sorted(merged.items()), out_clears, meta,
                                   run_id=run_id, meta_seq=meta_seq,
                                   level=level + 1, sources=source_ids,
                                   block_bytes=block_bytes)

        return MaintenancePlan(kind="compact", run_id=run_id,
                               level=level + 1, build=build,
                               source_ids=source_ids, drop_tombstones=drop)

    def apply_maintenance(self, plan: MaintenancePlan, image: bytes) -> None:
        """Install a built run: append+sync the file, THEN reclaim (WAL pop
        / source truncation) — the ordering the crash-safety argument in the
        module docstring depends on."""
        name = f"rw.{plan.run_id}"
        f = self._open_file(name)
        f.truncate()  # a crashed earlier attempt may have left a partial
        f.append(image)
        f.sync()
        run = parse_run(f.read_all() if not hasattr(f, "read_range")
                        else image, f, name)
        if run is None:  # pragma: no cover — image was built by us
            self._plan_active = False
            raise FDBError("io_error", "freshly written redwood run invalid")
        if hasattr(f, "read_range"):
            run.raw = None
        self._levels.setdefault(run.level, []).insert(0, run)
        if plan.kind == "flush":
            self._imm = None
            self.queue.pop(plan.wal_upto)
        else:
            drop = set(plan.source_ids)
            for level in list(self._levels):
                kept = [r for r in self._levels[level]
                        if r.run_id not in drop or r is run]
                for r in self._levels[level]:
                    if r.run_id in drop and r is not run:
                        self._retire_run(r)
                        r.file.truncate()
                self._levels[level] = kept
                if not kept:
                    del self._levels[level]
            for ck in [ck for ck in self._block_cache if ck[0] in drop]:
                del self._block_cache[ck]
        self._plan_active = False

    def maintain(self) -> int:
        """Synchronously drain all due maintenance (tests, benches, and
        engines used outside an actor loop). Returns plans applied."""
        n = 0
        while True:
            plan = self.plan_maintenance()
            if plan is None:
                return n
            self.apply_maintenance(plan, plan.build())
            n += 1

    # -- recovery --

    def recover(self) -> None:
        self._mem = {}
        self._mem_index = self._make_index()
        self._mem_clears = []
        self._mem_bytes = 0
        self._imm = None
        self._meta = {}
        self._pending = []
        self._levels = {}
        self._wal_bytes = 0
        self._plan_active = False
        self._block_cache = {}
        runs: list[_Run] = []
        for name in sorted(set(self._existing_files())):
            if not name.startswith("rw."):
                continue
            f = self._open_file(name)
            run = parse_run(f.read_all(), f, name)
            if run is not None:
                runs.append(run)
            else:
                f.truncate()  # torn/foreign: reclaim the space
        # a surviving compacted run supersedes its sources — a crash between
        # the merged run's sync and the source truncation leaves both, and
        # keeping both would double-count tombstone shadowing
        superseded = {s for r in runs for s in r.sources}
        for r in runs:
            if r.run_id in superseded:
                self._retire_run(r)
                r.file.truncate()
        runs = [r for r in runs if r.run_id not in superseded]
        for r in sorted(runs, key=lambda r: r.run_id, reverse=True):
            self._levels.setdefault(r.level, []).append(r)
        self._next_run_id = max((r.run_id for r in runs), default=0) + 1
        if runs:
            self._meta = dict(max(runs, key=lambda r: r.meta_seq).meta)
        for _seq, payload in self.queue.recover():
            try:
                ops = wire.loads(payload)
            except wire.WireError as e:
                raise FDBError("file_corrupt",
                               f"redwood WAL entry undecodable: {e}")
            for op in ops:
                if op[0] == _OP_SET:
                    self._apply_set(op[1], op[2])
                elif op[0] == _OP_CLEAR:
                    self._apply_clear(op[1], op[2])
                elif op[0] == _OP_META:
                    self._meta[op[1]] = op[2]
            self._wal_bytes += len(payload)

    # -- introspection (tests / benches) --

    def run_names(self) -> list[str]:
        return [r.name for r in self._runs_newest_first()]

    def level_shape(self) -> dict[int, int]:
        return {lv: len(rs) for lv, rs in sorted(self._levels.items())}
