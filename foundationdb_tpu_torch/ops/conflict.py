"""The conflict engine a Resolver instantiates: batched MVCC conflict
detection on the card.

Counterpart of foundationdb_tpu/ops/conflict.py:176-212 and 802-1328: the
shapes, the host batch encoder (ring of pinned slots, four shape buckets,
chunking), `detect_async_impl`, `DeviceConflictSet`, the single fused
readback per chunk and the drain. The device step is
`conflict_ref.conflict_step` with the phases of ops/kernels.py: on a CUDA
state the four Hopper kernels run, on a CPU state their plain versions.

Versions on the device are int32 offsets from a host-kept int64 base (the
MVCC window is 5e6 versions wide; the host rebases long before an offset
overflows). Key limbs are int32 with the sign bit flipped (utils/keys.py).
Nothing on the dispatch path waits for the device: the only host syncs are
the readback waits in `drain_handles` / `DetectHandle.result`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import (COMMITTED, CONFLICT, TOO_OLD,
                                              TxnConflictInfo)
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection

# Process-wide device gauges (merged into RESOLVER_METRICS): dispatches
# (chunks) from detect_async_impl, chunks whose sandwich did not converge
# (their intra-batch verdicts come from the exact host pass, not the
# device), readback-wait wall seconds from drain_and_collect.
kernel_metrics = CounterCollection("ConflictKernel")
_kernel_dispatches = kernel_metrics.counter("KernelDispatches")
_unconverged_chunks = kernel_metrics.counter("UnconvergedChunks")
_readback_waits = kernel_metrics.counter("ReadbackWaits")
_readback_wait_seconds = kernel_metrics.counter("ReadbackWaitSeconds")

_NEG_INT = ref.NEG
_REBASE_THRESHOLD = 1 << 29

# the state and batch converters of the parity tests live with the step
state_from_numpy = ref.state_from_numpy
state_to_numpy = ref.state_to_numpy
batch_from_numpy = ref.batch_from_numpy


@dataclass(frozen=True)
class ConflictShapes:
    """Static shapes of one conflict batch (pooled layout).

    `key_bytes` sets the exact-comparison width: keys longer than it
    collapse conservatively onto their prefix (utils/keys.py)."""

    capacity: int  # K: boundary slots in the step function
    txns: int  # T
    reads: int  # NR: total read ranges per batch (pooled)
    writes: int  # NW: total write ranges per batch
    key_bytes: int = keylib.KEY_BYTES

    def __post_init__(self):
        if self.key_bytes % 4 or not 4 <= self.key_bytes <= 64:
            raise ValueError(
                f"key_bytes must be a multiple of 4 in [4, 64], got "
                f"{self.key_bytes} (the limb encoding is 4 bytes wide)")

    @property
    def limbs(self) -> int:
        return self.key_bytes // 4 + 1


def _resolve_shapes(capacity=None, txns=None, reads_per_txn=None,
                    writes_per_txn=None, key_bytes=None) -> ConflictShapes:
    k = KNOBS
    t = txns or k.CONFLICT_BATCH_TXNS
    return ConflictShapes(
        capacity=capacity or k.CONFLICT_STATE_CAPACITY,
        txns=t,
        reads=t * (reads_per_txn or k.CONFLICT_BATCH_READS_PER_TXN),
        writes=t * (writes_per_txn or k.CONFLICT_BATCH_WRITES_PER_TXN),
        key_bytes=key_bytes or keylib.KEY_BYTES,
    )


def _layout(sh: ConflictShapes) -> tuple[dict, int]:
    """({field: (offset, shape)}, total size) of one packed int32 batch
    buffer, so each chunk moves to the device in a single copy."""
    L, NR, NW, T = sh.limbs, sh.reads, sh.writes, sh.txns
    out, off = {}, 0
    for name, shape in (("rb", (L, NR)), ("re", (L, NR)), ("wb", (L, NW)),
                        ("we", (L, NW)), ("rtxn", (NR,)), ("wtxn", (NW,)),
                        ("snapshot", (T,)), ("txn_valid", (T,)),
                        ("commit_version", ()), ("advance_floor", ())):
        out[name] = (off, shape)
        off += math.prod(shape)
    return out, off


def _field(buf, layout: dict, name: str):
    """The `name` field of a packed batch buffer (numpy array or tensor),
    as a view of its shape."""
    off, shape = layout[name]
    return buf[off:off + math.prod(shape)].reshape(shape)


_BOOL_FIELDS = ("txn_valid", "advance_floor")


class BatchEncoder:
    """Host-side batch encoding and chunking for the device engine.

    Each chunk is encoded into a slot of a small ring per shape bucket: one
    packed int32 buffer (pinned when the engine runs on CUDA) that moves to
    the device in a single non-blocking copy. A slot is reused once the
    CUDA event recorded after its copy has completed; when every slot is in
    flight and the ring is full, the encode takes a fresh buffer (it never
    blocks and never overwrites a buffer a copy may still read)."""

    def __init__(self, shapes: ConflictShapes, device: torch.device,
                 base_version: int = 0):
        self.shapes = shapes
        self.device = device
        self.L = shapes.limbs
        self.base_version = base_version
        self._rings: dict = {}

    def _clamp_off(self, version: int) -> int:
        off = version - self.base_version
        return int(max(min(off, (1 << 31) - 1), _NEG_INT))

    def _slot(self, sh: ConflictShapes) -> dict:
        ring = self._rings.setdefault((sh.reads, sh.writes), [])
        slot = next((s for s in ring
                     if s["event"] is None or s["event"].query()), None)
        if slot is None:
            layout, size = _layout(sh)
            slot = {"event": None, "layout": layout,
                    "buf": cudaenv.host_buffer(size, torch.int32,
                                               self.device)}
            if len(ring) < KNOBS.CONFLICT_ENCODE_RING:
                ring.append(slot)
        return slot

    def bucket_shapes(self, nr: int, nw: int) -> ConflictShapes:
        """Smallest shape bucket covering a chunk with nr reads / nw writes:
        full/16 or full on each axis, so at most four shapes."""
        sh = self.shapes

        def pick(n, full):
            small = max(full // 16, 8)
            return small if n <= small else full
        r, w = pick(nr, sh.reads), pick(nw, sh.writes)
        if (r, w) == (sh.reads, sh.writes):
            return sh
        return dataclasses.replace(sh, reads=r, writes=w)

    def encode_batch(self, txns: list[TxnConflictInfo], commit_version: int,
                     skip: list[bool] | None = None,
                     shapes: ConflictShapes | None = None,
                     advance_floor: bool = True) -> dict:
        """One device batch (dict of tensors on the engine's device) from
        the chunk's transactions; `skip[t]` leaves txn t out (the host
        already decided it TOO_OLD). Keys encode in bulk (utils/keys.py)."""
        sh = shapes or self.shapes
        T, L = sh.txns, self.L
        if len(txns) > T:
            raise FDBError("internal_error",
                           f"{len(txns)} transactions exceed the chunk of {T}")
        slot = self._slot(sh)
        lay = slot["layout"]
        host = slot["buf"].numpy()

        def view(name):
            return _field(host, lay, name)

        rkeys_b, rkeys_e, wkeys_b, wkeys_e, rt, wt = [], [], [], [], [], []
        snap, valid = view("snapshot"), view("txn_valid")
        snap.fill(0)
        valid.fill(0)
        for t, txn in enumerate(txns):
            if skip is not None and skip[t]:
                continue
            valid[t] = 1
            snap[t] = self._clamp_off(txn.read_snapshot)
            for b, e in txn.read_ranges:
                rkeys_b.append(b)
                rkeys_e.append(e)
            rt.extend([t] * len(txn.read_ranges))
            for b, e in txn.write_ranges:
                wkeys_b.append(b)
                wkeys_e.append(e)
            wt.extend([t] * len(txn.write_ranges))
        if len(rt) > sh.reads or len(wt) > sh.writes:
            raise FDBError("internal_error",
                           f"{len(rt)} reads / {len(wt)} writes exceed the "
                           f"chunk shape {sh.reads}/{sh.writes}")
        kb = sh.key_bytes
        for name, keys, up in (("rb", rkeys_b, False), ("re", rkeys_e, True),
                               ("wb", wkeys_b, False), ("we", wkeys_e, True)):
            out = view(name)
            out.fill(ref.PAD_LIMB)
            if keys:
                out[:, :len(keys)] = keylib.to_signed_limbs(
                    keylib.encode_keys_bulk(keys, kb, round_up=up))
        for name, owners in (("rtxn", rt), ("wtxn", wt)):
            out = view(name)
            out.fill(T)
            out[:len(owners)] = owners
        view("commit_version")[...] = self._clamp_off(commit_version)
        view("advance_floor")[...] = int(bool(advance_floor))

        dev_buf = cudaenv.to_device(slot["buf"], self.device)
        if self.device.type == "cuda":
            slot["event"] = torch.cuda.Event()
            slot["event"].record()
        batch = {name: _field(dev_buf, lay, name) for name in lay}
        for name in _BOOL_FIELDS:
            batch[name] = batch[name] != 0
        return batch

    def split_for_capacity(self, txns):
        """Chunks of whole transactions that fit the static shape, in batch
        order; a transaction larger than the whole shape raises
        transaction_too_large before any chunk touches the state."""
        sh = self.shapes
        subs, cur, nr, nw = [], [], 0, 0
        for txn in txns:
            tr, tw = len(txn.read_ranges), len(txn.write_ranges)
            if tr > sh.reads or tw > sh.writes:
                raise FDBError("transaction_too_large",
                               f"{tr} reads / {tw} writes exceed batch shape")
            if cur and (nr + tr > sh.reads or nw + tw > sh.writes
                        or len(cur) >= sh.txns):
                subs.append(cur)
                cur, nr, nw = [], 0, 0
            cur.append(txn)
            nr += tr
            nw += tw
        subs.append(cur)
        return subs


def detect_async_impl(engine, txns: list[TxnConflictInfo],
                      commit_version: int) -> "DetectHandle":
    """Enqueue a whole logical batch on the device and return a handle; no
    host<->device synchronization happens until the handle is drained.
    Batch N+1's transfer and compute overlap batch N's readback (the
    proxy's pipelining, MasterProxyServer.actor.cpp:364-366)."""
    engine._maybe_rebase(commit_version)
    enc = engine.encoder
    subs = enc.split_for_capacity(txns)
    # too-old is decided here with exact int64 versions: below the MVCC
    # floor, or so stale the device offset would saturate at NEG (which
    # would compare as "no version" and miss conflicts)
    pre_batch_oldest = engine.oldest_version
    base = enc.base_version
    chunks = []
    for i, sub in enumerate(subs):
        host_too_old = [bool(t.read_ranges)
                        and (t.read_snapshot < pre_batch_oldest
                             or t.read_snapshot - base <= _NEG_INT)
                        for t in sub]
        nr = sum(len(t.read_ranges) for t, old in zip(sub, host_too_old)
                 if not old)
        nw = sum(len(t.write_ranges) for t, old in zip(sub, host_too_old)
                 if not old)
        shapes = engine.plan_chunk(nr, nw)
        # the MVCC floor advances once per logical batch (last chunk), so
        # every chunk's too-old check uses the pre-batch floor
        batch = enc.encode_batch(sub, commit_version, skip=host_too_old,
                                 shapes=shapes,
                                 advance_floor=i == len(subs) - 1)
        _kernel_dispatches.increment()
        engine._state, statuses, info = engine._step(engine._state, batch)
        combined = _combine_status(statuses, info["eligible"],
                                   info["overflow"], info["converged"])
        # the D2H copy starts now, overlapped with the next chunk's encode
        # and dispatch
        chunks.append([sub, host_too_old, combined,
                       cudaenv.to_host_async(combined)])
    engine.oldest_version = max(
        engine.oldest_version,
        commit_version - KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS)
    return DetectHandle(chunks)


class DeviceConflictSet:
    """Conflict set backed by the device step (ConflictSet.h:27-44):
    construct, feed batches of TxnConflictInfo, get {CONFLICT, TOO_OLD,
    COMMITTED} per transaction. Batches of any size are chunked to the
    static shape in batch order, so "earlier txns win" stays exact.

    `device` defaults to the CONFLICT_DEVICE knob ("cuda"); asking for CUDA
    where there is none raises platform_error."""

    def __init__(self, capacity: int | None = None, txns: int | None = None,
                 reads_per_txn: int | None = None,
                 writes_per_txn: int | None = None, oldest_version: int = 0,
                 key_bytes: int | None = None, device=None):
        self.device = cudaenv.resolve_device(
            KNOBS.CONFLICT_DEVICE if device is None else device)
        self.shapes = _resolve_shapes(capacity, txns, reads_per_txn,
                                      writes_per_txn, key_bytes)
        self.encoder = BatchEncoder(self.shapes, self.device,
                                    base_version=oldest_version)
        self.oldest_version = oldest_version
        self._intra_rounds = int(KNOBS.CONFLICT_INTRA_ROUNDS)
        self._state = self._init_state()

    def _init_state(self) -> dict:
        return ref.init_state(self.shapes.capacity, self.shapes.limbs,
                              self.device, oldest=0, phases=kernels.PHASES)

    def _step(self, state: dict, batch: dict):
        return ref.conflict_step(
            state, batch,
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            intra_rounds=self._intra_rounds, phases=kernels.PHASES)

    @property
    def base_version(self) -> int:
        return self.encoder.base_version

    def _maybe_rebase(self, commit_version: int):
        # shift in <= 2^30 steps so each delta fits int32; values saturate
        # at NEG, so repeated shifts are exact for any version gap
        while commit_version - self.encoder.base_version > _REBASE_THRESHOLD:
            delta = min(commit_version - self.encoder.base_version - (1 << 24),
                        1 << 30)
            self._state = ref.rebase_state(self._state, delta,
                                           phases=kernels.PHASES)
            self.encoder.base_version += delta

    # -- ConflictBatch interface --
    def detect(self, txns: list[TxnConflictInfo],
               commit_version: int) -> list[int]:
        return self.detect_async(txns, commit_version).result()

    def detect_async(self, txns: list[TxnConflictInfo],
                     commit_version: int) -> "DetectHandle":
        return detect_async_impl(self, txns, commit_version)

    def plan_chunk(self, nr: int, nw: int) -> ConflictShapes:
        """The chunk's shape bucket: transfer bytes and the device sort are
        sized to the chunk, not to the configured maximum."""
        return self.encoder.bucket_shapes(nr, nw)

    def warmup(self):
        """Run one empty step per serving bucket, building the kernels on
        first use, so the first served batch pays no build."""
        sh = self.shapes
        for nr, nw in sorted({(r, w) for r in (0, sh.reads)
                              for w in (0, sh.writes)}):
            batch = self.encoder.encode_batch(
                [], self.encoder.base_version + 1,
                shapes=self.plan_chunk(nr, nw))
            self._state, _statuses, _info = self._step(self._state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def clear(self, oldest_version: int = 0):
        """clearConflictSet (SkipList.cpp:957): the state is soft."""
        self.encoder.base_version = oldest_version
        self.oldest_version = oldest_version
        self._state = self._init_state()


def _combine_status(statuses, eligible, overflow, converged) -> torch.Tensor:
    """[statuses | eligible | overflow | converged] as one (2T+2,) int32
    tensor, so each chunk reads back in a single copy."""
    return torch.cat([statuses.to(torch.int32), eligible.to(torch.int32),
                      overflow.to(torch.int32).reshape(1),
                      converged.to(torch.int32).reshape(1)])


def drain_handles(handles: list["DetectHandle"]) -> None:
    """Materialize many DetectHandles: every chunk's device->host copy was
    started at dispatch, so this waits on each copy's event and N batches
    cost about one round trip. result() afterwards touches no device
    state."""
    pend = [h for h in handles if h._result is None and h._chunks]
    for h in pend:
        for ch in h._chunks:
            if isinstance(ch[2], np.ndarray):
                continue
            host, event = ch[3]
            if event is not None:
                event.synchronize()
            ch[2], ch[3] = host.numpy(), None


def drain_and_collect(
        handles: list["DetectHandle"], timing: dict | None = None,
) -> list[tuple[list[int] | None, "FDBError | None"]]:
    """drain_handles + result() for every handle, off the event loop: one
    (statuses, error) pair per handle, in order. Errors are returned, not
    raised, so one overflow does not strand the other handles' results."""
    t0 = time.perf_counter()
    drain_handles(handles)
    t1 = time.perf_counter()
    out: list[tuple[list[int] | None, FDBError | None]] = []
    for h in handles:
        try:
            out.append((h.result(), None))
        except FDBError as e:
            out.append((None, e))
    t2 = time.perf_counter()
    if timing is not None:
        timing["drain_seconds"] = t1 - t0
        timing["collect_seconds"] = t2 - t1
    _readback_waits.increment()
    _readback_wait_seconds.increment(t2 - t0)
    return out


def _exact_intra_host(sub, host_too_old, eligible):
    """Exact sequential "earlier txns win" pass for an unconverged chunk.

    Too-old and history verdicts are exact on the device (`eligible`
    survived both); the greedy pass runs here on the chunk's byte ranges.
    The device merged the sandwich's upper bound (a superset of the writes
    committed here): later false conflicts are possible, false commits not."""
    from foundationdb_tpu_torch.ops.conflict_oracle import _RangeSet
    statuses = []
    published = _RangeSet()
    for t, txn in enumerate(sub):
        if host_too_old[t]:
            statuses.append(TOO_OLD)
            continue
        if not eligible[t]:
            statuses.append(CONFLICT)
            continue
        if any(published.overlaps(b, e) for b, e in txn.read_ranges):
            statuses.append(CONFLICT)
            continue
        for b, e in txn.write_ranges:
            published.add(b, e)
        statuses.append(COMMITTED)
    return statuses


class DetectHandle:
    """Deferred result of detect_async. Each chunk is
    [sub_txns, host_too_old, combined, readback]: `combined` is the device
    tensor [statuses(T) | eligible(T) | overflow | converged] until drained,
    then its numpy copy; `readback` is the (pinned host tensor, event) of a
    copy in flight, or None."""

    def __init__(self, chunks):
        self._chunks = chunks
        self._result: list[int] | None = None

    def result(self) -> list[int]:
        if self._result is None:
            drain_handles([self])
            out: list[int] = []
            for sub, host_too_old, arr, _rb in self._chunks:
                n = len(sub)
                tc = (len(arr) - 2) // 2
                if arr[2 * tc]:
                    # the state overflowed and is poisoned: fatal for this
                    # set; the owner reconstructs (clearConflictSet)
                    raise FDBError(
                        "internal_error",
                        "conflict state capacity exceeded; raise "
                        "CONFLICT_STATE_CAPACITY")
                if arr[2 * tc + 1]:
                    statuses = arr[:n]
                else:
                    _unconverged_chunks.increment()
                    statuses = _exact_intra_host(sub, host_too_old,
                                                 arr[tc:tc + n])
                out.extend(TOO_OLD if old else int(s)
                           for s, old in zip(statuses, host_too_old))
            self._result = out
            self._chunks = None
        return self._result
