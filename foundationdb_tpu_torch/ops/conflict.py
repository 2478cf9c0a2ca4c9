"""The conflict engine a Resolver instantiates: batched MVCC conflict
detection on the card.

Counterpart of foundationdb_tpu/ops/conflict.py:176-212 and 802-1328: the
shapes, the host batch encoder (ring of pinned slots, four shape buckets or
the strided layout's fixed slots, chunking), `detect_async_impl`,
`DeviceConflictSet` (with the CONFLICT_INTRA_MODE evaluator), the single fused
readback per chunk and the drain. The device step is
`conflict_ref.conflict_step` with the phases of ops/kernels.py: on a CUDA
state the Hopper kernels run, on a CPU state their plain versions.

The engine's state lives in fixed buffers, made once and overwritten by
every step, rebase and clear (the JAX engine donates its state). On the
card the scan evaluator runs each chunk as one replay of its shape
bucket's CUDA graph (ops/step_graph.py, `_compiled_step`'s counterpart):
the chunk's single host->device copy lands in the graph's own batch
buffer, and the graph's K13 writes the readback row that the chunk's one
device->host copy reads. The legacy evaluator, and the CPU, run the same
step eagerly.

Versions on the device are int32 offsets from a host-kept int64 base (the
MVCC window is 5e6 versions wide; the host rebases long before an offset
overflows). Key limbs are int32 with the sign bit flipped (utils/keys.py).
Nothing on the dispatch path waits for the device: the only host syncs are
the readback waits in `drain_handles` / `DetectHandle.result`.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import (COMMITTED, CONFLICT, TOO_OLD,
                                              TxnConflictInfo)
from foundationdb_tpu_torch.ops.step_graph import (StepGraph, batch_layout,
                                                   batch_views)
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
    """Static shapes of one conflict batch.

    `key_bytes` sets the exact-comparison width: keys longer than it
    collapse conservatively onto their prefix (utils/keys.py). `strided`
    gives every txn a fixed run of reads // txns read slots and
    writes // txns write slots, unused ones padded with empty ranges; the
    encoder rejects a txn past its stride. Otherwise the layout is pooled:
    ranges pack in order, each slot naming its txn."""

    capacity: int  # K: boundary slots in the step function
    txns: int  # T
    reads: int  # NR: total read ranges per batch
    writes: int  # NW: total write ranges per batch
    key_bytes: int = keylib.KEY_BYTES
    strided: bool = False

    def __post_init__(self):
        if self.key_bytes % 4 or not 4 <= self.key_bytes <= 64:
            raise ValueError(
                f"key_bytes must be a multiple of 4 in [4, 64], got "
                f"{self.key_bytes} (the limb encoding is 4 bytes wide)")
        if self.strided and (self.reads % self.txns or self.writes % self.txns):
            raise ValueError(
                "strided layout needs reads/writes divisible by txns")

    @property
    def limbs(self) -> int:
        return self.key_bytes // 4 + 1


def _resolve_shapes(capacity=None, txns=None, reads_per_txn=None,
                    writes_per_txn=None, key_bytes=None,
                    strided=False) -> ConflictShapes:
    k = KNOBS
    t = txns or k.CONFLICT_BATCH_TXNS
    return ConflictShapes(
        capacity=capacity or k.CONFLICT_STATE_CAPACITY,
        txns=t,
        reads=t * (reads_per_txn or k.CONFLICT_BATCH_READS_PER_TXN),
        writes=t * (writes_per_txn or k.CONFLICT_BATCH_WRITES_PER_TXN),
        key_bytes=key_bytes or keylib.KEY_BYTES,
        strided=strided,
    )


def _layout(sh: ConflictShapes) -> tuple[dict, int]:
    """({field: (offset, shape)}, total size) of one packed int32 batch
    buffer of the shape (`step_graph.batch_layout`)."""
    return batch_layout(sh.limbs, sh.txns, sh.reads, sh.writes)


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
                     advance_floor: bool = True,
                     dest: torch.Tensor | None = None) -> dict:
        """One device batch (dict of tensors on the engine's device) from
        the chunk's transactions; `skip[t]` leaves txn t out (the host
        already decided it TOO_OLD). Keys encode in bulk (utils/keys.py).
        In the strided layout txn t's i-th range lands in slot
        t * stride + i, and rtxn/wtxn hold the fixed slot->txn map. With
        `dest` (a packed buffer of the shape on the device, a step graph's
        input) the copy lands there, on the current stream."""
        sh = shapes or self.shapes
        T, L = sh.txns, self.L
        if len(txns) > T:
            raise FDBError("internal_error",
                           f"{len(txns)} transactions exceed the chunk of {T}")
        slot = self._slot(sh)
        lay = slot["layout"]
        host = batch_views(slot["buf"].numpy(), lay)

        def view(name):
            return host[name]

        rkeys_b, rkeys_e, wkeys_b, wkeys_e, rt, wt = [], [], [], [], [], []
        # rs/ws: the strided layout's slot of each range
        rs, ws = [], []
        rpt, wpt = sh.reads // T, sh.writes // T
        snap, valid = view("snapshot"), view("txn_valid")
        snap.fill(0)
        valid.fill(0)
        for t, txn in enumerate(txns):
            if skip is not None and skip[t]:
                continue
            valid[t] = 1
            snap[t] = self._clamp_off(txn.read_snapshot)
            for i, (b, e) in enumerate(txn.read_ranges):
                rkeys_b.append(b)
                rkeys_e.append(e)
                rs.append(t * rpt + i)
            rt.extend([t] * len(txn.read_ranges))
            for i, (b, e) in enumerate(txn.write_ranges):
                wkeys_b.append(b)
                wkeys_e.append(e)
                ws.append(t * wpt + i)
            wt.extend([t] * len(txn.write_ranges))
        if len(rt) > sh.reads or len(wt) > sh.writes:
            raise FDBError("internal_error",
                           f"{len(rt)} reads / {len(wt)} writes exceed the "
                           f"chunk shape {sh.reads}/{sh.writes}")
        kb = sh.key_bytes
        for name, keys, slots, up in (
                ("rb", rkeys_b, rs, False), ("re", rkeys_e, rs, True),
                ("wb", wkeys_b, ws, False), ("we", wkeys_e, ws, True)):
            out = view(name)
            out.fill(ref.PAD_LIMB)
            if keys:
                idx = slots if sh.strided else slice(len(keys))
                out[:, idx] = keylib.to_signed_limbs(
                    keylib.encode_keys_bulk(keys, kb, round_up=up))
        for name, owners, n, per in (("rtxn", rt, sh.reads, rpt),
                                     ("wtxn", wt, sh.writes, wpt)):
            out = view(name)
            if sh.strided:
                out[:] = np.arange(n, dtype=np.int32) // per
            else:
                out.fill(T)
                out[:len(owners)] = owners
        view("commit_version")[...] = self._clamp_off(commit_version)
        view("advance_floor")[...] = int(bool(advance_floor))

        dev_buf = cudaenv.to_device(slot["buf"], self.device, out=dest)
        if self.device.type == "cuda":
            slot["event"] = torch.cuda.Event()
            slot["event"].record()
        return batch_views(dev_buf, lay)

    def split_for_capacity(self, txns):
        """Chunks of whole transactions that fit the static shape, in batch
        order; a transaction larger than the whole shape (the strided
        layout: than its stride) raises transaction_too_large before any
        chunk touches the state."""
        sh = self.shapes
        if sh.strided:
            rpt, wpt = sh.reads // sh.txns, sh.writes // sh.txns
            for txn in txns:
                if (len(txn.read_ranges) > rpt
                        or len(txn.write_ranges) > wpt):
                    raise FDBError(
                        "transaction_too_large",
                        f"{len(txn.read_ranges)} reads / "
                        f"{len(txn.write_ranges)} writes exceed the strided "
                        f"layout ({rpt}/{wpt} per txn)")
            return [txns[i:i + sh.txns]
                    for i in range(0, max(len(txns), 1), sh.txns)]
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
        _kernel_dispatches.increment()
        # the MVCC floor advances once per logical batch (last chunk), so
        # every chunk's too-old check uses the pre-batch floor
        row = engine.dispatch_chunk(sub, commit_version, host_too_old, shapes,
                                    advance_floor=i == len(subs) - 1)
        # the D2H copy starts now, overlapped with the next chunk's encode
        # and dispatch; it is on the stream before the next replay of the
        # chunk's graph overwrites the row
        chunks.append([sub, host_too_old, row, cudaenv.to_host_async(row)])
    engine.oldest_version = max(
        engine.oldest_version,
        commit_version - KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS)
    return DetectHandle(chunks, host_fallback=engine.host_fallback)


class DeviceConflictSet:
    """Conflict set backed by the device step (ConflictSet.h:27-44):
    construct, feed batches of TxnConflictInfo, get {CONFLICT, TOO_OLD,
    COMMITTED} per transaction. Batches of any size are chunked to the
    static shape in batch order, so "earlier txns win" stays exact.

    `device` defaults to the CONFLICT_DEVICE knob ("cuda"); asking for CUDA
    where there is none raises platform_error. The intra-batch evaluator is
    the CONFLICT_INTRA_MODE knob's, read at construction."""

    # an unconverged chunk's intra-batch verdicts come from the exact host
    # pass (`_exact_intra_host`)
    host_fallback = True

    def __init__(self, capacity: int | None = None, txns: int | None = None,
                 reads_per_txn: int | None = None,
                 writes_per_txn: int | None = None, oldest_version: int = 0,
                 key_bytes: int | None = None, device=None,
                 strided: bool = False):
        self.device = cudaenv.resolve_device(
            KNOBS.CONFLICT_DEVICE if device is None else device)
        self.shapes = _resolve_shapes(capacity, txns, reads_per_txn,
                                      writes_per_txn, key_bytes, strided)
        self.encoder = BatchEncoder(self.shapes, self.device,
                                    base_version=oldest_version)
        self.oldest_version = oldest_version
        self._intra_mode = str(KNOBS.CONFLICT_INTRA_MODE)
        if self._intra_mode not in ref.INTRA_MODES:
            raise FDBError("invalid_option",
                           f"CONFLICT_INTRA_MODE must be one of "
                           f"{ref.INTRA_MODES}, got {self._intra_mode!r}")
        self._intra_rounds = int(KNOBS.CONFLICT_INTRA_ROUNDS)
        # the fixed state buffers: every step, rebase and clear writes them
        self._state = ref.init_state(self.shapes.capacity, self.shapes.limbs,
                                     self.device, oldest=0,
                                     phases=kernels.PHASES)
        self._graphs: dict = {}  # (reads, writes) -> StepGraph

    def _graph(self, shapes: ConflictShapes) -> StepGraph | None:
        """The shape bucket's step graph (captured at its first replay),
        or None where the step runs eagerly: on the CPU, and for the legacy
        evaluator, whose fixpoint loop is unbounded and reads its test on
        the host every round (`run_legacy`), so it cannot be captured."""
        if self.device.type != "cuda" or self._intra_mode == "legacy":
            return None
        key = (shapes.reads, shapes.writes)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(
                self._state, txns=shapes.txns, reads=shapes.reads,
                writes=shapes.writes,
                max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                intra_rounds=self._intra_rounds, strided=shapes.strided)
        return graph

    def _step(self, batch: dict) -> torch.Tensor:
        """The eager step over the fixed state (the CPU; the legacy
        evaluator on the card, see `_graph`): the readback row."""
        _state, _statuses, info = ref.conflict_step(
            self._state, batch,
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            intra_rounds=self._intra_rounds, intra_mode=self._intra_mode,
            strided=self.shapes.strided, phases=kernels.PHASES,
            out=self._state)
        return info["readback"]

    def dispatch_chunk(self, sub, commit_version: int, skip: list[bool],
                       shapes: ConflictShapes,
                       advance_floor: bool) -> torch.Tensor:
        """Encode one chunk and enqueue its step: the (2T+2,) int32 readback
        row [statuses | eligible | overflow | converged] on the device. On
        the card the scan evaluator replays the bucket's graph, its batch
        copied into the graph's own buffer."""
        graph = self._graph(shapes)
        batch = self.encoder.encode_batch(
            sub, commit_version, skip=skip, shapes=shapes,
            advance_floor=advance_floor,
            dest=None if graph is None else graph.buffer)
        return self._step(batch) if graph is None else graph.run()

    @property
    def base_version(self) -> int:
        return self.encoder.base_version

    def _maybe_rebase(self, commit_version: int):
        # shift in <= 2^30 steps so each delta fits int32; values saturate
        # at NEG, so repeated shifts are exact for any version gap
        while commit_version - self.encoder.base_version > _REBASE_THRESHOLD:
            delta = min(commit_version - self.encoder.base_version - (1 << 24),
                        1 << 30)
            ref.rebase_state(self._state, delta, phases=kernels.PHASES,
                             out=self._state)
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
        sized to the chunk, not to the configured maximum. The strided
        layout has one shape."""
        if self.shapes.strided:
            return self.shapes
        return self.encoder.bucket_shapes(nr, nw)

    def warmup(self):
        """Make every serving bucket's program ready, so that the first
        served batch pays no build: on the card, capture each bucket's
        graph (building the kernels on first use; the capture's warm-up
        step runs on a copy of the state); eagerly, run one empty step per
        bucket."""
        sh = self.shapes
        buckets = {self.plan_chunk(r, w) for r in (0, sh.reads)
                   for w in (0, sh.writes)}
        for shapes in sorted(buckets, key=lambda b: (b.reads, b.writes)):
            graph = self._graph(shapes)
            if graph is not None:
                graph.capture()
            else:
                self._step(self.encoder.encode_batch(
                    [], self.encoder.base_version + 1, shapes=shapes))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def clear(self, oldest_version: int = 0):
        """clearConflictSet (SkipList.cpp:957): the state is soft."""
        self.encoder.base_version = oldest_version
        self.oldest_version = oldest_version
        ref.init_state(self.shapes.capacity, self.shapes.limbs, self.device,
                       oldest=0, phases=kernels.PHASES, out=self._state)


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
    copy in flight, or None. Without `host_fallback` an unconverged chunk
    raises internal_error instead of taking the exact host pass."""

    def __init__(self, chunks, host_fallback: bool = True):
        self._chunks = chunks
        self._host_fallback = host_fallback
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
                    if not self._host_fallback:
                        raise FDBError(
                            "internal_error",
                            "a chunk did not converge on the device, and "
                            "this engine has no exact host pass")
                    statuses = _exact_intra_host(sub, host_too_old,
                                                 arr[tc:tc + n])
                out.extend(TOO_OLD if old else int(s)
                           for s, old in zip(statuses, host_too_old))
            self._result = out
            self._chunks = None
        return self._result
