"""Resolver role: orders commit batches and runs the conflict engine.

Counterpart of foundationdb_tpu/server/resolver.py (reference:
fdbserver/Resolver.actor.cpp resolveBatch :71): batches from all proxies are
serialized per resolver by waiting version.whenAtLeast(prevVersion)
(:104-115), the conflict set decides each transaction (:140-157),
retransmitted batches get their cached reply (:117-128), and the reply
carries one status per transaction (:159-166).

The engine is picked by the CONFLICT_BACKEND knob: "device" is the port's
engine (ops/conflict.py) on the CONFLICT_DEVICE knob's device, "oracle" the
pure-Python reference (ops/conflict_oracle.py). Both make identical
decisions. "sharded" is not ported yet and raises. There is no silent
degrade: a device engine asked for CUDA where there is none raises.
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.future import settle_failed
from foundationdb_tpu_torch.core.notified import AsyncTrigger, NotifiedVersion
from foundationdb_tpu_torch.core.sim import SimProcess
from foundationdb_tpu_torch.ops.batch import (COMMITTED, CONFLICT,
                                              validate_conflict_config)
from foundationdb_tpu_torch.ops.conflict import (DeviceConflictSet,
                                                 drain_and_collect)
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.server.hotspot import HotRangesReply, HotRangeSketch
from foundationdb_tpu_torch.server.interfaces import (
    ResolveTransactionBatchReply, ResolveTransactionBatchRequest, Token)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import (CounterCollection,
                                                fold_transport_counters,
                                                trace_counters_loop)
from foundationdb_tpu_torch.utils.trace import g_trace_batch


def new_conflict_set(oldest_version: int = 0):
    """newConflictSet() dispatch (ConflictSet.h:28) on CONFLICT_BACKEND:
    "device" -> DeviceConflictSet on CONFLICT_DEVICE, "oracle" -> the host
    reference; "sharded" raises invalid_option (not yet ported)."""
    validate_conflict_config()
    backend = KNOBS.CONFLICT_BACKEND
    if backend == "device":
        cs = DeviceConflictSet(oldest_version=oldest_version)
        cs.backend_label = cs.device.type
        return cs
    if backend == "sharded":
        raise FDBError("invalid_option",
                       "CONFLICT_BACKEND=sharded is not yet ported to the "
                       "PyTorch engine")
    return OracleConflictSet(oldest_version=oldest_version)


class Resolver:
    def __init__(self, process: SimProcess, recovery_version: int = 0,
                 n_proxies: int = 1):
        self.process = process
        self.n_proxies = n_proxies
        self.version = NotifiedVersion(recovery_version)
        self.conflict_set = new_conflict_set(oldest_version=recovery_version)
        self._pipelined = hasattr(self.conflict_set, "detect_async")
        if self._pipelined:
            # build the kernels and run every serving bucket now, so the
            # first served batch pays neither
            self.conflict_set.warmup()
        self._recent_replies: dict[int, ResolveTransactionBatchReply] = {}
        # retained state (metadata) transactions for other proxies' catch-up
        # (Resolver.actor.cpp:59-62,170-224): version -> [(locally_committed,
        # mutations)], pruned below the oldest proxy's received version
        self._recent_state_txns: dict[int, list] = {}
        self._proxy_last: dict[int, int] = {}  # proxy_id -> last version
        self.total_resolved = 0
        # dispatched-but-unread batches in version order; the readback
        # drains in groups, one device sync per drain, off the loop thread
        self._drain_pending: list = []
        self._drain_wake = AsyncTrigger()
        self._drained_seq = NotifiedVersion(0)  # drain-group ordering gate
        self._drain_groups: set = set()  # in-flight readback actors
        # set when the device state overflowed: every later reply is an
        # error until a recovery builds a fresh conflict set
        # (clearConflictSet semantics, SkipList.cpp:957)
        self._poisoned: FDBError | None = None
        self._drain_task = (process.spawn(self._drain_loop(), "resolverDrain")
                            if self._pipelined else None)
        self.counters = CounterCollection("Resolver", str(process.address))
        self._c_batches = self.counters.counter("BatchesIn")
        self._c_txns = self.counters.counter("TxnResolved")
        self._c_groups = self.counters.counter("DrainGroups")
        # conflict-hotspot detection (docs/contention.md): every rejected
        # txn's write ranges feed the decayed sketch
        self.hot_sketch = HotRangeSketch()
        self._c_sampled = self.counters.counter("ConflictsSampled")
        process.register(Token.RESOLVER_RESOLVE, self._on_resolve)
        process.register(Token.RESOLVER_METRICS, self._on_metrics)
        process.register(Token.RESOLVER_HOT_RANGES, self._on_hot_ranges)
        self._counters_task = trace_counters_loop(
            process, self.counters, interval=KNOBS.COUNTERS_TRACE_INTERVAL)

    def shutdown(self):
        """Displaced by a re-created resolver on the same worker."""
        self._counters_task.cancel()
        if self._drain_task is not None:
            self._drain_task.cancel()
        for t in list(self._drain_groups):
            t.cancel()

    def _on_metrics(self, req, reply):
        """Role counters plus the process-wide device gauges: dispatches,
        readback waits, transfers and kernel launches."""
        from foundationdb_tpu_torch.ops import conflict, kernels
        from foundationdb_tpu_torch.utils import cudaenv
        snap = self.counters.as_dict()
        snap["Version"] = self.version.get()
        snap["Backend"] = getattr(self.conflict_set, "backend_label", "oracle")
        snap.update(conflict.kernel_metrics.as_dict())
        snap.update(cudaenv.transfer_metrics.as_dict())
        snap.update({"KernelLaunches." + k: v
                     for k, v in kernels.LAUNCHES.items()})
        snap["HotRangeBuckets"] = len(self.hot_sketch)
        snap["HotRangeTotalRate"] = round(
            self.hot_sketch.total_rate(self.process.net.loop.now()), 3)
        reply.send(fold_transport_counters(self.process, snap))

    def _on_hot_ranges(self, req, reply):
        """Conflict-hotspot snapshot: hottest K ranges by decayed rate."""
        k = req if isinstance(req, int) and req > 0 else KNOBS.HOTSPOT_TOP_K
        now = self.process.net.loop.now()
        self.hot_sketch.prune(now)
        reply.send(HotRangesReply(ranges=self.hot_sketch.top_k(k, now),
                                  total_rate=self.hot_sketch.total_rate(now)))

    def _on_resolve(self, req: ResolveTransactionBatchRequest, reply):
        self.process.spawn(self._resolve_batch(req, reply), "resolveBatch")

    async def _resolve_batch(self, req: ResolveTransactionBatchRequest, reply):
        try:
            await self.version.when_at_least(req.prev_version)
        except FDBError as e:
            # displaced while parked on the version gate: settle before
            # dying, or the proxy waits out the full RPC timeout
            settle_failed(reply, e)
            raise
        if self._poisoned is not None:
            reply.send_error(self._poisoned)
            return
        if req.version <= self.version.get():
            cached = self._recent_replies.get(req.version)
            if cached is not None:
                reply.send(cached)
            # unknown old version: a retransmit from before our recovery —
            # drop; the proxy retries and finds the cached reply
            return
        cs = self.conflict_set
        self._c_batches.increment()
        loop = self.process.net.loop
        vid = f"v{req.version}"
        g_trace_batch.span_begin("CommitSpan", vid, "Resolver.Dispatch",
                                 at=loop.now())
        if self._pipelined:
            # enqueue transfer + compute now (the state updates at dispatch,
            # in version order); the verdict is read back by the drain loop
            handle = cs.detect_async(req.transactions, req.version)
            g_trace_batch.span_end("CommitSpan", vid, "Resolver.Dispatch",
                                   at=loop.now())
            self.version.set(req.version)
            self._drain_pending.append((req, reply, handle))
            self._drain_wake.trigger()
            return
        statuses = cs.detect(req.transactions, req.version)
        g_trace_batch.span_end("CommitSpan", vid, "Resolver.Dispatch",
                               at=loop.now())
        self.version.set(req.version)
        self._finish_batch(req, reply, statuses)

    async def _drain_loop(self):
        """Group dispatched batches and spawn one readback actor per group;
        the sequence gate keeps _finish_batch in dispatch order."""
        seq = 0
        while True:
            if not self._drain_pending:
                await self._drain_wake.on_trigger()
                continue
            entries, self._drain_pending = self._drain_pending, []
            seq += 1
            t = self.process.spawn(self._drain_group(seq, entries),
                                   f"resolverDrain{seq}")
            self._drain_groups.add(t)
            t.add_system_callback(lambda _f, t=t: self._drain_groups.discard(t))

    async def _drain_group(self, seq: int, entries: list):
        loop = self.process.net.loop
        handles = [h for _req, _reply, h in entries]
        err = None
        results: list | None = None
        self._c_groups.increment()
        try:
            try:
                # wait on the readback events AND materialize off the loop:
                # an unconverged chunk runs the exact host pass
                t_rb0 = loop.now()
                results = await loop.run_blocking(
                    lambda hs=handles: drain_and_collect(hs))
                t_rb1 = loop.now()
                for req, _reply, _h in entries:
                    vid = f"v{req.version}"
                    g_trace_batch.span_begin("CommitSpan", vid,
                                             "Resolver.ReadbackWait", at=t_rb0)
                    g_trace_batch.span_end("CommitSpan", vid,
                                           "Resolver.ReadbackWait", at=t_rb1)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise  # killed/displaced mid-drain: die, don't reply
                err = e
            except Exception as e:  # noqa: BLE001 — fail the whole group
                err = FDBError("internal_error", str(e))
            await self._drained_seq.when_at_least(seq - 1)
            if results is None:
                results = [(None, None)] * len(entries)
            for (req, reply, _handle), (statuses, herr) in zip(entries,
                                                               results):
                if err is None and herr is not None:
                    err = herr  # state overflow: fatal
                if err is not None:
                    # poison the resolver: every later batch errors too, and
                    # the proxy's failure drives a recovery
                    self._poisoned = err
                    reply.send_error(err)
                    continue
                self._finish_batch(req, reply, statuses)
        finally:
            # covers both awaits: a cancel must still advance the gate, or
            # every later drain group waits forever on seq - 1
            self._advance_drained(seq)

    def _advance_drained(self, seq: int):
        """Advance the drain-ordering gate to `seq`, never backwards and
        never past a still-running predecessor group."""
        def advance(_f=None):
            if self._drained_seq.get() < seq:
                self._drained_seq.set(seq)
        self._drained_seq.when_at_least(seq - 1).add_callback(advance)

    def _finish_batch(self, req: ResolveTransactionBatchRequest, reply,
                      statuses: list[int]):
        """Statuses-dependent bookkeeping and the reply, strictly in version
        order."""
        self.total_resolved += len(req.transactions)
        self._c_txns.increment(len(req.transactions))

        # hotspot detection: each REJECTED txn's write ranges feed the sketch
        now = self.process.net.loop.now()
        sampled = 0
        for txn, status in zip(req.transactions, statuses):
            if status == CONFLICT and txn.write_ranges:
                self.hot_sketch.record(txn.write_ranges, now)
                sampled += 1
        if sampled:
            self._c_sampled.increment(sampled)

        # record this batch's state txns with the LOCAL verdict
        if req.state_txn_indices:
            muts = req.state_txn_mutations or [[]] * len(req.state_txn_indices)
            self._recent_state_txns[req.version] = [
                (statuses[i] == COMMITTED, m)
                for i, m in zip(req.state_txn_indices, muts)]
        # hand back state txns from versions this proxy hasn't seen
        state_out = [(v, entries)
                     for v, entries in sorted(self._recent_state_txns.items())
                     if req.last_receive_version < v < req.version]
        r = ResolveTransactionBatchReply(committed=statuses,
                                         state_mutations=state_out)
        self._recent_replies[req.version] = r
        # prune state txns by what every proxy has ACKED receiving, and
        # replies outside the MVCC window (Resolver.actor.cpp:198-224)
        self._proxy_last[req.proxy_id] = max(
            self._proxy_last.get(req.proxy_id, 0), req.last_receive_version)
        if len(self._proxy_last) >= self.n_proxies:
            oldest_proxy = min(self._proxy_last.values())
            for v in [v for v in self._recent_state_txns if v <= oldest_proxy]:
                del self._recent_state_txns[v]
        floor = req.version - KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        for v in [v for v in self._recent_replies if v < floor]:
            del self._recent_replies[v]
        reply.send(r)
