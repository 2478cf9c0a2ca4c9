"""TLog role: the replicated durable mutation log, tag-partitioned.

Reference: fdbserver/TLogServer.actor.cpp — tLogCommit (:1168) waits for
version order, appends messages into per-tag deques (commitMessages :747),
makes them durable (DiskQueue push/commit), and replies when durable; peeks
serve per-tag cursors; pops advance the durable point so memory can be
reclaimed (:362 version/queueCommittedVersion).

Durability: a DiskQueue (two alternating checksummed SimFiles,
storage/diskqueue.py = DiskQueue.actor.cpp) — a kill loses unsynced pages
exactly like AsyncFileNonDurable, so recovery tests mean something. Popped
versions let the queue truncate (space reclaim).

Bounded memory (updatePersistentData :548 spill + peek reply limits):
- peek replies stop at TLOG_PEEK_REPLY_BYTES; `end` reflects only what was
  included, so a lagging peeker pages through in bounded chunks.
- when un-popped memory exceeds TLOG_SPILL_BYTES, the oldest entries SPILL:
  they leave the in-memory deques but stay durable in the disk queue; a peek
  below the in-memory floor is served by re-reading the queue (the reference
  reads spilled messages back from the IKeyValueStore).
"""

from __future__ import annotations

from collections import deque

from foundationdb_tpu_torch.utils import wire

from foundationdb_tpu_torch.core.future import settle_failed
from foundationdb_tpu_torch.core.notified import NotifiedVersion
from foundationdb_tpu_torch.core.sim import SimProcess
from foundationdb_tpu_torch.server.interfaces import (
    TLogCommitReply, TLogCommitRequest, TLogLockReply, TLogLockRequest,
    TLogPeekReply, TLogPeekRequest, TLogPopRequest, Token)
from foundationdb_tpu_torch.storage.diskqueue import DiskQueue
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop
from foundationdb_tpu_torch.utils.trace import g_trace_batch
from foundationdb_tpu_torch.utils.types import mutations_weight


class TLog:
    def __init__(self, process: SimProcess, recovery_version: int = 0,
                 file_name: str = "tlog.dq", register: bool = True):
        self.process = process
        self.version = NotifiedVersion(recovery_version)  # durable version
        # tag -> deque[(version, [Mutation], weight)]
        self.messages: dict[int, deque] = {}
        self.popped: dict[int, int] = {}  # tag -> pop floor
        self.known_committed_version = recovery_version
        self.locked = False  # epoch ended: no more commits (recovery lock)
        self.queue = DiskQueue(process.net.open_file(process, file_name + ".0"),
                               process.net.open_file(process, file_name + ".1"))
        self._version_seq: deque[tuple[int, int]] = deque()  # (version, seq)
        self._mem_bytes = 0  # payload bytes held in the in-memory deques
        self._mem_floor: dict[int, int] = {}  # tag -> first in-memory version
        # un-popped bytes per tag (memory + spilled): the ratekeeper's log
        # queue signal — grows while a storage server is not consuming
        self._tag_sizes: dict[int, deque] = {}  # tag -> deque[(version, bytes)]
        self._tag_bytes: dict[int, int] = {}
        self.counters = CounterCollection("TLog", str(process.address))
        self._c_commits = self.counters.counter("Commits")
        self._c_bytes_in = self.counters.counter("BytesIn")
        self._c_peeks = self.counters.counter("Peeks")
        self._c_pops = self.counters.counter("Pops")
        if register:
            process.register(Token.TLOG_COMMIT, self._on_commit)
            process.register(Token.TLOG_PEEK, self._on_peek)
            process.register(Token.TLOG_POP, self._on_pop)
            process.register(Token.TLOG_LOCK, self._on_lock)
            process.register(Token.QUEUE_STATS, self._on_queue_stats)
            process.register(Token.TLOG_METRICS, self._on_metrics)
            trace_counters_loop(process, self.counters)

    def _metrics_snapshot(self) -> dict:
        snap = self.counters.as_dict()
        snap["DurableVersion"] = self.version.get()
        snap["QueueBytes"] = sum(self._tag_bytes.values())
        snap["MemBytes"] = self._mem_bytes
        return snap

    def _on_metrics(self, req, reply):
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        reply.send(fold_transport_counters(self.process,
                                           self._metrics_snapshot()))

    def _on_queue_stats(self, req, reply):
        """TLogQueuingMetrics for the ratekeeper: total un-popped bytes
        (in-memory AND spilled — a lagging consumer must register even after
        its backlog spilled out of RAM)."""
        from foundationdb_tpu_torch.server.ratekeeper import QueueStatsReply
        reply.send(QueueStatsReply(
            queue_bytes=sum(self._tag_bytes.values())))

    def _on_lock(self, req: TLogLockRequest, reply):
        """Epoch end: fence old-generation commits (TLogServer lock path /
        epochEnd). Idempotent; reports how far this log durably got so the
        master can pick the recovery version."""
        if not self.locked:
            self.locked = True
            # persist the fence: a rebooted locked TLog must stay locked or a
            # zombie old-generation proxy could commit past the recovery point
            self.queue.push(wire.dumps({"lock": req.epoch}))
            self.queue.commit()
        reply.send(TLogLockReply(
            known_committed_version=self.known_committed_version,
            durable_version=self.version.get()))

    def _on_commit(self, req: TLogCommitRequest, reply):
        self.process.spawn(self._commit(req, reply), "tLogCommit")

    async def _commit(self, req: TLogCommitRequest, reply):
        if self.locked:
            reply.send_error(FDBError("tlog_stopped"))
            return
        try:
            await self.version.when_at_least(req.prev_version)
        except FDBError as e:
            # displaced/cancelled while parked on the version gate: settle
            # before dying, or the proxy's commit pipeline waits out the
            # full RPC timeout (protolint PROTO002)
            settle_failed(reply, e)
            raise
        if self.locked:
            reply.send_error(FDBError("tlog_stopped"))
            return
        if req.version <= self.version.get():
            reply.send(TLogCommitReply(version=self.version.get()))  # duplicate
            return
        bytes_in = 0
        for tag, muts in req.messages.items():
            if muts:
                w = mutations_weight(muts)
                bytes_in += w
                # weight rides with the entry: peeks and pops of the same
                # batch must not re-walk every mutation
                self.messages.setdefault(tag, deque()).append(
                    (req.version, muts, w))
                self._mem_bytes += w
                self._tag_sizes.setdefault(tag, deque()).append((req.version, w))
                self._tag_bytes[tag] = self._tag_bytes.get(tag, 0) + w
        self.known_committed_version = max(self.known_committed_version,
                                           req.known_committed_version)
        # durable push + commit, then reply (group commit = one sync per
        # batch). The fsync stays ON the loop deliberately: an await here
        # would let an epoch lock, a peek, or a queue pop interleave with a
        # half-durable commit (lock-fence bypass, peeks serving non-durable
        # versions, concurrent DiskQueue mutation) — the atomicity of this
        # block is load-bearing for recovery correctness.
        t0 = self.process.net.loop.now()
        seq = self.queue.push(wire.dumps((req.version, req.messages)))
        self.queue.commit()
        self._version_seq.append((req.version, seq))
        self.version.set(req.version)
        self._maybe_spill()
        reply.send(TLogCommitReply(version=req.version))
        self._c_commits.increment()
        self._c_bytes_in.increment(bytes_in)
        # durable-write residency span (fsync runs on-loop by design; both
        # records are emitted after the reply so a kill mid-commit cannot
        # leave the span open)
        g_trace_batch.span_begin("CommitSpan", f"v{req.version}",
                                 "TLog.Commit", at=t0)
        g_trace_batch.span_end("CommitSpan", f"v{req.version}",
                               "TLog.Commit", at=self.process.net.loop.now())

    def _maybe_spill(self):
        """Evict the oldest in-memory entries once memory exceeds the spill
        threshold; they remain durable in the disk queue and peeks below the
        in-memory floor fall back to reading it (updatePersistentData :548)."""
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        while self._mem_bytes > KNOBS.TLOG_SPILL_BYTES:
            oldest_tag = None
            oldest_v = None
            for tag, q in self.messages.items():
                if q and (oldest_v is None or q[0][0] < oldest_v):
                    oldest_v, oldest_tag = q[0][0], tag
            if oldest_tag is None:
                return
            v, _muts, w = self.messages[oldest_tag].popleft()
            self._mem_bytes -= w
            self._mem_floor[oldest_tag] = v + 1

    def _on_peek(self, req: TLogPeekRequest, reply):
        self.process.spawn(self._peek(req, reply), "tLogPeek")

    async def _peek(self, req: TLogPeekRequest, reply):
        # long-poll: block until there is something at/after `begin`
        # (reference peek waits for version growth, TLogServer.actor.cpp)
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        self._c_peeks.increment()
        try:
            await self.version.when_at_least(req.begin)
        except FDBError as e:
            # displaced/cancelled mid-long-poll: settle before dying, or the
            # peeking log router / storage waits out the full RPC timeout
            # (protolint PROTO002)
            settle_failed(reply, e)
            raise
        budget = KNOBS.TLOG_PEEK_REPLY_BYTES
        tag = req.tag
        out: list[tuple[int, list]] = []
        last_v = req.begin - 1
        floor = self._mem_floor.get(tag, 0)
        if req.begin < floor:
            # spilled range: serve from the durable queue (the disk read the
            # reference does for spilled tags). _version_seq maps versions to
            # queue sequence numbers, so the scan starts AT req.begin instead
            # of deserializing the whole queue per page (which would make
            # catch-up quadratic in backlog size).
            start_seq = next((seq for v, seq in self._version_seq
                              if v >= req.begin), 1 << 62)
            for seq, payload in self.queue.live_entries:
                if seq < start_seq:
                    continue
                obj = wire.loads(payload)
                if isinstance(obj, dict):
                    continue  # lock marker
                version, messages = obj
                if version >= floor:
                    break  # seq order == version order: rest is in memory
                if version < req.begin:
                    continue
                muts = messages.get(tag)
                if muts:
                    out.append((version, list(muts)))
                    budget -= mutations_weight(muts)
                last_v = max(last_v, version)
                if budget <= 0:
                    break
            if budget <= 0:
                reply.send(TLogPeekReply(
                    messages=out, end=last_v + 1,
                    popped=self.popped.get(tag, 0),
                    known_committed_version=self.known_committed_version))
                return
            last_v = floor - 1  # the whole spilled gap is covered
        for v, muts, w in self.messages.get(tag, ()):
            if v <= last_v:
                continue
            out.append((v, list(muts)))
            budget -= w
            last_v = v
            if budget <= 0:
                break
        end = (last_v + 1) if budget <= 0 else self.version.get() + 1
        reply.send(TLogPeekReply(
            messages=out, end=end,
            popped=self.popped.get(tag, 0),
            known_committed_version=self.known_committed_version))

    def _on_pop(self, req: TLogPopRequest, reply):
        self._c_pops.increment()
        self.popped[req.tag] = max(self.popped.get(req.tag, 0), req.version)
        q = self.messages.get(req.tag)
        while q and q[0][0] < req.version:
            _v, _muts, w = q.popleft()
            self._mem_bytes -= w
        if req.version > self._mem_floor.get(req.tag, 0):
            self._mem_floor[req.tag] = req.version
        sizes = self._tag_sizes.get(req.tag)
        while sizes and sizes[0][0] < req.version:
            _v, w = sizes.popleft()
            self._tag_bytes[req.tag] -= w
        self._reclaim()
        reply.send(None)

    def _reclaim(self):
        """Truncate the disk queue below the min pop floor across tags
        (TLogServer updatePersistentData: the queue is popped once every
        tag has advanced past a version)."""
        tags = set(self.messages) | set(self.popped)
        if not tags or not self._version_seq:
            return
        floor = min(self.popped.get(t, 0) for t in tags)
        upto_seq = None
        while self._version_seq and self._version_seq[0][0] < floor:
            upto_seq = self._version_seq.popleft()[1] + 1
        if upto_seq is not None:
            self.queue.pop(upto_seq)

    def recover_from_file(self):
        """Rebuild in-memory deques from the durable queue after a reboot."""
        last = self.version.get()
        for seq, payload in self.queue.recover():
            try:
                obj = wire.loads(payload)
            except wire.WireError as e:
                raise FDBError("file_corrupt", f"tlog queue entry undecodable: {e}")
            if isinstance(obj, dict) and "lock" in obj:
                self.locked = True
                continue
            version, messages = obj
            self._version_seq.append((version, seq))
            for tag, muts in messages.items():
                if muts:
                    w = mutations_weight(muts)
                    self.messages.setdefault(tag, deque()).append(
                        (version, muts, w))
                    self._mem_bytes += w
                    self._tag_sizes.setdefault(tag, deque()).append((version, w))
                    self._tag_bytes[tag] = self._tag_bytes.get(tag, 0) + w
            last = max(last, version)
        if last > self.version.get():
            self.version.set(last)
        self._maybe_spill()
        return last


class TLogHost:
    """All TLog generations hosted by one process, routed by epoch.

    Reference: TLogServer.actor.cpp's shared TLog (tLogFn) — after a
    recovery, the OLD locked generation keeps serving peeks (storage servers
    drain it) while the NEW generation accepts commits, both in the same
    process. Without this, recruiting a new generation onto a worker would
    replace the old generation's endpoints and strand its undrained data.
    """

    def __init__(self, process: SimProcess):
        self.process = process
        # uid -> instance; a TLog generation OR a LogRouter (both answer the
        # peek/pop surface — "log routers appear as just another peek
        # source", logsystem.py)
        self.generations: dict[str, object] = {}
        process.register(Token.TLOG_COMMIT, self._route("_on_commit"))
        process.register(Token.TLOG_PEEK, self._route("_on_peek"))
        process.register(Token.TLOG_POP, self._route("_on_pop"))
        process.register(Token.TLOG_LOCK, self._route("_on_lock"))
        process.register(Token.QUEUE_STATS, self._on_queue_stats)
        process.register(Token.TLOG_METRICS, self._on_metrics)

    def _on_queue_stats(self, req, reply):
        # un-popped bytes (memory + spilled), like the standalone handler: a
        # lagging consumer must register even after its backlog spilled
        from foundationdb_tpu_torch.server.ratekeeper import QueueStatsReply
        reply.send(QueueStatsReply(queue_bytes=sum(
            sum(t._tag_bytes.values())
            for t in self.generations.values() if isinstance(t, TLog))))

    def _on_metrics(self, req, reply):
        """Sum counters across hosted generations (one worker = one row in
        status, however many recoveries it has survived)."""
        agg: dict = {"Generations": 0}
        for t in self.generations.values():
            if not isinstance(t, TLog):
                continue
            agg["Generations"] += 1
            for k, v in t._metrics_snapshot().items():
                if k == "DurableVersion":
                    agg[k] = max(agg.get(k, 0), v)
                else:
                    agg[k] = agg.get(k, 0) + v
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        reply.send(fold_transport_counters(self.process, agg))

    def add(self, uid: str, recovery_version: int = 0) -> TLog:
        """uids are unique per recovery ATTEMPT (LogSystemConfig's TLog UIDs),
        so racing recoveries can never collide on a host: a losing attempt's
        generation simply lingers unused, exactly like the reference's stale
        tLog instances awaiting cleanup."""
        t = TLog(self.process, recovery_version=recovery_version,
                 file_name=f"tlog-{uid}.dq", register=False)
        self.generations[uid] = t
        return t

    def _route(self, name: str):
        def handler(req, reply):
            t = self.generations.get(req.uid)
            if t is None:
                reply.send_error(FDBError("tlog_stopped",
                                          f"no generation {req.uid!r}"))
            else:
                getattr(t, name)(req, reply)
        return handler
