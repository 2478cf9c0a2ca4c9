"""Storage server role: versioned reads over a TLog-fed MVCC window.

Reference: fdbserver/storageserver.actor.cpp — the update loop (:2358) pulls
this server's tag from the log system, applies mutations into VersionedData at
each version, and wakes readers (waitForVersion :654). getValueQ (:707) and
getKeyValues (:1210) serve reads at any version in the window;
updateStorage (:2633) advances durability and pops the TLog; watches
(watchValueQ :842) resolve when a key's value changes.

KeySelector resolution happens server-side like the reference (a selector
walks live keys from its base; offsets beyond the shard would chain to other
servers — single-shard for now).
"""

from __future__ import annotations

from collections import deque

from foundationdb_tpu_torch.core.future import settle_failed
from foundationdb_tpu_torch.core.notified import NotifiedVersion
from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.interfaces import (
    AddShardRequest, GetKeyValuesReply, GetKeyValuesRequest, GetValueReply,
    GetValueRequest, GetStorageMetricsRequest, KeySelector, LogEpoch,
    SetLogSystemRequest, SetShardsRequest, ShardMetrics, TLogPeekRequest,
    TLogPopRequest, Token, WatchValueRequest)
from foundationdb_tpu_torch.server.versioned_map import make_versioned_map
from foundationdb_tpu_torch.storage.kvstore import MemoryKeyValueStore
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop
from foundationdb_tpu_torch.utils.types import Mutation, MutationType
from foundationdb_tpu_torch.utils import wire

_DURABLE_VERSION_KEY = "durableVersion"
_KS_PREFIX = b"\xff/keyServers/"
_SSD_DIR: list[str] = []
# watermark sentinel: a rollback unwound a fetchKeys splice, so the range
# has NO valid local history at any version until a new splice re-copies it
_WM_INFINITE = 1 << 62


def _default_ssd_dir() -> str:
    """One fresh directory per interpreter run (no stale files from crashed
    runs; SSD_DATA_DIR overrides for real deployments)."""
    if not _SSD_DIR:
        import tempfile
        _SSD_DIR.append(tempfile.mkdtemp(prefix="fdbtpu-ssd-"))
    return _SSD_DIR[0]


class StorageServer:
    def __init__(self, process: SimProcess, tag: int,
                 tlog_addrs: list[str] | None = None,
                 recovery_version: int = 0,
                 log_epochs: list[LogEpoch] | None = None,
                 recovery_count: int = 0,
                 shard_ranges: list[tuple[bytes, bytes | None]] | None = None,
                 engine: str | None = None):
        """Pulls its tag from the log system's epoch list (version-routed:
        epoch (begin, end] served by that generation's TLogs); pops go to
        every TLog of every epoch holding the tag.

        Durability (updateStorage :2633 + restoreDurableState :2871): every
        mutation leaving the MVCC window is applied to a durable KV engine
        before the TLog is popped; on reboot the engine's contents seed the
        versioned map at the persisted durable version and the TLog is
        re-pulled from there.
        """
        self.process = process
        self.tag = tag
        if log_epochs is None:
            log_epochs = [LogEpoch(begin=0, end=None, addrs=list(tlog_addrs or []))]
        self.log_epochs: list[LogEpoch] = log_epochs
        self.recovery_count = recovery_count
        # assigned shards; None = serve everything (directly-built clusters).
        # A request outside them gets wrong_shard_server so a client with a
        # stale location cache re-resolves (storageserver getValueQ's
        # serveGetValueRequests shard check).
        self.shard_ranges = shard_ranges
        self._layout_version = None  # last SET_SHARDS (epoch, version) applied
        # fence of the move that installed each range: a re-add with a HIGHER
        # fence is a new move onto a server that may have missed the range's
        # mutations since (an exclusion drained it, then it was included
        # back) and must re-fetch; only a retry of the SAME move may skip
        self._shard_fences: dict = {}
        # version-fenced revocations from keyServers private mutations seen
        # in this server's OWN tag stream: (begin, end, version) means this
        # server stopped owning [begin, end) at `version` — reads at read
        # versions >= it get wrong_shard_server even though shard_ranges
        # still lists the range (the authoritative SET_SHARDS push is a
        # racing one-way message; the version stream is not)
        self._revoked: list[tuple[bytes, bytes | None, int]] = []
        # fetched-version LOW watermarks: (begin, end, version) means this
        # server's history for [begin, end) starts at `version` (a fetchKeys
        # splice copied the range's state AT that version; the MVCC window
        # below it holds pre-splice state — empty, or stale from before the
        # range moved away). Reads BELOW the watermark get
        # wrong_shard_server so the client re-resolves onto a replica that
        # has the history — the low-fence mirror of _revoked's upper fences,
        # and what makes a freshly-topped-up replica never weaker than
        # single-copy. Narrowed by a re-splice (which re-copies the range),
        # pruned once durability passes them (transaction_too_old covers),
        # and raised to _WM_INFINITE by a rollback that unwinds the splice.
        self._watermarks: list[tuple[bytes, bytes | None, int]] = []
        # engine selection (openKVStore dispatch IKeyValueStore.h:66,
        # KeyValueStoreType FDBTypes.h:475): "memory" = hashmap + sim-file
        # WAL (kill-injected durability faults); "redwood" = log-structured
        # WAL + memtable + compacted runs over the SAME file surface (torn
        # tails apply to its WAL and run files too); "ssd" = host B-tree
        # over platform SQLite on a REAL file (survives sim reboots;
        # torn-write injection does not apply to it)
        from foundationdb_tpu_torch.storage.kvstore import (
            open_kv_store, validate_storage_engine)
        self.engine = engine or KNOBS.STORAGE_ENGINE
        validate_storage_engine(self.engine)
        if self.engine == "memory":
            self.store = open_kv_store(
                "memory",
                file0=process.net.open_file(process, f"storage-{tag}.0"),
                file1=process.net.open_file(process, f"storage-{tag}.1"))
        elif self.engine == "redwood":
            # run files live beside the WAL under the "storage-{tag}."
            # prefix, so worker reboot detection (any file named storage-*)
            # re-attaches this role like the memory engine's WAL; over the
            # real transport the same names land in the process data dir
            prefix = f"storage-{tag}."

            def _rw_open(name: str, _p=prefix, _proc=process):
                return _proc.net.open_file(_proc, _p + name)

            def _rw_existing(_p=prefix, _proc=process):
                names = {n for n in _proc.files
                         if n.startswith(_p + "rw.")}
                data_dir = getattr(_proc.net, "data_dir", None)
                if data_dir:  # real transport: files survive the process
                    import os
                    d = os.path.join(data_dir,
                                     _proc.address.replace(":", "_"))
                    if os.path.isdir(d):
                        names.update(n for n in os.listdir(d)
                                     if n.startswith(_p + "rw."))
                return sorted(n[len(_p):] for n in names)

            self.store = open_kv_store(
                "redwood",
                file0=process.net.open_file(process, f"storage-{tag}.0"),
                file1=process.net.open_file(process, f"storage-{tag}.1"),
                open_file=_rw_open, existing_files=_rw_existing)
        else:
            import os
            base = KNOBS.SSD_DATA_DIR or _default_ssd_dir()
            # the network id keeps two clusters in one interpreter (or a
            # re-run's leftovers) from recovering each other's files; same-
            # cluster reboots share the same network and thus the same path
            path = os.path.join(
                base, f"fdbtpu-{id(process.net):x}"
                      f"-{process.address.replace(':', '_')}"
                      f"-storage-{tag}.sqlite")
            self.store = open_kv_store(self.engine, path=path)
            # the data lives in a host file, invisible to the sim process's
            # file table — register a marker sim file so worker reboot
            # detection (any file named storage-*) re-attaches this role
            # after a whole-cluster restart, same as the memory engine's WAL
            process.net.open_file(process, f"storage-{tag}.ssd")
        self.store.recover()
        meta = self.store.get_metadata(_DURABLE_VERSION_KEY)
        self.durable_version = max(
            recovery_version, int(meta.decode()) if meta else 0)
        self.data = make_versioned_map(oldest_version=self.durable_version)
        for k, v in self.store.get_range(b"", b"\xff" * 32):
            self.data.apply(self.durable_version,
                            Mutation(MutationType.SET_VALUE, k, v))
        self.data.oldest_version = self.durable_version
        self.version = NotifiedVersion(self.durable_version)  # latest applied
        # Pull cursor: unlike self.version (monotone; readers wait on it) this
        # can move backwards on rollback, so re-delivered mutations from a new
        # epoch in (rollback_to, old_version] are re-fetched, not skipped.
        self._peek_begin = self.durable_version
        # Highest version known fully acked across the log system (TLog peek
        # replies carry it; the proxy stamps each TLogCommit with its
        # committed_version). Durability must never pass it: versions beyond
        # it can be rolled back by a recovery, and rollback below the durable
        # engine is fatal (the reference's TLogPeekReply knownCommittedVersion
        # serves exactly this role). Seeded from durable_version: it was
        # bounded by known-committed before the reboot.
        self._known_committed = self.durable_version
        self._pending_durable: deque[tuple[int, list]] = deque()
        self._watches: list[tuple[WatchValueRequest, object]] = []
        process.register(Token.STORAGE_GET_VALUE, self._on_get_value)
        process.register(Token.STORAGE_GET_VALUES, self._on_get_values)
        process.register(Token.STORAGE_GET_KEY_VALUES, self._on_get_key_values)
        process.register(Token.STORAGE_WATCH_VALUE, self._on_watch)
        process.register(Token.STORAGE_SET_LOGSYSTEM, self._on_set_logsystem)
        process.register(Token.QUEUE_STATS, self._on_queue_stats)
        process.register(Token.STORAGE_GET_METRICS, self._on_get_metrics)
        process.register(Token.STORAGE_ADD_SHARD, self._on_add_shard)
        process.register(Token.STORAGE_SET_SHARDS, self._on_set_shards)
        self.counters = CounterCollection("Storage", str(process.address))
        self._c_point_reads = self.counters.counter("PointReads")
        self._c_batch_reads = self.counters.counter("BatchReadKeys")
        self._c_range_reads = self.counters.counter("RangeReads")
        self._c_watches = self.counters.counter("Watches")
        self._c_mutations = self.counters.counter("MutationsApplied")
        # engine read-path observability (redwood exports read_stats();
        # other engines simply never move these) — counters carry the
        # cumulative store tallies via delta-sync at snapshot time
        self._c_engine = {
            "block_cache_hits": self.counters.counter("EngineBlockCacheHits"),
            "block_cache_misses":
                self.counters.counter("EngineBlockCacheMisses"),
            "bloom_negatives": self.counters.counter("EngineBloomNegatives"),
            "native_gets": self.counters.counter("EngineNativeReads"),
            "fallback_gets": self.counters.counter("EngineFallbackReads"),
            "blocks_decoded": self.counters.counter("EngineBlocksDecoded"),
            "batch_gets": self.counters.counter("EngineBatchReads"),
        }
        self._engine_stats_seen: dict[str, int] = {}
        # versioned hot-key read cache (readcache.py): zipfian skew is
        # answered from one dict probe per key; the update loop invalidates
        # touched entries in the same tick it applies their mutations
        from foundationdb_tpu_torch.server.readcache import VersionedReadCache
        self._read_cache = (VersionedReadCache()
                            if KNOBS.READ_CACHE_ENABLED else None)
        self._c_cache_hits = self.counters.counter("ReadCacheHits")
        self._c_cache_misses = self.counters.counter("ReadCacheMisses")
        self._c_cache_inval = self.counters.counter("ReadCacheInvalidations")
        self._c_wm_rejects = self.counters.counter("WatermarkRejects")
        process.register(Token.STORAGE_METRICS, self._on_metrics)
        self._counters_task = trace_counters_loop(process, self.counters)
        self._ingest_gate: object | None = None  # set while fetchKeys runs
        self._ingest_idle: object | None = None  # update loop parked handshake
        from foundationdb_tpu_torch.server.logsystem import PeekCursor
        self._cursor = PeekCursor(
            process, self.log_epochs, self.tag, self._peek_begin,
            # live view: a recovery rebinds log_epochs / rewinds _peek_begin
            # while the cursor may be mid-retry on a dead replica
            refresh=lambda: (self.log_epochs, self._peek_begin),
            # a fetchKeys splice needs the loop parked; bail out of retries
            interrupted=lambda: self._ingest_gate is not None)
        self._pull_task = process.spawn(self._update_loop(), "ssUpdate")
        # true while an engine commit is running off-loop (real event loop
        # only — under sim run_blocking is inline, so no other actor can
        # ever observe it set). The redwood maintenance actor must not
        # mutate the shared WAL queue (apply_maintenance pops/truncates it)
        # while a commit thread is pushing to it.
        self._commit_inflight = False
        # native transport fast path (net/native_transport.py): while this
        # server serves everything (no shard map, no revocations) out of
        # the C versioned map, the transport's C data plane answers
        # GET_VALUE/GET_VALUES/GET_RANGE straight from the VStore. The
        # moment sharding starts the plane is disabled for good — per-key
        # ownership decisions stay in Python.
        self._native_plane = False
        self._native_plane_blocked = False
        self._native_plane_update()
        self._maint_task = None
        if self.engine == "redwood":
            # flush/compaction actor (the reference's Redwood drives these
            # from the storage server's actor model too). Decisions are a
            # pure function of applied byte counts and the poll tick, so the
            # same seed produces the same flush/compaction sequence.
            self._maint_task = process.spawn(
                self._redwood_maintenance_loop(), "ssCompaction")

    def shutdown(self):
        """Displaced by a re-created storage role on the same worker."""
        self._native_plane_blocked = True
        self._native_plane_update()
        self._pull_task.cancel()
        self._counters_task.cancel()
        if self._maint_task is not None:
            self._maint_task.cancel()

    def _native_plane_update(self):
        """Enable/refresh/disable this server's claim on the transport's C
        fast path. Called in the SAME synchronous block as every state
        change that affects read correctness (version advance,
        forget_before, rollback, shard layout) — the event loop is single-
        threaded, so the C plane can never serve between the state change
        and the bounds push."""
        table = getattr(self.process.net, "native_table", None)
        if table is None:
            return
        store = getattr(self.data, "_store", None)  # the C VStore, if native
        eligible = (store is not None and self.shard_ranges is None
                    and not self._revoked and not self._watermarks
                    and not self._native_plane_blocked)
        if not eligible:
            if self._native_plane:
                self._native_plane = False
                if getattr(self.process.net, "_native_storage_owner",
                           None) is self:
                    self.process.net._native_storage_owner = None
                table.disable_storage()
            return
        owner = getattr(self.process.net, "_native_storage_owner", None)
        if owner is not None and owner is not self:
            return  # another storage role on this transport owns the plane
        if not self._native_plane:
            from foundationdb_tpu_torch.net import native_transport
            table.enable_storage(
                store, *native_transport.storage_wire_ids(),
                self.data.oldest_version, self.version.get(),
                KNOBS.DESIRED_TOTAL_BYTES)
            self.process.net._native_storage_owner = self
            self._native_plane = True
        else:
            table.set_read_bounds(self.data.oldest_version,
                                  self.version.get())

    def _sync_engine_counters(self):
        """Fold the engine's cumulative read-path tallies into the
        CounterCollection as deltas (counters are monotone; the engine
        keeps running totals)."""
        stats = getattr(self.store, "read_stats", None)
        if stats is None:
            return
        for name, total in stats().items():
            c = self._c_engine.get(name)
            if c is None:
                continue
            delta = total - self._engine_stats_seen.get(name, 0)
            if delta > 0:
                c.increment(delta)
            self._engine_stats_seen[name] = total

    def _sync_cache_counters(self):
        """Fold the read cache's running tallies into the CounterCollection
        as deltas (same monotone-fold discipline as the engine counters)."""
        rc = self._read_cache
        if rc is None:
            return
        for c, attr in ((self._c_cache_hits, "hits"),
                        (self._c_cache_misses, "misses"),
                        (self._c_cache_inval, "invalidations")):
            total = getattr(rc, attr)
            seen = self._engine_stats_seen.get("cache_" + attr, 0)
            if total > seen:
                c.increment(total - seen)
            self._engine_stats_seen["cache_" + attr] = total

    def _on_metrics(self, req, reply):
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        self._sync_engine_counters()
        self._sync_cache_counters()
        snap = self.counters.as_dict()
        snap["Version"] = self.version.get()
        snap["DurableVersion"] = self.durable_version
        snap["LagVersions"] = self.version.get() - self.durable_version
        if self._read_cache is not None:
            snap["ReadCacheEntries"] = len(self._read_cache.entries)
            snap["ReadCacheHotRanges"] = len(self._read_cache.hot_ranges)
        reply.send(fold_transport_counters(self.process, snap))

    # -- recovery (rollback :2211 + log-system rebind) --

    def _on_set_logsystem(self, req: SetLogSystemRequest, reply):
        if req.recovery_count <= self.recovery_count:
            reply.send(None)  # stale recovery broadcast
            return
        self.recovery_count = req.recovery_count
        # discard in-memory versions the new log system does not know; they
        # were never reported committed (the recovery version is min-durable
        # over a locked quorum, so every acked commit is <= rollback_to)
        if req.rollback_to < self.durable_version:
            # Never-acked data has already been made durable: possible when a
            # long partition lets the durability cursor advance past versions
            # the recovered quorum does not know (peeked from a TLog outside
            # the locked quorum). Clamping would silently serve uncommitted
            # data as committed; the reference treats rollback-past-durable
            # as fatal for the storage server (it re-initializes from a clean
            # fetch, storageserver.actor.cpp:2211 region). Kill THIS process
            # (not the whole sim): the role stops serving its poisoned state
            # and the cluster heals by re-replicating its shards. Should be
            # unreachable now that durability is clamped by known_committed.
            from foundationdb_tpu_torch.core.sim import KillType
            from foundationdb_tpu_torch.utils.trace import TraceEvent
            e = FDBError(
                "internal_error",
                f"rollback to {req.rollback_to} below durable version "
                f"{self.durable_version}: storage server must be re-initialized")
            TraceEvent("SSRollbackPastDurable", self.process.address) \
                .detail("RollbackTo", req.rollback_to) \
                .detail("Durable", self.durable_version).error(e).log()
            reply.send_error(e)
            self.process.net.kill(self.process.address, KillType.KillProcess)
            return
        rollback_to = req.rollback_to
        self.data.rollback(rollback_to)
        if self._read_cache is not None:
            self._read_cache.clear()  # tags above rollback_to are now lies
        # a splice ABOVE the rollback point was unwound with it: the range's
        # copied-in state is gone from the MVCC map and the splice is not in
        # any log, so no version of it is locally readable until the
        # distributor re-fetches (its move reply failed with the recovery,
        # so it will). Raise the watermark to the sentinel; a new _add_shard
        # splice narrows it back out.
        if self._watermarks:
            self._watermarks = [
                (b, e, v if v <= rollback_to else _WM_INFINITE)
                for b, e, v in self._watermarks]
        self._native_plane_update()
        while self._pending_durable and self._pending_durable[-1][0] > rollback_to:
            self._pending_durable.pop()
        # rewind the pull cursor so the new epoch's re-delivered mutations in
        # (rollback_to, old_version] are fetched; self.version stays monotone
        # (the master allocates the new epoch's first version above any version
        # a storage server can have seen, masterserver.actor.cpp:858 bump)
        self._peek_begin = rollback_to
        self.log_epochs = req.epochs
        reply.send(None)

    def _epoch_for(self, version: int) -> LogEpoch:
        """The generation serving `version`: epoch covers (begin, end]."""
        for ep in self.log_epochs:
            if version > ep.begin and (ep.end is None or version <= ep.end):
                return ep
        return self.log_epochs[-1]

    # -- data distribution (metrics + fetchKeys) --

    def _on_get_metrics(self, req: GetStorageMetricsRequest, reply):
        """Byte counts + split candidate per range (the byte-sampling feed
        for shardSplitter, storageserver byteSampleApplySet :2992): exact
        counts in O(log n) from the engine's sum-augmented IndexedSet when
        the engine exposes it (memory engine), full scan otherwise (ssd)."""
        out = []
        for b, e in req.ranges:
            hi = e if e is not None else b"\xff" * 40
            if hasattr(self.store, "bytes_range"):
                _n, total = self.store.bytes_range(b, hi)
                split = self.store.split_key(b, hi)
            else:
                rows = self.store.get_range(b, hi)
                total = sum(len(k) + len(v) for k, v in rows)
                split = rows[len(rows) // 2][0] if len(rows) >= 4 else None
                if split == b:
                    split = None  # a split at the begin boundary is no split
            out.append(ShardMetrics(bytes=total, split_key=split))
        reply.send(out)

    def _on_set_shards(self, req: SetShardsRequest, reply):
        lv = getattr(req, "layout_version", None)
        if lv is not None:
            if self._layout_version is not None and lv < self._layout_version:
                reply.send(None)  # clog-delayed stale push: ignore
                return
            self._layout_version = lv
        self.shard_ranges = [tuple(r) for r in req.shard_ranges]
        # the authoritative layout has landed: a revocation whose range the
        # layout no longer lists is now enforced by the ownership check
        # itself, so drop it. Same for one fenced at/below as_of_version —
        # this layout already accounts for that move (a revocation can
        # over-cover: the server fences from its own coarse served range,
        # not the moved shard's exact bounds, so the listed remainder must
        # lift here or it would bounce reads forever). One fenced ABOVE
        # as_of_version that still overlaps a listed range stays: that is
        # a delayed stale push, and only a re-adding fetch (_add_shard,
        # which re-copies the data) may lift a newer fence.
        if self._revoked:
            av = getattr(req, "as_of_version", None)
            self._revoked = [
                (b, e, v) for b, e, v in self._revoked
                if (av is None or v > av)
                and any((e is None or sb < e) and (se is None or b < se)
                        for sb, se in self.shard_ranges)]
        self._native_plane_update()  # sharded now: the C plane stands down
        reply.send(None)

    def _on_add_shard(self, req: AddShardRequest, reply):
        # a shard is being moved onto this server: from here on, ownership
        # is per-range and the C fast path must not answer anything
        self._native_plane_blocked = True
        self._native_plane_update()
        self.process.spawn(self._add_shard(req, reply), "fetchKeys")

    async def _add_shard(self, req: AddShardRequest, reply):
        """fetchKeys (:1775), simplified to a stop-the-world splice:

        By the fence, every mutation with version > fence is also routed to
        this server's tag, so: pause ingestion at applied version C0 >= the
        point where this request could arrive, snapshot [begin, end) at C0
        from the source (which keeps receiving the range's mutations until
        the handoff completes), replace the range's contents at C0, extend
        the served ranges, resume. Mutations in (fence, C0] that were already
        applied from the log are subsumed by the snapshot (the source applied
        them too); mutations > C0 arrive through the log as usual. The
        reference fetches concurrently with buffered mutations (AddingShard)
        instead of pausing — an optimization, not a correctness difference.
        """
        from foundationdb_tpu_torch.core.future import Future
        if ((req.begin, req.end) in (self.shard_ranges or [])
                and req.fence_version <= self._shard_fences.get(
                    (req.begin, req.end), -1)):
            reply.send(self.version.get())  # retry of the SAME move: done
            return
        if self._ingest_gate is not None:
            # one splice at a time: a second concurrent fetch would clobber
            # the ingestion gate and apply its snapshot below already-applied
            # versions. The distributor just retries next round.
            reply.send_error(FDBError("operation_failed",
                                      "fetchKeys already in progress"))
            return
        # catch up to the fence FIRST (ingestion must still be running):
        # mutations at versions <= fence may have been routed only to the
        # old team, so a snapshot below the fence would miss them here
        try:
            await self.version.when_at_least(req.fence_version)
        except FDBError as e:
            # displaced/cancelled while parked on the fence: settle before
            # dying, or the data distributor's move waits out the full RPC
            # timeout before retrying (protolint PROTO002)
            settle_failed(reply, e)
            raise
        if self._ingest_gate is not None:
            # a second splice started while we awaited the fence; taking over
            # its gate/idle futures would strand it forever — retry next round
            reply.send_error(FDBError("operation_failed",
                                      "fetchKeys already in progress"))
            return
        gate = Future()
        self._ingest_gate = gate
        # Handshake: wait until the update loop has actually PARKED on the
        # gate. A peek already in flight when the gate was set would otherwise
        # apply versions > c0 after the snapshot version is read, tripping
        # VersionedMap's version-order guard and failing the splice round
        # after round under sustained write load (a DD liveness defect). The
        # loop signals idle at its top and discards any reply that raced the
        # gate, so once idle resolves no version can advance until the gate
        # lifts.
        self._ingest_idle = Future()
        rc0 = self.recovery_count
        try:
            await self._ingest_idle
            c0 = self.version.get()
            end = req.end if req.end is not None else b"\xff" * 40
            rows: list[tuple[bytes, bytes]] = []
            cursor = req.begin
            while True:
                r = await self.process.net.request(
                    self.process, Endpoint(req.source, Token.STORAGE_GET_KEY_VALUES),
                    GetKeyValuesRequest(
                        begin=KeySelector.first_greater_or_equal(cursor),
                        end=KeySelector.first_greater_or_equal(end),
                        version=c0))
                rows.extend(r.data)
                if not (r.more and r.data):
                    break
                cursor = r.data[-1][0] + b"\x00"
            # splice: exact range state at C0 (clear first: a key this
            # server saw via the log but the source has since cleared must
            # not survive). Durability goes through _pending_durable so the
            # engine applies it IN VERSION ORDER relative to everything
            # already queued below C0.
            muts = [Mutation(MutationType.CLEAR_RANGE, req.begin, end)]
            muts += [Mutation(MutationType.SET_VALUE, k, v) for k, v in rows]
            if self.recovery_count != rc0:
                # a recovery rollback landed mid-splice (the SetLogSystem
                # handler is synchronous and bypasses the gate): the snapshot
                # at c0 may include rolled-back versions, and applying it
                # would put data/_pending_durable out of version order with
                # the rewound pull cursor. Abort; the distributor retries.
                raise FDBError("operation_failed",
                               "recovery rollback during fetchKeys splice")
            # the parked loop is the only writer, so this must still hold:
            assert self.version.get() == c0, \
                "ingestion advanced during a fetchKeys splice"
            for m in muts:
                self.data.apply(c0, m)
            self._pending_durable.append((c0, muts))
            if (req.begin, req.end) not in (self.shard_ranges or []):
                self.shard_ranges = (self.shard_ranges or []) + [(req.begin,
                                                                  req.end)]
            self._shard_fences[(req.begin, req.end)] = req.fence_version
            # the splice re-copied this range's data at c0, so any standing
            # revocation is obsolete exactly over [begin, end) — a range
            # that moved away and back must serve again, not bounce reads
            # on the stale fence. Overlaps are NARROWED, not dropped: a
            # remainder outside the fetch was not re-copied and stays fenced.
            if self._revoked:
                kept: list[tuple[bytes, bytes | None, int]] = []
                for b, e, v in self._revoked:
                    if ((e is not None and e <= req.begin)
                            or (req.end is not None and b >= req.end)):
                        kept.append((b, e, v))
                        continue
                    if b < req.begin:
                        kept.append((b, req.begin, v))
                    if req.end is not None and (e is None or req.end < e):
                        kept.append((req.end, e, v))
                self._revoked = kept
            # record the fetched-version watermark: this range's local
            # history starts at c0. Older overlapping watermarks are
            # narrowed the same way as revocations (the re-copy supersedes
            # them exactly over [begin, end)) before the new one lands.
            if self._watermarks:
                kept_wm: list[tuple[bytes, bytes | None, int]] = []
                for b, e, v in self._watermarks:
                    if ((e is not None and e <= req.begin)
                            or (req.end is not None and b >= req.end)):
                        kept_wm.append((b, e, v))
                        continue
                    if b < req.begin:
                        kept_wm.append((b, req.begin, v))
                    if req.end is not None and (e is None or req.end < e):
                        kept_wm.append((req.end, e, v))
                self._watermarks = kept_wm
            self._watermarks.append((req.begin, req.end, c0))
            if self._read_cache is not None:
                # the splice wrote history outside the update loop's
                # invalidation pass; tags can no longer prove exactness
                self._read_cache.clear()
            reply.send(c0)
        except FDBError as e:
            reply.send_error(e)
        finally:
            self._ingest_gate = None
            self._ingest_idle = None
            gate._set(None)

    # -- ingestion (update :2358 + updateStorage :2633) --

    async def _update_loop(self):
        loop = self.process.net.loop
        while True:
            if self._ingest_gate is not None:
                # fetchKeys splice in progress: tell it we are parked (no
                # apply can happen until the gate lifts), then wait
                if self._ingest_idle is not None and not self._ingest_idle.is_ready():
                    self._ingest_idle._set(None)
                await self._ingest_gate
            recovery_count = self.recovery_count
            # the cursor owns epoch routing + replica failover
            # (IPeekCursor / LogSystemPeekCursor) and re-reads this server's
            # live epochs/begin on every attempt via its refresh callable;
            # cancellation propagates so a killed server's loop dies instead
            # of zombieing
            epoch, reply = await self._cursor.get_more()
            if reply is None:
                continue  # interrupted: re-park on the fetchKeys gate
            if self.recovery_count != recovery_count:
                # a rollback/rebind landed while this peek was in flight; the
                # reply may carry the dead epoch's never-acked versions
                continue
            if self._ingest_gate is not None:
                # a fetchKeys splice began while this peek was in flight:
                # applying the reply now would advance versions past the
                # splice's snapshot point. Discard (nothing was advanced;
                # the range is re-peeked after the gate) and park at the top.
                continue
            self._known_committed = max(self._known_committed,
                                        reply.known_committed_version)
            for version, muts in reply.messages:
                if version <= self._peek_begin:
                    continue
                if epoch.end is not None and version > epoch.end:
                    break  # next iteration peeks the successor epoch
                for m in muts:
                    self.data.apply(version, m)
                    if m.param1 >= _KS_PREFIX:
                        self._apply_shard_private(m, version)
                rc = self._read_cache
                if rc is not None and rc.entries:
                    # same tick as apply: an entry that survives has
                    # provably seen no mutation since its version tag
                    rc.invalidate(muts)
                self._c_mutations.increment(len(muts))
                self._pending_durable.append((version, muts))
                self._peek_begin = version
                if version > self.version.get():
                    self.version.set(version)
                self._trigger_watches(version)
            # advance through empty version ranges, clamped to this epoch
            end_v = reply.end - 1
            if epoch.end is not None:
                end_v = min(end_v, epoch.end)
            if end_v > self._peek_begin:
                self._peek_begin = end_v
                if end_v > self.version.get():
                    self.version.set(end_v)
                    self.data.latest_version = max(self.data.latest_version, end_v)
                    self._trigger_watches(end_v)
            self._native_plane_update()
            await self._advance_durability()

    async def _redwood_maintenance_loop(self):
        """Background flush/compaction driver for the redwood engine: plan
        on-loop, build off-loop (run_blocking — pure CPU + reads of
        immutable files, the resolver's drain-off-the-loop idiom), install
        on-loop. Under sim run_blocking executes inline, so the sequence is
        deterministic; under the real loop only the cheap install blocks."""
        loop = self.process.net.loop
        while True:
            # plan/apply mutate engine structures shared with commit's WAL
            # push — hold off while a commit thread is in flight (real loop
            # only; the build overlap below is fine, it's pure)
            while self._commit_inflight:
                await loop.delay(0.01)
            plan = self.store.plan_maintenance()
            if plan is None:
                await loop.delay(KNOBS.REDWOOD_MAINT_INTERVAL)
                continue
            image = await loop.run_blocking(plan.build)
            while self._commit_inflight:
                await loop.delay(0.01)
            self.store.apply_maintenance(plan, image)

    async def _advance_durability(self):
        """updateStorage (:2633): write mutations leaving the MVCC window to
        the durable engine, commit, then forget them from memory and pop the
        TLog — pop strictly after the engine commit, so a crash between the
        two only re-applies (idempotent) mutations."""
        # derive from the pull cursor, not self.version: after a rollback the
        # monotone version can exceed what has been re-fetched, and durability
        # (and TLog pops!) must never pass unfetched mutations. Clamp by the
        # known-committed version: a single TLog's peeks advance the cursor
        # through versions that were never fully acked, and making those
        # durable would be unrecoverable when a recovery rolls them back
        # (acked commits <= known_committed <= recovery_version).
        target = min(self._peek_begin - KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS,
                     self._known_committed)
        if target <= self.durable_version:
            return
        rounds = []
        while self._pending_durable and self._pending_durable[0][0] <= target:
            rounds.append(self._pending_durable.popleft())
        prefetch = self._prefetch_atomic_reads(rounds)
        for _v, muts in rounds:
            for m in muts:
                self._apply_durable(m, prefetch)
        self.durable_version = target
        self.store.set_metadata(_DURABLE_VERSION_KEY, str(target).encode())
        # the engine commit runs OFF the loop (run_blocking; inline under
        # sim, a worker thread under the real loop) so an fsync or sqlite
        # COMMIT can't stall every read on this process. The await window is
        # safe: target <= _known_committed <= any recovery version, so
        # nothing at or below `target` can be rolled back mid-commit, reads
        # go through the MVCC map (not the engine), and only this actor
        # mutates the engine. forget/pop stay AFTER the awaited commit —
        # the crash-ordering argument above needs the commit durable first.
        self._commit_inflight = True
        try:
            await self.process.net.loop.run_blocking(self.store.commit)
        finally:
            self._commit_inflight = False
        self.data.forget_before(target)
        # watermarks at/below the MVCC floor can never fire again — any
        # version they would reject already throws transaction_too_old
        if self._watermarks:
            self._watermarks = [(b, e, v) for b, e, v in self._watermarks
                                if v > self.data.oldest_version]
        self._native_plane_update()  # oldest bound moved: push before serving
        popped: set[tuple[str, str]] = set()
        for epoch in self.log_epochs:
            for i, addr in enumerate(epoch.addrs):
                uid = epoch.uid_of(i)
                if (addr, uid) in popped:
                    continue
                popped.add((addr, uid))
                self.process.net.one_way(
                    self.process, Endpoint(addr, Token.TLOG_POP),
                    TLogPopRequest(tag=self.tag, version=target, uid=uid))
        # prune fully-drained generations (the reference discards a log
        # generation once every tag is popped past its end) — bounds the pop
        # fan-out as recoveries accumulate; pruned after this round's pop so
        # each drained generation gets its final pop
        if len(self.log_epochs) > 1:
            self.log_epochs = [ep for ep in self.log_epochs
                               if ep.end is None or ep.end > target]

    def _prefetch_atomic_reads(self, rounds) -> dict[bytes, bytes | None]:
        """Batch the engine reads the atomic ops in this durability window
        will do: a first-touch atomic (no earlier mutation in the window
        wrote or cleared its key) reads the pre-window engine value, so all
        such keys are fetched in ONE engine call (redwood: one Python->C
        hop across every run) instead of a per-key get() inside
        _apply_durable. Later-touch atomics must see in-window state and
        keep the per-key read. The fetch is wrapped in a Storage.EngineRead
        span so trace_analyze can break out engine residency."""
        from foundationdb_tpu_torch.utils.types import ATOMIC_OPS
        get_batch = getattr(self.store, "get_batch", None)
        if get_batch is None:
            return {}
        touched: set[bytes] = set()
        cleared: list[tuple[bytes, bytes]] = []
        keys: list[bytes] = []
        for _v, muts in rounds:
            for m in muts:
                if m.type in ATOMIC_OPS and m.param1 not in touched \
                        and not any(b <= m.param1 < e for b, e in cleared):
                    keys.append(m.param1)
                if m.type == MutationType.CLEAR_RANGE:
                    cleared.append((m.param1, m.param2))
                else:
                    touched.add(m.param1)
        if not keys:
            return {}
        from foundationdb_tpu_torch.utils.trace import g_trace_batch
        loop = self.process.net.loop
        ident = f"sv{self.durable_version}"
        g_trace_batch.span_begin("StorageSpan", ident, "Storage.EngineRead",
                                 at=loop.now())
        vals = get_batch(keys)
        g_trace_batch.span_end("StorageSpan", ident, "Storage.EngineRead",
                               at=loop.now())
        return dict(zip(keys, vals))

    def _apply_durable(self, m, prefetch=None):
        from foundationdb_tpu_torch.utils.types import ATOMIC_OPS, apply_atomic_op
        if m.type == MutationType.SET_VALUE:
            self.store.set(m.param1, m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            self.store.clear_range(m.param1, m.param2)
        elif m.type in ATOMIC_OPS:
            # pop, not get: the prefetched value is the pre-window engine
            # state and is only valid for the FIRST touch of the key
            if prefetch is not None and m.param1 in prefetch:
                existing = prefetch.pop(m.param1)
            else:
                existing = self.store.get(m.param1)
            self.store.set(m.param1,
                           apply_atomic_op(m.type, existing, m.param2))

    # -- reads --

    def _on_queue_stats(self, req, reply):
        """StorageQueuingMetrics for the ratekeeper: durability lag."""
        from foundationdb_tpu_torch.server.ratekeeper import QueueStatsReply
        reply.send(QueueStatsReply(
            lag_versions=self.version.get() - self.durable_version))

    def _owns_key(self, key: bytes) -> bool:
        if self.shard_ranges is None:
            return True
        return any(b <= key and (e is None or key < e)
                   for b, e in self.shard_ranges)

    def _apply_shard_private(self, m: Mutation, version: int):
        """A keyServers mutation arriving in this server's OWN tag stream
        (the proxy broadcasts them to every storage tag — the reference's
        private serverKeys mutations, ApplyMetadataMutation.h). If the new
        team excludes this tag, the served range containing the shard point
        is REVOKED from `version` on: any read at a read version >= it gets
        wrong_shard_server instead of a quietly stale answer. The version
        stream is the only race-free channel for this — mutations stop
        flowing here at exactly the move's commit version, while the
        authoritative SET_SHARDS layout push races in-flight reads. The
        revocation is cleared when that push (or a re-adding fetch) lands."""
        if (m.type != MutationType.SET_VALUE or self.shard_ranges is None
                or not m.param1.startswith(_KS_PREFIX)):
            return
        from foundationdb_tpu_torch.server import systemdata
        if self.tag in systemdata.decode_tags(m.param2):
            return
        point = m.param1[len(_KS_PREFIX):]
        for b, e in self.shard_ranges:
            if b <= point and (e is None or point < e):
                # only [point, e) moved: a split at `point` keeps [b, point)
                # here, and fencing the kept half would bounce its reads
                # until the layout push lands
                self._revoked.append((max(b, point), e, version))

    def _below_watermark(self, begin: bytes, end: bytes | None,
                         version: int) -> bool:
        """True when [begin, end) overlaps a range whose local history
        starts ABOVE `version` — the read must get wrong_shard_server so
        the client re-resolves onto a replica that has the history (this
        server's pre-splice state for the range is empty or stale)."""
        for b, e, v in self._watermarks:
            if (version < v and (e is None or begin < e)
                    and (end is None or b < end)):
                self._c_wm_rejects.increment()
                return True
        return False

    def _revoked_read(self, begin: bytes, end: bytes | None,
                      version: int) -> bool:
        """True when [begin, end) overlaps a range revoked at/below
        `version` — the read must get wrong_shard_server (the client
        re-resolves through the published layout and retries)."""
        for b, e, v in self._revoked:
            if (version >= v and (e is None or begin < e)
                    and (end is None or b < end)):
                return True
        return False

    def _owns_range(self, begin: bytes, end: bytes) -> bool:
        """A request is in-shard when the UNION of contiguous served entries
        covers it — after a layout merge a client legitimately reads across
        a former boundary between two entries this server holds."""
        if self.shard_ranges is None:
            return True
        cur = begin
        for b, e in sorted(self.shard_ranges):
            if b <= cur and (e is None or cur < e):
                if e is None or end <= e:
                    return True
                cur = e  # contiguous continuation may cover the rest
        return False

    async def _wait_for_version(self, version: int) -> None:
        """waitForVersion (:654): too-new reads wait (bounded), dead reads throw.

        A catch-up timeout surfaces as retryable future_version (the reference
        throws future_version after FUTURE_VERSION_DELAY), not timed_out.
        """
        if version > self.version.get() + KNOBS.MAX_VERSIONS_IN_FLIGHT:
            raise FDBError("future_version")
        if version > self.version.get():
            loop = self.process.net.loop
            try:
                await loop.timeout(self.version.when_at_least(version), 5.0)
            except FDBError as e:
                if e.name == "timed_out":
                    raise FDBError("future_version") from None
                raise
        if version < self.data.oldest_version:
            raise FDBError("transaction_too_old")

    def _on_get_value(self, req: GetValueRequest, reply):
        self.process.spawn(self._get_value(req, reply), "getValueQ")

    async def _get_value(self, req: GetValueRequest, reply):
        self._c_point_reads.increment()
        try:
            if not self._owns_key(req.key):
                raise FDBError("wrong_shard_server")
            await self._wait_for_version(req.version)
            if self._revoked and self._revoked_read(
                    req.key, req.key + b"\x00", req.version):
                raise FDBError("wrong_shard_server")
            if self._watermarks and self._below_watermark(
                    req.key, req.key + b"\x00", req.version):
                raise FDBError("wrong_shard_server")
            rc = self._read_cache
            if rc is not None:
                rc.note_reads(req.key, 1, self.process.net.loop.now())
                hit, value = rc.lookup(req.key, req.version)
                if hit:
                    reply.send(GetValueReply(value=value,
                                             version=req.version))
                    return
            value = self.data.get(req.key, req.version)
            if rc is not None and rc.hot_ranges and rc.is_hot(req.key):
                self._cache_populate(rc, req.key, value, req.version)
            reply.send(GetValueReply(value=value, version=req.version))
        except FDBError as e:
            reply.send_error(e)

    def _cache_populate(self, rc, key: bytes, value, read_version: int):
        """Tag with the LATEST applied version (re-reading the value there
        if the read was behind it) — tagging at the read version would let
        a mutation already applied in (read_version, latest] mint stale
        hits. Same event-loop tick as the MVCC read, so no mutation can
        slip between the re-read and the insert."""
        cur = self.version.get()
        if read_version != cur:
            value = self.data.get(key, cur)
        rc.populate(key, value, cur)

    def _on_get_values(self, req, reply):
        self.process.spawn(self._get_values(req, reply), "getValues")

    async def _get_values(self, req, reply):
        """Batched point reads (STORAGE_GET_VALUES): one version wait for
        the whole batch, per-key MVCC lookups, per-key errors in the reply
        so one moved key doesn't fail its neighbors.

        When this server owns everything (serve_all) the whole batch is one
        call into the versioned map — and for a remote caller
        (reply.wants_bytes) the C store serializes the GetValuesReply frame
        itself, so the reply never exists as per-KV Python objects."""
        from foundationdb_tpu_torch.server.interfaces import GetValuesReply
        self._c_batch_reads.increment(len(req.reads))
        try:
            await self._wait_for_version(max(v for _k, v in req.reads))
        except FDBError as e:
            reply.send_error(e)  # retryable as a unit (future_version etc.)
            return
        data = self.data
        rc = self._read_cache
        if rc is not None and req.reads:
            rc.note_reads(req.reads[0][0], len(req.reads),
                          self.process.net.loop.now())
        if self.shard_ranges is None:
            if rc is not None and (rc.entries or rc.hot_ranges):
                # hot-cache engaged: per-key probes beat the batch walk for
                # a skewed mix; the cold path below stays byte-identical
                reply.send(GetValuesReply(
                    results=self._get_values_cached(rc, req.reads)))
                return
            if getattr(reply, "wants_bytes", False):
                encode = getattr(data, "get_batch_encoded", None)
                if encode is not None:
                    reply.send(wire.PreEncoded(encode(req.reads)))
                    return
            reply.send(GetValuesReply(results=data.get_batch(req.reads)))
            return
        # sharded: per-key ownership checks need the shard map, so stay in
        # Python (data movement traffic, not the merged-topology hot path)
        oldest = data.oldest_version
        out = []
        for k, v in req.reads:
            if (not self._owns_key(k)
                    or (self._revoked
                        and self._revoked_read(k, k + b"\x00", v))
                    or (self._watermarks
                        and self._below_watermark(k, k + b"\x00", v))):
                out.append((1, "wrong_shard_server"))
            elif v < oldest:
                out.append((1, "transaction_too_old"))
            else:
                if rc is not None:
                    hit, value = rc.lookup(k, v)
                    if not hit:
                        value = data.get(k, v)
                        if rc.hot_ranges and rc.is_hot(k):
                            self._cache_populate(rc, k, value, v)
                else:
                    value = data.get(k, v)
                out.append((0, value))
        reply.send(GetValuesReply(results=out))

    def _get_values_cached(self, rc, reads):
        """Serve-all batch with the hot cache engaged: hits come from one
        dict probe; misses fall through to the MVCC map and (if hot)
        populate for the next read."""
        data = self.data
        out = []
        for k, v in reads:
            hit, value = rc.lookup(k, v)
            if not hit:
                value = data.get(k, v)
                if rc.hot_ranges and rc.is_hot(k):
                    self._cache_populate(rc, k, value, v)
            out.append((0, value))
        return out

    # selector resolution (storageserver.actor.cpp findKey) — lives on the
    # versioned map so the C store resolves without per-key Python hops
    def _resolve_selector(self, sel: KeySelector, version: int) -> bytes:
        """Resolve to a live key (or b'' / \\xff end sentinels)."""
        return self.data.resolve_selector(sel, version)

    def _on_get_key_values(self, req: GetKeyValuesRequest, reply):
        self.process.spawn(self._get_key_values(req, reply), "getKeyValues")

    async def _get_key_values(self, req: GetKeyValuesRequest, reply):
        self._c_range_reads.increment()
        try:
            if not self._owns_range(req.begin.key, req.end.key):
                raise FDBError("wrong_shard_server")
            await self._wait_for_version(req.version)
            if self._revoked and self._revoked_read(
                    req.begin.key, req.end.key, req.version):
                raise FDBError("wrong_shard_server")
            if self._watermarks and self._below_watermark(
                    req.begin.key, req.end.key, req.version):
                raise FDBError("wrong_shard_server")
            begin = self._resolve_selector(req.begin, req.version)
            end = self._resolve_selector(req.end, req.version)
            if end < begin:
                end = begin
            limit_bytes = req.limit_bytes or KNOBS.DESIRED_TOTAL_BYTES
            if getattr(reply, "wants_bytes", False):
                encode = getattr(self.data, "range_read_encoded", None)
                if encode is not None:
                    # remote caller: the C store scans AND serializes the
                    # GetKeyValuesReply in one pass
                    reply.send(wire.PreEncoded(encode(
                        begin, end, req.version, req.limit, limit_bytes,
                        req.reverse)))
                    return
            data, more = self.data.range_read(
                begin, end, req.version, limit=req.limit,
                limit_bytes=limit_bytes, reverse=req.reverse)
            reply.send(GetKeyValuesReply(data=data, more=more, version=req.version))
        except FDBError as e:
            reply.send_error(e)

    # -- watches (watchValueQ :842) --

    def _on_watch(self, req: WatchValueRequest, reply):
        self.process.spawn(self._watch(req, reply), "watchValue")

    async def _watch(self, req: WatchValueRequest, reply):
        self._c_watches.increment()
        try:
            if not self._owns_key(req.key):
                raise FDBError("wrong_shard_server")
            await self._wait_for_version(req.version)
            if self._revoked and self._revoked_read(
                    req.key, req.key + b"\x00", req.version):
                raise FDBError("wrong_shard_server")
            if self._watermarks and self._below_watermark(
                    req.key, req.key + b"\x00", req.version):
                raise FDBError("wrong_shard_server")
            current = self.data.get(req.key, self.version.get())
            if current != req.value:
                reply.send(self.version.get())
                return
            self._watches.append((req, reply))
        except FDBError as e:
            reply.send_error(e)

    def _trigger_watches(self, version: int):
        if not self._watches:
            return
        keep = []
        for req, reply in self._watches:
            current = self.data.get(req.key, version)
            if current != req.value:
                reply.send(version)
            else:
                keep.append((req, reply))
        self._watches = keep
