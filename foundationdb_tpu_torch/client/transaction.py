"""Transaction: the client API with read-your-writes and retry semantics.

Reference: fdbclient/NativeAPI.actor.cpp Transaction (get :1869, getRange
:1989, set :2072, clear :2116, atomicOp :2090, watch :1923, commit :2580,
onError :2180) merged with the ReadYourWrites overlay
(fdbclient/ReadYourWrites.actor.cpp) the bindings actually use: reads see
uncommitted writes, and precise read conflict ranges accumulate as reads
happen (snapshot reads skip them).

All methods are actors on the framework event loop (await our Futures).
"""

from __future__ import annotations

from foundationdb_tpu_torch.client.writemap import WriteMap
from foundationdb_tpu_torch.core.future import Future, all_of
from foundationdb_tpu_torch.server.interfaces import (
    CommitTransactionRequest, GetKeyValuesRequest, GetReadVersionRequest,
    KeySelector, Token, WatchValueRequest)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.types import (
    ATOMIC_OPS, MutationType, mutations_weight)


class Transaction:
    def __init__(self, db):
        self.db = db
        # options survive reset() like the reference's persistent defaults
        # (fdb.options: timeout/retry_limit/size_limit "persist across
        # resets" from API 610 on)
        self._opt_timeout_ms: int | None = None
        self._opt_retry_limit: int | None = None
        self._opt_size_limit: int | None = None
        self._retries = 0
        self.reset()

    def set_option(self, option, param=None):
        """fdb_transaction_set_option: options come from the generated
        surface (utils/fdboptions.TransactionOption) or raw codes."""
        code = int(option)
        if code == 500:  # timeout (ms)
            self._opt_timeout_ms = int.from_bytes(param, "little") \
                if isinstance(param, (bytes, bytearray)) else int(param)
        elif code == 501:  # retry_limit
            self._opt_retry_limit = int.from_bytes(param, "little") \
                if isinstance(param, (bytes, bytearray)) else int(param)
        elif code == 503:  # size_limit
            self._opt_size_limit = int.from_bytes(param, "little") \
                if isinstance(param, (bytes, bytearray)) else int(param)
        else:
            from foundationdb_tpu_torch.utils.fdboptions import (
                transaction_option_by_code)
            if code not in transaction_option_by_code:
                raise FDBError("invalid_option_value", f"unknown option {code}")
            # known but advisory here (risky reads, system-keys gates, trace
            # identifiers): accepted for API compatibility

    def _deadline_guard(self, fut):
        """Wrap an awaited future with the transaction's timeout option
        (NativeAPI: timed-out transactions raise transaction_timed_out,
        surfaced here as the retryable timed_out). Applied to EVERY
        operation — GRV, reads, range reads, watches, commit — matching the
        reference, where option 500 bounds the whole transaction, not just
        its write path."""
        if self._opt_timeout_ms is None:
            return fut
        return self.db.loop.timeout(fut, self._opt_timeout_ms / 1000.0)

    def reset(self):
        self._writes = WriteMap()
        self._read_conflicts: list[tuple[bytes, bytes]] = []
        # point-read conflicts stay as bare keys until commit: the read path
        # is the client's hottest loop and the (key, key+\x00) range tuples
        # are only needed by writing transactions
        self._read_conflict_keys: list[bytes] = []
        self._extra_write_conflicts: list[tuple[bytes, bytes]] = []
        self._read_version: int | None = None
        self._rv_future = None
        self._committed_version: int | None = None
        self._backoff = KNOBS.DEFAULT_BACKOFF
        self._committing = False
        self._key_limit = KNOBS.KEY_SIZE_LIMIT
        self._value_limit = KNOBS.VALUE_SIZE_LIMIT

    # -- read version --

    async def get_read_version(self) -> int:
        if self._read_version is None:
            reply = await self._deadline_guard(self.db._grv())
            self._read_version = reply.version
        return self._read_version

    def set_read_version(self, version: int):
        self._read_version = version

    # -- reads --

    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        self._check_key(key)
        has_point, point, cleared = self._writes.lookup(key)
        if has_point and point.known:
            return point.value  # fully client-determined
        if cleared:
            return None
        version = await self.get_read_version()
        base = await self._deadline_guard(self.db._read_get(key, version))
        if not snapshot:
            self._read_conflict_keys.append(key)
        if has_point:
            return point.resolve(base)  # pending atomic ops over storage value
        return base

    def get_future(self, key: bytes, snapshot: bool = False):
        """Future-shaped point read — the reference's actual client API
        (fdb_transaction_get returns an FDBFuture; NativeAPI Transaction::get
        returns Future<Optional<Value>>, NativeAPI.actor.cpp:1869). No actor
        is spawned per read: the request goes straight into the database's
        read batcher and the returned Future resolves to the value. This is
        what lets a client issue a transaction's reads concurrently at
        reference-like per-op cost; `get` remains the awaitable convenience
        wrapper. Every branch here is hand-flattened: this function is the
        single hottest client frame under the e2e read bench."""
        if len(key) > self._key_limit:
            raise FDBError("key_too_large")
        w = self._writes
        if w.mutations:
            has_point, point, cleared = w.lookup(key)
            if has_point and point.known:
                out = Future()
                out._set(point.value)
                return out
            if cleared:
                out = Future()
                out._set(None)
                return out
        else:  # no overlay (the common read-mostly case): skip the lookup
            has_point = False
            point = None
        if self._read_version is None:
            if w.mutations:
                # overlay atop an unfetched GRV: the coroutine path merges
                # pending atomic ops correctly; rare enough to spawn
                return self.db.loop.spawn(self.get(key, snapshot), "get")
            # no read version yet: fetch the GRV once and chain the read
            # off its callback — no per-key coroutine in between, so the
            # value future still settles in the tick its reply frame lands
            if not snapshot:
                self._read_conflict_keys.append(key)
            return self._chain_grv_read(
                lambda: self.db._read_get(key, self._read_version))
        inner = self.db._read_get(key, self._read_version)
        if self._opt_timeout_ms is not None:
            inner = self.db.loop.timeout(inner, self._opt_timeout_ms / 1000.0)
        if not snapshot:
            self._read_conflict_keys.append(key)
        if not has_point:
            return inner  # the batcher's future IS the result future
        out = Future()

        def relay(f):
            # direct settle from the batcher future's callback: when the
            # native client plane settles the batch from a reply frame,
            # this fires in the same tick — no scheduled second relay
            if out.is_ready():
                return
            if f.is_error():
                out._set_error(f._result)
            else:
                out._set(point.resolve(f._result))
        inner.add_callback(relay)
        return out

    def _chain_grv_read(self, issue) -> Future:
        """GRV-then-read as a callback chain: fetch the batched read
        version, and from ITS settle callback enqueue the read built by
        `issue()` (which sees self._read_version) and relay the result —
        the no-coroutine composition of get_read_version + read batcher
        that get_future/get_many use when no read version is set yet."""
        out = Future()
        grvf = self._deadline_guard(self.db._grv())

        def relay(f):
            if out.is_ready():
                return
            if f.is_error():
                out._set_error(f._result)
            else:
                out._set(f._result)

        def on_grv(g):
            if out.is_ready():
                return
            if g.is_error():
                out._set_error(g._result)
                return
            if self._read_version is None:
                self._read_version = g._result.version
            inner = issue()
            if self._opt_timeout_ms is not None:
                inner = self.db.loop.timeout(
                    inner, self._opt_timeout_ms / 1000.0)
            inner.add_callback(relay)

        grvf.add_callback(on_grv)
        return out

    def get_many(self, keys, snapshot: bool = False):
        """Future of the list of values for `keys` (order preserved) — a
        transaction-level multiget. Equivalent to awaiting all_of over
        per-key get_future calls, but the common case (no uncommitted-write
        overlay, read version known) rides the database's read batcher as
        ONE queue entry resolving ONE future, so a read transaction's
        client-side cost no longer scales with per-key future machinery."""
        w = self._writes
        if w.mutations:
            # overlay merge needed: compose the per-key path
            return all_of([self.get_future(k, snapshot) for k in keys])
        limit = self._key_limit
        for k in keys:
            if len(k) > limit:
                raise FDBError("key_too_large")
        if self._read_version is None:
            # GRV fetch needed: one chained fetch for the whole multiget,
            # not a per-key coroutine fan-out
            keys = list(keys)
            if not snapshot:
                self._read_conflict_keys.extend(keys)
            return self._chain_grv_read(
                lambda: self.db._read_get_many(keys, self._read_version))
        inner = self.db._read_get_many(keys, self._read_version)
        if self._opt_timeout_ms is not None:
            inner = self.db.loop.timeout(inner, self._opt_timeout_ms / 1000.0)
        if not snapshot:
            self._read_conflict_keys.extend(keys)
        return inner

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a key selector (NativeAPI getKey). RYW-merged via a
        range read of plain byte bounds (avoids selector-end exclusivity)."""
        sel = selector
        if sel.offset >= 1:
            begin = sel.key + (b"\x00" if sel.or_equal else b"")
            # user selectors stop at \xff; selectors whose base is already in
            # the system keyspace may walk to its end \xff\xff (the
            # reference clamps getKey to the legal range — system rows are
            # stored like normal data and must not leak into user scans)
            scan_end = b"\xff\xff" if sel.key >= b"\xff" else b"\xff"
            data = await self.get_range(begin, scan_end, limit=sel.offset,
                                        snapshot=snapshot)
            if len(data) >= sel.offset:
                return data[sel.offset - 1][0]
            return scan_end
        nth = 1 - sel.offset
        end = sel.key + (b"\x00" if sel.or_equal else b"")
        data = await self.get_range(b"", end, limit=nth, reverse=True,
                                    snapshot=snapshot)
        if len(data) >= nth:
            return data[nth - 1][0]
        return b""

    async def get_range(self, begin, end, limit: int = 0, reverse: bool = False,
                        snapshot: bool = False) -> list[tuple[bytes, bytes]]:
        """Range read, RYW-merged. begin/end may be bytes or KeySelectors.

        Non-canonical selectors resolve against the merged view first (the
        reference's RYW layer resolves selectors over RYWIterator); the body
        then scans [resolve(begin), resolve(end)) with continuation fetches
        until the limit is satisfied or storage is exhausted, so overlay
        clears can never starve a limited read.
        """
        if isinstance(begin, bytes):
            begin = KeySelector.first_greater_or_equal(begin)
        if isinstance(end, bytes):
            end = KeySelector.first_greater_or_equal(end)
        version = await self.get_read_version()
        if not _canonical(begin):
            begin = KeySelector.first_greater_or_equal(
                await self.get_key(begin, snapshot=snapshot))
        if not _canonical(end):
            end = KeySelector.first_greater_or_equal(
                await self.get_key(end, snapshot=snapshot))
        win_lo, win_hi = begin.key, end.key
        if win_lo >= win_hi:
            return []

        overlay_slack = 8 + sum(1 for k, _p in
                                self._writes.points_in_range(win_lo, win_hi)) \
            if self._writes else 0
        fetch_limit = (limit + overlay_slack) if limit else 0

        rows: dict[bytes, bytes] = {}
        merged: list[tuple[bytes, bytes]] = []
        cur_lo, cur_hi = win_lo, win_hi  # uncovered remainder of the window
        while cur_lo < cur_hi:
            req = GetKeyValuesRequest(
                begin=KeySelector.first_greater_or_equal(cur_lo),
                end=KeySelector.first_greater_or_equal(cur_hi),
                version=version, limit=fetch_limit, reverse=reverse)
            reply = await self._deadline_guard(self.db._get_range(req))
            rows.update(reply.data)
            if reply.more and reply.data:
                if reverse:
                    cur_hi = reply.data[-1][0]
                else:
                    cur_lo = reply.data[-1][0] + b"\x00"
            elif reverse:
                cur_hi = cur_lo  # fully covered
            else:
                cur_lo = cur_hi  # fully covered
            cov_lo = win_lo if not reverse else cur_hi
            cov_hi = win_hi if reverse else cur_lo
            merged = self._merge_overlay(rows, cov_lo, cov_hi, reverse)
            if limit and len(merged) >= limit:
                break
        if limit:
            merged = merged[:limit]

        if not snapshot:
            # precise read conflict: the window actually observed
            if merged and limit and len(merged) == limit and cur_lo < cur_hi:
                if reverse:
                    con_lo, con_hi = merged[-1][0], win_hi
                else:
                    con_lo, con_hi = win_lo, merged[-1][0] + b"\x00"
            else:
                con_lo, con_hi = win_lo, win_hi
            if con_lo < con_hi:
                self._read_conflicts.append((con_lo, con_hi))
        return merged

    def _merge_overlay(self, rows, lo, hi, reverse):
        """Merge storage rows with the write overlay inside [lo, hi)."""
        rows = {k: v for k, v in rows.items() if lo <= k < hi}
        # remove cleared rows
        for b, e in self._writes.clears_intersecting(lo, hi):
            for k in [k for k in rows if b <= k < e]:
                del rows[k]
        # apply point writes
        for k, p in self._writes.points_in_range(lo, hi):
            v = p.resolve(rows.get(k)) if not p.known else p.value
            if v is None:
                rows.pop(k, None)
            else:
                rows[k] = v
        out = sorted(rows.items(), reverse=reverse)
        return out

    async def watch(self, key: bytes):
        """Future resolving when `key`'s value changes after commit time."""
        version = await self.get_read_version()
        value = await self.get(key, snapshot=True)
        return self._deadline_guard(
            self.db._watch(WatchValueRequest(key=key, value=value,
                                             version=version)))

    # -- writes --

    def set(self, key: bytes, value: bytes):
        # limit checks inlined (the hottest write-path frame)
        if len(key) > self._key_limit:
            raise FDBError("key_too_large")
        if len(value) > self._value_limit:
            raise FDBError("value_too_large")
        self._writes.set(key, value)

    def clear(self, key: bytes):
        self._check_key(key)
        self._writes.clear_range(key, key + b"\x00")

    def clear_range(self, begin: bytes, end: bytes):
        self._check_key(begin)
        if begin < end:
            self._writes.clear_range(begin, end)

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes):
        if op not in ATOMIC_OPS:
            raise FDBError("invalid_mutation_type", str(op))
        self._check_key(key)
        self._writes.atomic_op(op, key, operand)

    def add_read_conflict_range(self, begin: bytes, end: bytes):
        if begin < end:
            self._read_conflicts.append((begin, end))

    def add_read_conflict_key(self, key: bytes):
        self._read_conflicts.append((key, key + b"\x00"))

    def add_write_conflict_range(self, begin: bytes, end: bytes):
        if begin < end:
            self._extra_write_conflicts.append((begin, end))

    # -- commit --

    async def commit(self):
        if self._committing:
            raise FDBError("used_during_commit")
        self._committing = True
        try:
            if not self._writes:
                # read-only: nothing to do (reference: commit of RO txn is local)
                self._committed_version = self._read_version or 0
                return
            version = await self.get_read_version() \
                if (self._read_conflicts or self._read_conflict_keys) \
                else (self._read_version or 0)
            read_conflicts = self._read_conflicts
            if self._read_conflict_keys:
                read_conflicts = read_conflicts + [
                    (k, k + b"\x00") for k in self._read_conflict_keys]
            req = CommitTransactionRequest(
                read_snapshot=version,
                read_conflict_ranges=_coalesce(read_conflicts),
                write_conflict_ranges=self._writes.write_conflict_ranges()
                + getattr(self, "_extra_write_conflicts", []),
                mutations=list(self._writes.mutations))
            self._check_size(req)
            try:
                reply = await self._deadline_guard(self.db._commit(req))
            except FDBError as e:
                if e.name in ("request_maybe_delivered", "timed_out",
                              "broken_promise"):
                    # The commit RPC was lost/dropped/peer-died AFTER the
                    # request may have reached the proxy: the transaction may
                    # have committed. Surface the reference's dedicated error
                    # (NativeAPI tryCommit maps request_maybe_delivered ->
                    # commit_unknown_result) so applications can run their
                    # idempotency check before retrying; on_error still
                    # treats it as retryable.
                    raise FDBError("commit_unknown_result", e.detail) from e
                raise
            self._committed_version = reply.version
        finally:
            self._committing = False

    @property
    def committed_version(self) -> int | None:
        return self._committed_version

    async def on_error(self, error: FDBError):
        """The retry contract (NativeAPI Transaction::onError :2180), with
        two upgrades over blind doubling (docs/contention.md):

        - decorrelated jitter: each sleep is drawn uniformly from
          [DEFAULT_BACKOFF, 3 * previous_sleep], capped at MAX_BACKOFF —
          retries desynchronize instead of stampeding in doubling cohorts.
        - informed backoff: a transaction_throttled error carries the
          server-advised wait and the throttled range; both feed the
          database's per-range penalty cache, and the sleep honors the
          LONGER of jitter, advice, and any live penalty on this
          transaction's write set.
        """
        if not isinstance(error, FDBError) or not error.is_retryable:
            raise error
        self._retries += 1
        if (self._opt_retry_limit is not None
                and self._retries > self._opt_retry_limit):
            raise error
        base = KNOBS.DEFAULT_BACKOFF
        hi = max(base, self._backoff * 3)
        delay = min(KNOBS.MAX_BACKOFF,
                    base + self.db._rng.random() * (hi - base))
        advised = (self.db._note_throttle(error)
                   if error.name == "transaction_throttled" else 0.0)
        write_ranges = self._writes.write_conflict_ranges() \
            + getattr(self, "_extra_write_conflicts", [])
        wait = max(delay, advised, self.db._penalty_wait(write_ranges))
        await self.db.loop.delay(wait)
        self.reset()
        self._backoff = delay

    # -- limits (fdbclient/Knobs.cpp size limits) --

    def _check_key(self, key: bytes):
        if len(key) > self._key_limit:  # limit cached at reset(): hot path
            raise FDBError("key_too_large")

    def _check_value(self, value: bytes):
        if len(value) > self._value_limit:
            raise FDBError("value_too_large")

    def _check_size(self, req: CommitTransactionRequest):
        size = mutations_weight(req.mutations)
        size += sum(len(b) + len(e) for b, e in req.read_conflict_ranges)
        limit = KNOBS.TRANSACTION_SIZE_LIMIT
        if self._opt_size_limit is not None:
            limit = min(limit, self._opt_size_limit)
        if size > limit:
            raise FDBError("transaction_too_large")


def _coalesce(ranges: list[tuple[bytes, bytes]]) -> list[tuple[bytes, bytes]]:
    out: list[tuple[bytes, bytes]] = []
    for b, e in sorted(r for r in ranges if r[0] < r[1]):
        if out and b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((b, e))
    return out


def _canonical(sel: KeySelector) -> bool:
    """firstGreaterOrEqual — resolvable as a plain byte bound: the first
    merged-live key at/after the base IS the resolution, so no merged key
    below the base can be in the result and the base is an exact bound."""
    return not sel.or_equal and sel.offset == 1
