"""DR agent: continuous replication into a SECOND LIVE cluster + switchover.

Reference: fdbclient/DatabaseBackupAgent.actor.cpp — `dr_agent` keeps a
destination database a live, consistent copy of the source: an initial
snapshot copy, then a continuous tail of the source's mutation log applied
to the destination in version order (CopyLogRangeTaskFunc /
ApplyMutationsData), with an applied-version watermark stored IN the
destination so crashed/duplicated applications are idempotent. Switchover
(atomicSwitchover) fences the source, drains the remaining log, and flips
the primary marker — afterwards the destination is byte-identical through
the fence version.

Design differences from the reference, on purpose:
  - The initial snapshot reads the whole keyspace at ONE pinned read version
    (chunked reads with set_read_version) instead of a streamed multi-version
    snapshot + per-range log floors: exact, and the right trade at sim
    scale. Mutations are then applied strictly above that version.
  - There is no database-level lock primitive; switchover() requires the
    caller to have quiesced source writers (the test does), then fences with
    a marker commit exactly like BackupAgent.stop().

The mutation feed is the proxies' \\xff/blog tee (backup/agent.py keys):
rows are only CLEARED from the source after the destination transaction
recording them (and the watermark) committed — crash between the two just
re-applies idempotently.
"""

from __future__ import annotations

from foundationdb_tpu_torch.backup.agent import (
    BEGIN_KEY, BLOG_END, BLOG_PREFIX, RANGES_END, RANGES_PREFIX, STATE_KEY,
    parse_blog_key)
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.types import ATOMIC_OPS, Mutation, MutationType

DR_APPLIED = b"\xff/dr/applied"  # in the DESTINATION: versions <= are applied
DR_PRIMARY = b"\xff/dr/primary"  # which side serves writes after switchover


def apply_mutation(tr, m: Mutation):
    """Replay one post-substitution mutation (versionstamps were resolved by
    the source proxy before the tee, proxy.py _substitute)."""
    if m.type == MutationType.SET_VALUE:
        tr.set(m.param1, m.param2)
    elif m.type == MutationType.CLEAR_RANGE:
        tr.clear_range(m.param1, m.param2)
    elif m.type in ATOMIC_OPS:
        tr.atomic_op(m.type, m.param1, m.param2)
    else:
        raise FDBError("invalid_mutation_type", str(m.type))


class DRAgent:
    def __init__(self, src_db, dst_db, chunk_rows: int = 400):
        self.src = src_db
        self.dst = dst_db
        self.loop = src_db.loop
        self.chunk_rows = chunk_rows

    async def start(self):
        """Activate the source's mutation-log tee (the same proxy tee file
        backups use) and stamp the destination as a replica."""
        async def body(tr):
            st = await tr.get(STATE_KEY)
            if st == b"active":
                raise FDBError("operation_failed", "backup/DR already active")
            tr.set(STATE_KEY, b"active")
            tr.set(RANGES_PREFIX + b"", b"\xff")
            tr.clear_range(BLOG_PREFIX, BLOG_END)
        await self.src.transact(body, max_retries=200)

        async def note_begin(tr):
            v = await tr.get_read_version()
            tr.set(BEGIN_KEY, b"%d" % v)
        await self.src.transact(note_begin, max_retries=200)

        async def mark(tr):
            tr.set(DR_PRIMARY, b"remote")
        await self.dst.transact(mark, max_retries=200)

    async def initial_snapshot(self) -> int:
        """Copy the whole keyspace at one pinned version; set the
        destination watermark so the log tail starts exactly above it."""
        v0 = [None]

        async def pin(tr):
            v0[0] = await tr.get_read_version()
        await self.src.transact(pin, max_retries=200)

        cursor = b""
        while True:
            rows = []

            async def read(tr):
                nonlocal rows
                tr.set_read_version(v0[0])
                rows = await tr.get_range(cursor, b"\xff",
                                          limit=self.chunk_rows)
            await self.src.transact(read, max_retries=200)

            async def write(tr, rows=list(rows), first=(cursor == b"")):
                if first:
                    tr.clear_range(b"", b"\xff")
                for k, v in rows:
                    tr.set(k, v)
            await self.dst.transact(write, max_retries=200)
            if len(rows) < self.chunk_rows:
                break
            cursor = rows[-1][0] + b"\x00"

        async def mark(tr):
            tr.set(DR_APPLIED, b"%d" % v0[0])
        await self.dst.transact(mark, max_retries=200)
        return v0[0]

    async def drain_once(self, limit: int = 200) -> int:
        """Apply one batch of tee'd mutations to the destination, then clear
        them from the source. Returns source rows consumed."""
        rows = []

        async def read(tr):
            nonlocal rows
            rows = await tr.get_range(BLOG_PREFIX, BLOG_END, limit=limit)
        await self.src.transact(read, max_retries=200)
        if not rows:
            return 0
        if len(rows) == limit:
            # the limit may have cut MID-version (a version's rows are
            # written atomically by its commit, but a bounded read can see a
            # prefix): only complete versions may be applied, or the
            # watermark would hide the version's tail forever
            from foundationdb_tpu_torch.backup.agent import blog_key
            last_v, _ = parse_blog_key(rows[-1][0])
            trimmed = [r for r in rows if parse_blog_key(r[0])[0] != last_v]
            if trimmed:
                rows = trimmed
            else:
                async def read_full(tr):
                    nonlocal rows
                    rows = await tr.get_range(blog_key(last_v, 0),
                                              blog_key(last_v + 1, 0))
                await self.src.transact(read_full, max_retries=200)
        # group by version: one destination transaction per source commit
        # version keeps apply atomic per version and bounds txn size by the
        # source's own commit batch limit
        groups: dict[int, list] = {}
        for k, payload in rows:
            version, _seq = parse_blog_key(k)
            groups.setdefault(version, []).extend(wire.loads(payload))
        for version in sorted(groups):
            async def apply(tr, version=version, muts=groups[version]):
                applied = int(await tr.get(DR_APPLIED) or b"0")
                if version <= applied:
                    return  # duplicated application (crash replay): skip
                for m in muts:
                    apply_mutation(tr, m)
                tr.set(DR_APPLIED, b"%d" % version)
            await self.dst.transact(apply, max_retries=500)

        async def clear(tr):
            tr.clear_range(BLOG_PREFIX, rows[-1][0] + b"\x00")
        await self.src.transact(clear, max_retries=200)
        return len(rows)

    async def run(self, poll: float = 0.5):
        """Continuous tail: drain until the DR is deactivated AND the log is
        empty (every tee'd mutation reached the destination).

        dr_agent is a daemon: a dead storage server or a recovery on either
        cluster surfaces as a transient FDBError mid-drain, and the agent
        must ride it out and resume — drain application is idempotent
        (watermark in the destination), so re-running a failed drain is
        always safe."""
        while True:
            try:
                moved = await self.drain_once()
                if moved == 0:
                    async def st(tr):
                        return await tr.get(STATE_KEY)
                    state = await self.src.transact(st, max_retries=200)
                    if state != b"active":
                        return
                    await self.loop.delay(poll)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                await self.loop.delay(poll)

    async def applied_version(self) -> int:
        async def rd(tr):
            return int(await tr.get(DR_APPLIED) or b"0")
        return await self.dst.transact(rd, max_retries=200)

    async def switchover(self) -> int:
        """atomicSwitchover: fence the (quiesced) source, drain the rest of
        the log into the destination, deactivate the tee and flip the
        primary markers. Returns the fence version — the destination is
        identical to the source through it."""
        fence_tr = [None]

        async def fence(tr):
            fence_tr[0] = tr
            tr.set(b"\xff/backup/fence", b"x")
        await self.src.transact(fence, max_retries=500)
        end_version = fence_tr[0].committed_version
        while await self.drain_once() > 0:
            pass

        async def deactivate(tr):
            tr.set(STATE_KEY, b"stopped")
            tr.clear_range(RANGES_PREFIX, RANGES_END)
            tr.set(DR_PRIMARY, b"remote")
        await self.src.transact(deactivate, max_retries=200)
        # late tee rows between the fence and deactivation: beyond the fence
        # version but still valid source commits — apply them too so the
        # destination converges to the final source state
        while await self.drain_once() > 0:
            pass

        async def promote(tr):
            tr.set(DR_PRIMARY, b"primary")
        await self.dst.transact(promote, max_retries=200)
        return end_version
