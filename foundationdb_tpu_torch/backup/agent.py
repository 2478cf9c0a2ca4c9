"""File backup agent + restore.

Reference: fdbclient/FileBackupAgent.actor.cpp — a backup is (a) range
snapshot files, each chunk read transactionally at SOME version during the
backup window, plus (b) the mutation log: proxies tee every committed
mutation in a backed-up range into \\xff/blog/<version><seq>
(MasterProxyServer.actor.cpp:664-776); the agent drains that range into log
files and clears what it consumed. Restore (fdbserver/Restore.actor.cpp)
loads the chunks, then applies log mutations with version > the chunk's
version for that range — yielding exactly the database state at the
backup's end version.

Backup metadata lives in the system keyspace (all flowing through the
metadata pipeline, so every proxy's tee switches on/off at a fenced
version):
  \\xff/backup/state         active | stopped
  \\xff/backup/beginVersion  decimal
  \\xff/backup/endVersion    decimal (written by stop)
  \\xff/backupRanges/<begin> -> <end>  (ranges the proxies tee)
"""

from __future__ import annotations

from bisect import bisect_right

from foundationdb_tpu_torch.backup.taskbucket import TaskBucket
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError

BLOG_PREFIX = b"\xff/blog/"
BLOG_END = b"\xff/blog0"
STATE_KEY = b"\xff/backup/state"
BEGIN_KEY = b"\xff/backup/beginVersion"
END_KEY = b"\xff/backup/endVersion"
RANGES_PREFIX = b"\xff/backupRanges/"
RANGES_END = b"\xff/backupRanges0"


def backup_keys():
    return dict(blog=BLOG_PREFIX, state=STATE_KEY, begin=BEGIN_KEY,
                end=END_KEY, ranges=RANGES_PREFIX)


def blog_key(version: int, seq: int) -> bytes:
    return BLOG_PREFIX + version.to_bytes(8, "big") + seq.to_bytes(4, "big")


def parse_blog_key(key: bytes) -> tuple[int, int]:
    raw = key[len(BLOG_PREFIX):]
    return int.from_bytes(raw[:8], "big"), int.from_bytes(raw[8:12], "big")


class BackupAgent:
    """Drives one backup: start (ranges + snapshot tasks), agent loop
    (snapshot chunks via the TaskBucket; several agents may run), log
    tailer, stop."""

    def __init__(self, db, container, chunks: int = 8):
        self.db = db
        self.loop = db.loop
        self.container = container
        self.chunks = chunks
        self.tasks = TaskBucket(db)

    async def start(self, begin: bytes = b"", end: bytes = b"\xff"):
        """Activate the proxies' tee and enqueue snapshot-chunk tasks (one
        metadata txn: the tee and the task list appear atomically)."""
        from foundationdb_tpu_torch.utils.keys import partition_boundaries
        bounds = [b for b in partition_boundaries(self.chunks)
                  if begin <= b < end] + [begin]
        bounds = sorted(set(bounds))

        async def body(tr):
            st = await tr.get(STATE_KEY)
            if st == b"active":
                raise FDBError("operation_failed", "backup already active")
            tr.set(STATE_KEY, b"active")
            tr.set(RANGES_PREFIX + begin, end)
            tr.clear_range(BLOG_PREFIX, BLOG_END)  # stale log of a prior run
            for i, lo in enumerate(bounds):
                hi = bounds[i + 1] if i + 1 < len(bounds) else end
                await self.tasks.add(
                    {"type": "snapshot_range", "begin": lo, "end": hi}, tr=tr)
        await self.db.transact(body, max_retries=200)

        async def note_begin(tr):
            # beginVersion = a version known to precede every tee'd commit's
            # consumption; the start txn's own commit version is the fence
            v = await tr.get_read_version()
            tr.set(BEGIN_KEY, b"%d" % v)
        await self.db.transact(note_begin, max_retries=200)

    async def run_agent(self):
        """Execute snapshot tasks until the bucket drains (crash-safe:
        unfinished tasks' leases expire and another agent re-runs them)."""
        while True:
            popped = await self.tasks.pop()
            if popped is None:
                if await self.tasks.is_empty():
                    return
                await self.loop.delay(1.0)
                continue
            key, task = popped
            assert task["type"] == "snapshot_range"
            rows = []
            version = None

            async def read_chunk(tr):
                nonlocal rows, version
                rows = await tr.get_range(task["begin"], task["end"])
                version = await tr.get_read_version()
            await self.db.transact(read_chunk, max_retries=200)
            self.container.write_file(
                "kvrange-%s" % task["begin"].hex(),
                {"begin": task["begin"], "end": task["end"],
                 "version": version, "rows": rows})
            await self.tasks.finish(key)

    async def drain_log(self, limit: int = 500) -> int:
        """Move a batch of \\xff/blog/ rows into a log file and clear them
        (the reference's eraseLogData after upload). Returns rows moved."""
        rows = []

        async def body(tr):
            nonlocal rows
            rows = await tr.get_range(BLOG_PREFIX, BLOG_END, limit=limit)
            if rows:
                tr.clear_range(BLOG_PREFIX, rows[-1][0] + b"\x00")
        await self.db.transact(body, max_retries=200)
        if rows:
            entries = [(parse_blog_key(k), v) for k, v in rows]
            # file name = the drained version range: unique across agents
            # (a stop() racing a tailer must not overwrite its files) and
            # lexicographically version-ordered
            first = entries[0][0]
            last = entries[-1][0]
            self.container.write_file(
                "log-%016x.%08x-%016x.%08x" % (first[0], first[1],
                                               last[0], last[1]),
                [((v, s), payload) for (v, s), payload in entries])
        return len(rows)

    async def run_log_tailer(self, poll: float = 1.0):
        """Continuously drain the mutation log while the backup is active."""
        while True:
            moved = await self.drain_log()
            if moved == 0:
                async def st(tr):
                    return await tr.get(STATE_KEY)
                state = await self.db.transact(st, max_retries=200)
                if state != b"active":
                    return
                await self.loop.delay(poll)

    async def stop(self) -> int:
        """Finish the backup: fence the end version, drain the remaining
        log, deactivate the tee. Returns the restorable end version."""
        # a throwaway committed write fences the end version: every earlier
        # committed mutation has version <= end_version
        fence_tr = [None]

        async def fence(tr):
            fence_tr[0] = tr
            tr.set(b"\xff/backup/fence", b"x")
        await self.db.transact(fence, max_retries=500)
        end_version = fence_tr[0].committed_version
        # every committed mutation <= end_version is either in the container
        # already or still in \xff/blog: drain until empty
        while await self.drain_log() > 0:
            pass

        async def deactivate(tr):
            tr.set(STATE_KEY, b"stopped")
            tr.set(END_KEY, b"%d" % end_version)
            tr.clear_range(RANGES_PREFIX, RANGES_END)
        await self.db.transact(deactivate, max_retries=200)
        # mutations committed between end_version and the deactivation fence
        # still tee'd into \xff/blog; they are beyond end_version and simply
        # ignored by restore — clear them
        while await self.drain_log() > 0:
            pass
        self.container.write_file("meta", {"end_version": end_version})
        return end_version


class RestoreAgent:
    """Apply a container into a cluster: chunks first, then log mutations
    above each chunk's version floor, up to the target version.

    Works against a LIVE cluster (Restore.actor.cpp's restore-into-running-
    database): every backed-up range is cleared before its chunk lands, so
    existing data under the restored ranges is replaced transactionally
    range by range; data outside them is untouched. `target_version` makes
    it point-in-time: any version in [max chunk version, end_version] —
    below the chunk floor there is no consistent base to roll forward from
    (fdbclient/FileBackupAgent.actor.cpp:941 restorable-version rules)."""

    def __init__(self, db, container):
        self.db = db
        self.container = container

    async def restore(self, target_version: int | None = None) -> int:
        from foundationdb_tpu_torch.utils.types import Mutation, MutationType
        meta = self.container.read_file("meta")
        end_version = meta["end_version"]
        chunk_versions = [self.container.read_file(n)["version"]
                          for n in self.container.list_files("kvrange-")]
        min_restorable = max(chunk_versions) if chunk_versions else 0
        if target_version is None:
            target_version = end_version
        if not min_restorable <= target_version <= end_version:
            raise FDBError(
                "restore_invalid_version",
                f"target {target_version} outside restorable window "
                f"[{min_restorable}, {end_version}]")
        end_version = target_version
        floors: list[tuple[bytes, int]] = []  # (chunk begin, version)
        chunk_ends: dict[bytes, bytes] = {}
        for name in self.container.list_files("kvrange-"):
            chunk = self.container.read_file(name)
            floors.append((chunk["begin"], chunk["version"]))
            chunk_ends[chunk["begin"]] = chunk["end"]
            rows = chunk["rows"]
            for i in range(0, max(len(rows), 1), 100):
                part = rows[i:i + 100]

                async def w(tr, part=part, chunk=chunk, first=(i == 0)):
                    if first:
                        tr.clear_range(chunk["begin"], chunk["end"])
                    for k, v in part:
                        tr.set(k, v)
                await self.db.transact(w, max_retries=200)
        floors.sort()
        fkeys = [b for b, _v in floors]

        def floor_of(key: bytes) -> int:
            i = bisect_right(fkeys, key) - 1
            if i < 0:
                return 1 << 62  # outside every chunk: not backed up
            b = fkeys[i]
            if key >= chunk_ends[b]:
                return 1 << 62
            return floors[i][1]

        def clear_pieces(version: int, lo: bytes, hi: bytes):
            """Split a clear at chunk boundaries; keep pieces whose floor is
            below the mutation's version (replaying an OLDER clear over a
            NEWER chunk would delete restored rows)."""
            cuts = sorted({lo, hi} | {b for b in fkeys if lo < b < hi}
                          | {e for e in chunk_ends.values() if lo < e < hi})
            out = []
            for a, b in zip(cuts, cuts[1:]):
                if version > floor_of(a):
                    out.append((a, b))
            return out

        applied = 0
        entries = []
        for name in self.container.list_files("log-"):
            entries.extend(self.container.read_file(name))
        entries.sort(key=lambda e: e[0])  # (version, seq) order
        for (version, _seq), payload in entries:
            if version > end_version:
                continue
            muts = wire.loads(payload)
            todo = []
            for m in muts:
                if m.type == MutationType.CLEAR_RANGE:
                    todo.extend(
                        Mutation(MutationType.CLEAR_RANGE, a, b)
                        for a, b in clear_pieces(version, m.param1, m.param2))
                elif version > floor_of(m.param1):
                    todo.append(m)
            if not todo:
                continue

            async def w(tr, todo=todo):
                for m in todo:
                    if m.type == MutationType.CLEAR_RANGE:
                        tr.clear_range(m.param1, m.param2)
                    elif m.type == MutationType.SET_VALUE:
                        tr.set(m.param1, m.param2)
                    else:
                        # atomic ops replay as atomic ops: applied over the
                        # restored base in version order they compose to the
                        # same final value
                        tr.atomic_op(m.type, m.param1, m.param2)
            await self.db.transact(w, max_retries=200)
            applied += len(todo)
        return applied
