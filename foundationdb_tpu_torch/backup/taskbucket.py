"""TaskBucket: a fault-tolerant task queue stored in the database itself.

Reference: fdbclient/TaskBucket.actor.cpp — tasks are KV rows; agents pop
one transactionally by writing a lease; a crashed agent's lease expires and
another agent re-pops the task; finishing clears the row. The conflict
check makes concurrent pops of the same task impossible.
"""

from __future__ import annotations

from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError

PREFIX = b"\xff/taskBucket/"
END = b"\xff/taskBucket0"


class TaskBucket:
    def __init__(self, db, lease_seconds: float = 10.0):
        self.db = db
        self.loop = db.loop
        self.lease_seconds = lease_seconds
        self._seq = 0

    async def add(self, task: dict, tr=None):
        """Append a task (optionally inside a caller's transaction)."""
        self._seq += 1
        key = PREFIX + b"%016x-%08x" % (
            int(self.loop.now() * 1e6), self._seq)
        payload = wire.dumps({"task": task, "lease": -1.0})
        if tr is not None:
            tr.set(key, payload)
            return key

        async def w(t):
            t.set(key, payload)
        await self.db.transact(w, max_retries=100)
        return key

    async def pop(self):
        """Transactionally claim one available task (no task -> None).
        Availability = lease expired; claiming writes a fresh lease. Two
        agents racing on the same row conflict, so exactly one wins."""
        async def body(tr):
            now = self.loop.now()
            # page past live-leased rows: an expired task beyond the first
            # page must still be reclaimable (liveness), so keep scanning to
            # the end of the range, 20 rows at a time
            begin = PREFIX
            while True:
                rows = await tr.get_range(begin, END, limit=20)
                for k, v in rows:
                    obj = wire.loads(v)
                    if obj["lease"] < now:
                        tr.set(k, wire.dumps({
                            "task": obj["task"],
                            "lease": now + self.lease_seconds}))
                        return k, obj["task"]
                if len(rows) < 20:
                    return None
                begin = rows[-1][0] + b"\x00"
        return await self.db.transact(body, max_retries=100)

    async def extend(self, key: bytes):
        async def body(tr):
            v = await tr.get(key)
            if v is None:
                raise FDBError("operation_failed", "task finished under us")
            obj = wire.loads(v)
            tr.set(key, wire.dumps({
                "task": obj["task"],
                "lease": self.loop.now() + self.lease_seconds}))
        await self.db.transact(body, max_retries=100)

    async def finish(self, key: bytes):
        async def body(tr):
            tr.clear_range(key, key + b"\x00")
        await self.db.transact(body, max_retries=100)

    async def is_empty(self) -> bool:
        async def body(tr):
            rows = await tr.get_range(PREFIX, END, limit=1)
            return not rows
        return await self.db.transact(body, max_retries=100)
