"""ILogSystem / IPeekCursor — the replicated-log seam.

Reference: fdbserver/LogSystem.h:268 (`ILogSystem`: push :605, peek :612,
pop :634, newEpoch :661), :272 (`IPeekCursor`),
TagPartitionedLogSystem.actor.cpp:398-417 (push waits per-log-set quorum
`size - antiquorum`), LogSystemPeekCursor.actor.cpp (cursor with replica
failover and epoch routing), LogSystemConfig.h (log sets with localities —
primary / satellite — plus prior generations).

The proxy pushes through a LogSystem instead of hard-wiring TLog endpoints;
storage servers and log routers pull through a PeekCursor instead of
hand-rolling epoch routing. This seam is what lets a log set grow a
satellite locality (synchronously replicated, holding the mutation log so a
primary-DC loss loses no acked commit) and lets log routers appear as just
another peek source for a remote region.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.future import Future, all_of
from foundationdb_tpu_torch.core.sim import Endpoint
from foundationdb_tpu_torch.server.interfaces import (
    LogEpoch, TLogCommitRequest, TLogPeekRequest, TLogPopRequest, Token)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS


@dataclass
class LogSet:
    """One replication group of the current generation
    (TagPartitionedLogSystem's tLogs entries): commit quorum is
    len(addrs) - antiquorum WITHIN each set, and a push succeeds only when
    every set reached its quorum — a satellite set with antiquorum 0 makes
    acked commits durable outside the primary DC."""

    addrs: list[str]
    uids: list[str] = field(default_factory=list)
    locality: str = "primary"  # "primary" | "satellite"
    antiquorum: int = 0

    def uid_of(self, i: int) -> str:
        return self.uids[i] if self.uids else ""


class LogSystem:
    """The current generation's push fan-out + quorum tracking (ILogSystem
    push :605; TagPartitionedLogSystem::push :398-417)."""

    def __init__(self, process, log_sets: list[LogSet]):
        self.process = process
        self.log_sets = [s for s in log_sets if s.addrs]

    @classmethod
    def from_endpoints(cls, process, tlogs: list[Endpoint],
                       uids: list[str] | None = None,
                       satellites: list[Endpoint] | None = None,
                       satellite_uids: list[str] | None = None,
                       antiquorum: int | None = None) -> "LogSystem":
        if antiquorum is None:
            antiquorum = KNOBS.TLOG_QUORUM_ANTIQUORUM
        sets = [LogSet(addrs=[e.address for e in tlogs],
                       uids=list(uids or []), locality="primary",
                       antiquorum=antiquorum)]
        if satellites:
            sets.append(LogSet(addrs=[e.address for e in satellites],
                               uids=list(satellite_uids or []),
                               locality="satellite", antiquorum=0))
        return cls(process, sets)

    def push(self, prev_version: int, version: int, messages: dict,
             known_committed: int) -> Future:
        """Send the batch to every log of every set; resolves when EVERY set
        reached its own quorum (errors propagate immediately — the caller's
        batch fails and retries/recovers)."""
        gates = []
        for ls in self.log_sets:
            futures = [
                self.process.net.request(
                    self.process, Endpoint(addr, Token.TLOG_COMMIT),
                    TLogCommitRequest(
                        prev_version=prev_version, version=version,
                        messages=messages,
                        known_committed_version=known_committed,
                        uid=ls.uid_of(i)))
                for i, addr in enumerate(ls.addrs)]
            gates.append(self._quorum(futures,
                                      len(futures) - ls.antiquorum))
        return all_of(gates)

    def _quorum(self, futures, quorum: int) -> Future:
        gate = Future()
        if quorum <= 0:
            gate._set(None)
            return gate
        done = [0]

        def on_done(f):
            if gate.is_ready():
                return
            if f.is_error():
                gate._set_error(f._result)
            else:
                done[0] += 1
                if done[0] >= quorum:
                    gate._set(None)
        for f in futures:
            f.add_callback(on_done)
        return gate

    def pop(self, tag: int, version: int):
        for ls in self.log_sets:
            for i, addr in enumerate(ls.addrs):
                self.process.net.one_way(
                    self.process, Endpoint(addr, Token.TLOG_POP),
                    TLogPopRequest(tag=tag, version=version,
                                   uid=ls.uid_of(i)))


class PeekCursor:
    """IPeekCursor over an epoch list (LogSystemPeekCursor.actor.cpp): one
    get_more() returns the next page from the epoch serving the cursor's
    position, failing over between that epoch's replicas. The consumer owns
    position advancement (it must clamp at epoch ends and may roll back), so
    the cursor exposes `begin` as a plain attribute."""

    def __init__(self, process, epochs: list[LogEpoch], tag: int, begin: int,
                 timeout: float = 2.0, retry_delay: float = 0.5,
                 refresh=None, interrupted=None):
        self.process = process
        self.epochs = epochs
        self.tag = tag
        self.begin = begin  # next version to fetch is begin + 1
        self._rotation = 0
        self._timeout = timeout
        self._retry_delay = retry_delay
        # refresh() -> (epochs, begin): re-read the OWNER's live log-system
        # view at the top of every attempt, so a recovery that rebinds the
        # epoch list / rewinds the pull position while this cursor is mid-
        # retry against a dead replica is observed immediately (the reference
        # cursor routes every attempt through the live log-system config,
        # LogSystemPeekCursor.actor.cpp). Without it a kill-during-workload
        # recovery leaves the cursor spinning on the dead epoch forever.
        self._refresh = refresh
        # interrupted() -> bool: yield control between attempts (returns
        # (None, None)) so the owner can re-check its own gates — e.g. a
        # fetchKeys splice that must see the update loop parked.
        self._interrupted = interrupted

    def epoch_for(self, version: int) -> LogEpoch:
        for ep in self.epochs:
            if ep.end is None or version <= ep.end:
                return ep
        return self.epochs[-1]

    async def get_more(self):
        """(epoch, TLogPeekReply) for the page at begin+1; retries/rotates
        internally on dead or unreachable replicas. Returns (None, None)
        when `interrupted` fires so the owner can service its gates."""
        loop = self.process.net.loop
        while True:
            if self._refresh is not None:
                self.epochs, self.begin = self._refresh()
            if self._interrupted is not None and self._interrupted():
                return None, None
            epoch = self.epoch_for(self.begin + 1)
            idx = self._rotation % len(epoch.addrs)
            addr = epoch.addrs[idx]
            try:
                reply = await loop.timeout(self.process.net.request(
                    self.process, Endpoint(addr, Token.TLOG_PEEK),
                    TLogPeekRequest(tag=self.tag, begin=self.begin + 1,
                                    uid=epoch.uid_of(idx))),
                    self._timeout)
                return epoch, reply
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                # replica dead/unreachable: fail over within the epoch
                self._rotation += 1
                await loop.delay(self._retry_delay)
