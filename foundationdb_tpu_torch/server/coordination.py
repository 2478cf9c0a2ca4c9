"""Coordination: replicated generation register, coordinated state, election.

Reference: fdbserver/Coordination.actor.cpp (localGenerationReg :125) — each
coordinator is a disk-backed single-key register versioned by generations;
fdbserver/CoordinatedState.actor.cpp layers a disk-paxos-flavored quorum
read/write over the registers; fdbserver/LeaderElection.actor.cpp
(tryBecomeLeaderInternal :78) elects the cluster controller by candidacy
polling against the same coordinators; clients find the leader through
fdbclient/MonitorLeader.actor.cpp.

Generations are (batch, sequence)-free here: a single int64 drawn uniquely by
each client attempt (ballot). Register semantics per coordinator:

  read(gen):  rgen = max(rgen, gen); return (value, vgen, rgen)
  write(value, gen): ok iff gen >= rgen and gen > vgen; then value/vgen := gen

A CoordinatedState client reads with a fresh ballot from a quorum (taking the
value with the highest vgen) and writes through a quorum; any interleaved
competing ballot forces a retry, which is exactly enough to serialize master
recoveries (the reference's usage: the cstate holds the log-system config).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any

from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils import wire


class CoordToken:
    GENERATION_READ = 60
    GENERATION_WRITE = 61
    CANDIDACY = 62
    GET_LEADER = 63
    GENERATION_PEEK = 64  # read-only: no rgen promotion, no ballot needed


@dataclass
class GenReadRequest:
    key: str
    gen: int


@dataclass
class GenReadReply:
    value: Any
    vgen: int
    rgen: int


@dataclass
class GenWriteRequest:
    key: str
    value: Any
    gen: int


@dataclass
class GenWriteReply:
    ok: bool
    rgen: int
    vgen: int


@dataclass
class CandidacyRequest:
    """LeaderElection: a candidate advertises itself; the coordinator nominates
    the best (highest priority, then lowest address) candidate with a fresh
    lease and replies with its current nominee."""

    address: str
    priority: int
    lease_seconds: float = 4.0


@dataclass
class LeaderReply:
    leader: str | None
    priority: int


def quorum_wait(futures, need: int, max_errors: int):
    """Future of the first `need` successful replies; errors beyond
    max_errors fail the whole quorum (the reference's quorum() actor)."""
    from foundationdb_tpu_torch.core.future import Future

    out = Future()
    replies: list = []
    state = {"errors": 0}

    def on_done(f):
        if out.is_ready():
            return
        if f.is_error():
            state["errors"] += 1
            if state["errors"] > max_errors:
                out._set_error(FDBError("coordinators_changed",
                                        "quorum unreachable"))
        else:
            replies.append(f._result)
            if len(replies) >= need:
                out._set(list(replies))

    for f in futures:
        f.add_callback(on_done)
    return out


class Coordinator:
    """One coordinator process: generation registers + election arbiter.

    Registers persist to a kvstore file on the process, so a rebooted
    coordinator keeps its promises (OnDemandStore in the reference).
    """

    def __init__(self, process: SimProcess):
        from foundationdb_tpu_torch.storage.kvstore import MemoryKeyValueStore

        self.process = process
        self.store = MemoryKeyValueStore(
            process.net.open_file(process, "coord.0"),
            process.net.open_file(process, "coord.1"))
        self.store.recover()
        self._regs: dict[str, tuple[Any, int, int]] = {}  # key -> (value, vgen, rgen)
        raw = self.store.get_metadata("regs")
        if raw:
            try:
                self._regs = wire.loads(raw)
            except wire.WireError as e:
                raise FDBError("file_corrupt", f"coordinator regs undecodable: {e}")
        self.nominee: str | None = None
        self.nominee_priority = -1
        self.nominee_expiry = 0.0
        process.register(CoordToken.GENERATION_READ, self._on_read)
        process.register(CoordToken.GENERATION_WRITE, self._on_write)
        process.register(CoordToken.CANDIDACY, self._on_candidacy)
        process.register(CoordToken.GET_LEADER, self._on_get_leader)
        process.register(CoordToken.GENERATION_PEEK, self._on_peek)

    def _persist(self):
        self.store.set_metadata("regs", wire.dumps(self._regs))
        self.store.commit()

    def _on_peek(self, req: GenReadRequest, reply):
        """Read-only register peek: observers (e.g. a master checking whether
        its generation is still current) must not promote rgen, or they would
        force live CoordinatedState writers into ballot retries."""
        value, vgen, rgen = self._regs.get(req.key, (None, 0, 0))
        reply.send(GenReadReply(value=value, vgen=vgen, rgen=rgen))

    def _on_read(self, req: GenReadRequest, reply):
        value, vgen, rgen = self._regs.get(req.key, (None, 0, 0))
        rgen = max(rgen, req.gen)
        self._regs[req.key] = (value, vgen, rgen)
        self._persist()
        reply.send(GenReadReply(value=value, vgen=vgen, rgen=rgen))

    def _on_write(self, req: GenWriteRequest, reply):
        value, vgen, rgen = self._regs.get(req.key, (None, 0, 0))
        if req.gen >= rgen and req.gen > vgen:
            self._regs[req.key] = (req.value, req.gen, max(rgen, req.gen))
            self._persist()
            reply.send(GenWriteReply(ok=True, rgen=max(rgen, req.gen), vgen=req.gen))
        else:
            reply.send(GenWriteReply(ok=False, rgen=rgen, vgen=vgen))

    # -- election --

    def _on_candidacy(self, req: CandidacyRequest, reply):
        now = self.process.net.loop.now()
        expired = now >= self.nominee_expiry
        better = (req.priority, req.address) > (self.nominee_priority, self.nominee or "")
        if self.nominee is None or expired or better or req.address == self.nominee:
            self.nominee = req.address
            self.nominee_priority = req.priority
            self.nominee_expiry = now + req.lease_seconds
        reply.send(LeaderReply(leader=self.nominee, priority=self.nominee_priority))

    def _on_get_leader(self, req, reply):
        now = self.process.net.loop.now()
        if self.nominee is not None and now < self.nominee_expiry:
            reply.send(LeaderReply(leader=self.nominee, priority=self.nominee_priority))
        else:
            reply.send(LeaderReply(leader=None, priority=-1))


class CoordinatedStateClient:
    """Quorum read/write over the coordinators' generation registers
    (CoordinatedState.actor.cpp semantics; serializes master recoveries)."""

    def __init__(self, process: SimProcess, coordinators: list[str],
                 key: str = "cstate"):
        self.process = process
        self.coordinators = coordinators
        self.key = key
        self._ballot = 0

    @property
    def quorum(self) -> int:
        return len(self.coordinators) // 2 + 1

    def _next_ballot(self, floor: int = 0) -> int:
        # unique per (process, attempt): high bits attempt counter, low bits
        # a stable per-process tag derived from the address hash
        self._ballot = max(self._ballot + 1, floor + 1)
        # stable across interpreters (str hash is PYTHONHASHSEED-salted, which
        # would break deterministic simulation) and well-spread over the tag
        # space to avoid ballot collisions between processes
        tag = zlib.crc32(self.process.address.encode()) % 1000
        return self._ballot * 1000 + tag

    async def _quorum_call(self, token: int, make_req) -> list:
        futures = [self.process.net.request(
            self.process, Endpoint(addr, token), make_req())
            for addr in self.coordinators]
        return await quorum_wait(futures, self.quorum,
                                 len(self.coordinators) - self.quorum)

    async def read(self) -> tuple[Any, int]:
        """Returns (value, write-generation). Retries ballots until clean."""
        for _ in range(20):
            gen = self._next_ballot()
            replies = await self._quorum_call(
                CoordToken.GENERATION_READ,
                lambda: GenReadRequest(key=self.key, gen=gen))
            best = max(replies, key=lambda r: r.vgen)
            max_rgen = max(r.rgen for r in replies)
            if max_rgen > gen:
                self._ballot = max(self._ballot, max_rgen // 1000)
                continue  # a competing ballot intervened; retry higher
            return best.value, best.vgen
        raise FDBError("coordinators_changed", "read ballot contention")

    async def write(self, value: Any) -> int:
        """Write value with a fresh ballot through a quorum; returns the
        generation. Raises if beaten by a competing recovery."""
        for _ in range(20):
            gen = self._next_ballot()
            replies = await self._quorum_call(
                CoordToken.GENERATION_WRITE,
                lambda: GenWriteRequest(key=self.key, value=value, gen=gen))
            if all(r.ok for r in replies):
                return gen
            self._ballot = max(self._ballot,
                               max(max(r.rgen, r.vgen) for r in replies) // 1000)
        raise FDBError("coordinators_changed", "write ballot contention")


async def elect_leader(process: SimProcess, coordinators: list[str],
                       priority: int, lease_seconds: float = 4.0,
                       poll_interval: float = 1.0):
    """Candidacy loop: returns when this process is nominated by a majority
    (tryBecomeLeaderInternal). Caller must keep calling maintain_leadership()
    (re-candidacy) to hold the lease."""
    net = process.net
    quorum = len(coordinators) // 2 + 1
    while True:
        votes = 0
        for addr in coordinators:
            try:
                r = await net.request(
                    process, Endpoint(addr, CoordToken.CANDIDACY),
                    CandidacyRequest(address=process.address, priority=priority,
                                     lease_seconds=lease_seconds))
                if r.leader == process.address:
                    votes += 1
            except FDBError:
                pass
        if votes >= quorum:
            return
        await net.loop.delay(poll_interval)


async def get_leader(process: SimProcess, coordinators: list[str]) -> str | None:
    """Client side (MonitorLeader): majority opinion on the current leader."""
    net = process.net
    counts: dict[str, int] = {}
    for addr in coordinators:
        try:
            r = await net.request(process, Endpoint(addr, CoordToken.GET_LEADER),
                                  None)
            if r.leader:
                counts[r.leader] = counts.get(r.leader, 0) + 1
        except FDBError:
            continue
    quorum = len(coordinators) // 2 + 1
    for leader, n in counts.items():
        if n >= quorum:
            return leader
    return None
