"""Master role: the commit-version allocator.

Reference: fdbserver/masterserver.actor.cpp — getVersion (:822) hands each
commit batch a unique, strictly increasing version advancing at
VERSIONS_PER_SECOND against the clock (:858), and tells the proxy the previous
version it assigned so downstream stages (resolvers, TLogs) can chain batches
into a total order with no gaps. Retransmitted requests are deduped by
(proxy_id, request_num) (:834-843).

Deposition: the reference's master dies when the coordinated state moves past
its generation (its ReusableCoordinatedState writes start failing and the
worker kills the role). Here the master holds an explicit lease against the
coordinators: it peeks the cstate register (read-only, no ballot) and deposes
itself if a newer epoch appears OR the coordinator quorum is unreachable for a
lease period — so even a master partitioned away from the new cluster
controller stops renewing its proxies' GRV leases within a bounded time
(the fail-safe the recovery's grace period relies on).
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.interfaces import (
    GetCommitVersionReply, GetCommitVersionRequest, Token)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop


class Master:
    def __init__(self, process: SimProcess, recovery_version: int = 0,
                 epoch: int = 0, coordinators: list[str] | None = None):
        self.process = process
        self.loop = process.net.loop
        self.epoch = epoch
        self.coordinators = list(coordinators or [])
        self.deposed = False
        self.last_version_assigned = recovery_version
        self.last_version_time = self.loop.now()
        # proxy_id -> {request_num: reply} retransmit dedupe window. The
        # proxy's resolving gate keeps at most one version fetch outstanding
        # per proxy, but with the commit pipeline window > 1 a retransmit of
        # fetch N can still be in flight when fetch N+1 arrives — a depth-1
        # window would forget N and re-assign it a SECOND version, forking
        # the prevVersion chain. Keep a small bounded window per proxy.
        self._last_reply: dict[int, dict[int, GetCommitVersionReply]] = {}
        self._reply_window = 8
        self.counters = CounterCollection("Master", str(process.address))
        self._c_requests = self.counters.counter("VersionRequests")
        self._c_retransmits = self.counters.counter("Retransmits")
        self._c_versions = self.counters.counter("VersionsAdvanced")
        process.register(Token.MASTER_GET_COMMIT_VERSION, self._on_get_commit_version)
        process.register(Token.MASTER_PING, self._on_ping)
        process.register(Token.MASTER_DEPOSE, self._on_depose)
        process.register(Token.MASTER_METRICS, self._on_metrics)
        self._counters_task = trace_counters_loop(process, self.counters)
        self._lease_task = None
        if self.coordinators:
            self._lease_task = process.spawn(self._cstate_lease_loop(),
                                             "masterCstateLease")

    def shutdown(self):
        self._counters_task.cancel()
        if self._lease_task is not None:
            self._lease_task.cancel()

    def _on_metrics(self, req, reply):
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        snap = self.counters.as_dict()
        snap["LastVersionAssigned"] = self.last_version_assigned
        reply.send(fold_transport_counters(self.process, snap))

    def _on_ping(self, req, reply):
        """Proxy liveness lease: a proxy that cannot reach ITS (undeposed)
        master stops serving read versions, so a deposed generation cannot
        hand out stale snapshots after a recovery."""
        if self.deposed:
            reply.send_error(FDBError("master_recovery_failed", "deposed"))
        else:
            reply.send(self.epoch)

    def _on_depose(self, req, reply):
        """Fast-path fence from the recovering cluster controller; the cstate
        lease below is the backstop when this message cannot be delivered.
        Only STRICTLY older generations are fenced: when the new master is
        recruited onto the old master's worker, the depose (carrying the new
        epoch) arrives at the replacement and must not kill it."""
        if req is None or req > self.epoch:
            self.deposed = True
        reply.send(None)

    async def _cstate_lease_loop(self):
        from foundationdb_tpu_torch.server.coordination import (
            CoordToken, GenReadRequest)
        lease = KNOBS.MASTER_CSTATE_LEASE_SECONDS
        quorum = len(self.coordinators) // 2 + 1
        last_confirm = self.loop.now()
        while not self.deposed:
            votes = 0
            newer = False
            # probe every coordinator CONCURRENTLY: sequential timeouts would
            # stretch a probe round past the recovery grace period when the
            # quorum is unreachable, exactly when fast deposition matters
            futures = [self.loop.timeout(self.process.net.request(
                self.process, Endpoint(addr, CoordToken.GENERATION_PEEK),
                GenReadRequest(key="cstate", gen=0)), lease / 3)
                for addr in self.coordinators]
            for f in futures:
                try:
                    r = await f
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
                    continue
                votes += 1
                if r.value is not None and r.value.get("epoch", 0) > self.epoch:
                    newer = True
            if newer or (votes < quorum
                         and self.loop.now() - last_confirm > lease):
                self.deposed = True
                return
            if votes >= quorum:
                last_confirm = self.loop.now()
            await self.loop.delay(lease / 3)

    def _on_get_commit_version(self, req: GetCommitVersionRequest, reply):
        if self.deposed:
            reply.send_error(FDBError("master_recovery_failed", "deposed"))
            return
        if req.epoch != self.epoch:
            # a proxy from another generation must never consume a version
            # from THIS chain (it would push it to its own, locked, TLogs)
            reply.send_error(FDBError("master_recovery_failed",
                                      f"epoch {req.epoch} != {self.epoch}"))
            return
        self._c_requests.increment()
        window = self._last_reply.setdefault(req.proxy_id, {})
        prev = window.get(req.request_num)
        if prev is not None:
            self._c_retransmits.increment()
            reply.send(prev)  # retransmit: same version again
            return
        now = self.loop.now()
        advance = int((now - self.last_version_time) * KNOBS.VERSIONS_PER_SECOND)
        advance = max(1, min(advance, KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS))
        version = self.last_version_assigned + advance
        r = GetCommitVersionReply(version=version,
                                  prev_version=self.last_version_assigned)
        self._c_versions.increment(advance)
        self.last_version_assigned = version
        self.last_version_time = now
        window[req.request_num] = r
        while len(window) > self._reply_window:
            del window[min(window)]
        reply.send(r)
