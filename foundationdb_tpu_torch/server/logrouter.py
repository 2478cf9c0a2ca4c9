"""LogRouter role: the remote region's window into the primary log system.

Reference: fdbserver/LogRouter.actor.cpp — a log router pulls its tags from
the primary region's log system ONCE across the WAN (pullAsyncData) and
re-serves them to the remote region's storage servers through the ordinary
TLog peek/pop surface (logRouterPeekMessages :283, logRouterPop :372), so N
remote replicas cost one WAN stream per tag instead of N. Pops forward
upstream (:392) once the remote consumer has made the data durable, which is
what lets the primary TLogs (and satellites) truncate for remote tags.

Here the router is an entry in the worker's TLogHost (uid-routed, exactly
like a TLog generation): remote storage servers are recruited with
log_epochs whose last entry points at router addresses, and the rest of the
storage/cursor machinery works unchanged — the IPeekCursor seam's promise
that a log router is "just another peek source".
"""

from __future__ import annotations

from collections import deque

from foundationdb_tpu_torch.core.notified import NotifiedVersion
from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.interfaces import (
    LogEpoch, TLogPeekReply, TLogPopRequest, Token)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS


class LogRouter:
    """Pulls `tags` from the primary log system epochs and re-serves them.

    Buffering is bounded by consumption: pulling pauses once the un-popped
    buffer for a tag exceeds LOG_ROUTER_BUFFER_VERSIONS of versions ahead of
    its pop floor (the reference bounds by bytes with
    LOG_ROUTER_MAX_SEARCH_MEMORY; versions are the sim's natural unit).
    """

    def __init__(self, process: SimProcess, uid: str, tags: list[int],
                 epochs: list[LogEpoch], begin: int = 0):
        self.process = process
        self.uid = uid
        self.tags = list(tags)
        self.epochs = list(epochs)
        # per-tag: buffered pages, covered-through watermark, pop floor
        self.buffers: dict[int, deque] = {t: deque() for t in self.tags}
        self.covered: dict[int, NotifiedVersion] = {
            t: NotifiedVersion(begin) for t in self.tags}
        self.popped: dict[int, int] = {t: begin for t in self.tags}
        self.known_committed = begin
        self._begin = {t: begin for t in self.tags}
        self._tasks = [process.spawn(self._pull(t), f"lrPull{t}")
                       for t in self.tags]

    def shutdown(self):
        for t in self._tasks:
            t.cancel()

    async def _pull(self, tag: int):
        from foundationdb_tpu_torch.server.logsystem import PeekCursor
        loop = self.process.net.loop
        cursor = PeekCursor(self.process, self.epochs, tag, self._begin[tag],
                            refresh=lambda t=tag: (self.epochs,
                                                   self._begin[t]))
        while True:
            # flow control: don't run unboundedly ahead of the consumer
            while (self._begin[tag] - self.popped[tag]
                   > KNOBS.LOG_ROUTER_BUFFER_VERSIONS):
                await loop.delay(0.2)
            epoch, reply = await cursor.get_more()
            if reply is None:
                continue
            self.known_committed = max(self.known_committed,
                                       reply.known_committed_version)
            buf = self.buffers[tag]
            for version, muts in reply.messages:
                if version <= self._begin[tag]:
                    continue
                if epoch.end is not None and version > epoch.end:
                    break
                buf.append((version, muts))
                self._begin[tag] = version
            end_v = reply.end - 1
            if epoch.end is not None:
                end_v = min(end_v, epoch.end)
            if end_v > self._begin[tag]:
                self._begin[tag] = end_v
            if self._begin[tag] > self.covered[tag].get():
                self.covered[tag].set(self._begin[tag])

    # -- the TLog surface (TLogHost routes by uid) --

    def _on_peek(self, req, reply):
        self.process.spawn(self._peek(req, reply), "lrPeek")

    async def _peek(self, req, reply):
        if req.tag not in self.buffers:
            reply.send_error(FDBError("tlog_stopped",
                                      f"tag {req.tag} not routed here"))
            return
        # long-poll like the TLog: block until the router covers `begin`
        await self.covered[req.tag].when_at_least(req.begin)
        budget = KNOBS.TLOG_PEEK_REPLY_BYTES
        out: list[tuple[int, list]] = []
        last_v = req.begin - 1
        for v, muts in self.buffers[req.tag]:
            if v < req.begin:
                continue
            out.append((v, list(muts)))
            budget -= sum(m.weight() for m in muts)
            last_v = v
            if budget <= 0:
                break
        end = (last_v + 1) if budget <= 0 else self.covered[req.tag].get() + 1
        reply.send(TLogPeekReply(
            messages=out, end=end, popped=self.popped.get(req.tag, 0),
            known_committed_version=self.known_committed))

    def _on_pop(self, req: TLogPopRequest, reply):
        """Drop the local buffer and FORWARD the pop to the primary log
        system (LogRouter.actor.cpp:392): the remote consumer made the data
        durable, so every upstream holder of this tag may truncate."""
        if req.tag in self.popped:
            self.popped[req.tag] = max(self.popped[req.tag], req.version)
            buf = self.buffers[req.tag]
            while buf and buf[0][0] < req.version:
                buf.popleft()
            sent: set[tuple[str, str]] = set()
            for ep in self.epochs:
                for i, addr in enumerate(ep.addrs):
                    key = (addr, ep.uid_of(i))
                    if key in sent:
                        continue
                    sent.add(key)
                    self.process.net.one_way(
                        self.process, Endpoint(addr, Token.TLOG_POP),
                        TLogPopRequest(tag=req.tag, version=req.version,
                                       uid=ep.uid_of(i)))
        reply.send(None)

    def _on_commit(self, req, reply):
        reply.send_error(FDBError("tlog_stopped", "log router takes no commits"))

    def _on_lock(self, req, reply):
        reply.send_error(FDBError("tlog_stopped", "log router takes no locks"))
