"""Ratekeeper: cluster-wide admission control.

Reference: fdbserver/Ratekeeper.actor.cpp — updateRate (:250) computes a
transactions-per-second budget from smoothed storage durability lag and TLog
queue depth; proxies fetch it with GetRateInfoRequest (rateKeeper :508 /
MasterProxyServer getRate :86) and gate read-version handouts with it, which
throttles ingest at the front door instead of letting server queues grow
without bound.

Here the worst storage lag (latest applied version - durable version) and the
worst TLog in-memory queue depth each scale the budget down proportionally
when they exceed their targets; the final rate is the min of the two,
exponentially smoothed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.hotspot import HotRangeSketch, ThrottleEntry
from foundationdb_tpu_torch.server.interfaces import Token
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop
from foundationdb_tpu_torch.utils.trace import TraceEvent


@dataclass
class RateInfoReply:
    tps: float  # transaction starts per second this proxy may grant
    # hot ranges each proxy must gate commits against (ThrottleEntry list;
    # trailing + defaulted so the extension is wire-compatible with peers
    # that still send/expect the bare-tps schema)
    throttles: list = field(default_factory=list)


@dataclass
class QueueStatsReply:
    """TLog/storage health sample (TLogQueuingMetrics / StorageQueuingMetrics)."""

    queue_bytes: int = 0  # TLog: un-popped in-memory bytes
    lag_versions: int = 0  # storage: version - durable_version


class Ratekeeper:
    def __init__(self, process: SimProcess,
                 tlogs: list[str] | None = None,
                 storages: list[str] | None = None,
                 resolvers: list[str] | None = None):
        self.process = process
        self.loop = process.net.loop
        self.tlogs = list(tlogs or [])
        self.storages = list(storages or [])
        self.resolvers = list(resolvers or [])
        self.tps = KNOBS.RK_BASE_TPS
        # ThrottleEntry list recomputed each update round from the merged
        # resolver hot-range snapshots (docs/contention.md)
        self.throttles: list[ThrottleEntry] = []
        self.stats = {"worst_tlog_bytes": 0, "worst_storage_lag": 0,
                      "hot_total_rate": 0.0}
        self.counters = CounterCollection("Ratekeeper", str(process.address))
        self._c_rate_reqs = self.counters.counter("RateRequests")
        self._c_updates = self.counters.counter("UpdateRounds")
        # control-loop gauges (set, not incremented): the last sampled worsts
        # and the current budget
        self._g_tps = self.counters.counter("TPS")
        self._g_worst_log = self.counters.counter("WorstTLogBytes")
        self._g_worst_lag = self.counters.counter("WorstStorageLag")
        self._g_throttled = self.counters.counter("ThrottledRanges")
        self._g_hot_rate = self.counters.counter("HotConflictRate")
        self._g_tps.set(self.tps)
        process.register(Token.RK_GET_RATE, self._on_get_rate)
        process.register(Token.RK_METRICS, self._on_metrics)
        self._task = process.spawn(self._update_loop(), "rateKeeper")
        self._counters_task = trace_counters_loop(process, self.counters)

    def shutdown(self):
        self._task.cancel()
        self._counters_task.cancel()

    def _on_metrics(self, req, reply):
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        reply.send(fold_transport_counters(self.process,
                                           self.counters.as_dict()))

    def _on_get_rate(self, req, reply):
        n = max(1, req if isinstance(req, int) else 1)  # proxies share the budget
        self._c_rate_reqs.increment()
        # the throttle release budget is fleet-wide: each proxy gets 1/n of it
        throttles = [ThrottleEntry(begin=t.begin, end=t.end,
                                   release_tps=t.release_tps / n,
                                   backoff=t.backoff)
                     for t in self.throttles]
        reply.send(RateInfoReply(tps=self.tps / n, throttles=throttles))

    async def _sample(self, addr: str) -> QueueStatsReply | None:
        try:
            return await self.loop.timeout(self.process.net.request(
                self.process, Endpoint(addr, Token.QUEUE_STATS), None), 1.0)
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            return None

    async def _sample_hot(self, addr: str):
        try:
            return await self.loop.timeout(self.process.net.request(
                self.process, Endpoint(addr, Token.RESOLVER_HOT_RANGES),
                KNOBS.HOTSPOT_TOP_K), 1.0)
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            return None

    def _compute_throttles(self, hot_replies: list) -> list[ThrottleEntry]:
        """Merge per-resolver hot-range snapshots and throttle every range
        whose summed conflict rate clears RK_THROTTLE_CONFLICT_RATE. The
        advised backoff scales with how far over the threshold the range is
        (hotter range -> longer advised wait), capped at the knob ceiling.
        Deterministic: merge keys are exact ranges, output sorted hottest
        first with (begin, end) tie-breaks — same snapshots, same list."""
        merged: dict[tuple[bytes, bytes], float] = {}
        total = 0.0
        for r in hot_replies:
            if r is None:
                continue
            total += r.total_rate
            for hr in r.ranges:
                key = (hr.begin, hr.end)
                merged[key] = merged.get(key, 0.0) + hr.rate
        self.stats["hot_total_rate"] = total
        threshold = KNOBS.RK_THROTTLE_CONFLICT_RATE
        hot = []
        for (begin, end), rate in merged.items():
            if rate < threshold:
                continue
            backoff = min(KNOBS.RK_THROTTLE_MAX_BACKOFF,
                          KNOBS.RK_THROTTLE_BACKOFF * rate / threshold)
            hot.append((rate, ThrottleEntry(
                begin=begin, end=end,
                release_tps=KNOBS.RK_THROTTLE_RELEASE_TPS, backoff=backoff)))
        hot.sort(key=lambda rt: (-rt[0], rt[1].begin, rt[1].end))
        return [t for _rate, t in hot]

    async def _update_loop(self):
        smoothing = KNOBS.RK_SMOOTHING
        while True:
            # sample everyone concurrently: sequential 1s timeouts would slow
            # the control loop to O(n) seconds exactly when servers are dead
            log_f = [self.loop.spawn(self._sample(a), "rkSample")
                     for a in self.tlogs]
            lag_f = [self.loop.spawn(self._sample(a), "rkSample")
                     for a in self.storages]
            hot_f = ([self.loop.spawn(self._sample_hot(a), "rkHotSample")
                      for a in self.resolvers]
                     if KNOBS.CONTENTION_THROTTLE_ENABLED else [])
            worst_log = 0
            for f in log_f:
                s = await f
                if s is not None:
                    worst_log = max(worst_log, s.queue_bytes)
            worst_lag = 0
            for f in lag_f:
                s = await f
                if s is not None:
                    worst_lag = max(worst_lag, s.lag_versions)
            hot_replies = [await f for f in hot_f]
            self.throttles = (self._compute_throttles(hot_replies)
                              if KNOBS.CONTENTION_THROTTLE_ENABLED else [])
            if self.throttles:
                TraceEvent("RkThrottleList", self.process.address) \
                    .detail("Ranges", len(self.throttles)) \
                    .detail("Hottest", self.throttles[0].begin.hex()) \
                    .detail("Backoff", round(self.throttles[0].backoff, 3)) \
                    .log()
            self.stats["worst_tlog_bytes"] = worst_log
            self.stats["worst_storage_lag"] = worst_lag
            self._c_updates.increment()
            # Counter gauges, not promise gates: nothing awaits them,
            # so no settle discipline applies
            self._g_worst_log.set(worst_log)  # flowlint: ignore[FLOW002]
            self._g_worst_lag.set(worst_lag)  # flowlint: ignore[FLOW002]
            self._g_throttled.set(len(self.throttles))  # flowlint: ignore[FLOW002]
            self._g_hot_rate.set(  # flowlint: ignore[FLOW002]
                round(self.stats["hot_total_rate"], 2))

            scale = 1.0
            if worst_log > KNOBS.RK_TARGET_TLOG_BYTES:
                scale = min(scale, KNOBS.RK_TARGET_TLOG_BYTES / worst_log)
            if worst_lag > KNOBS.RK_TARGET_STORAGE_LAG_VERSIONS:
                scale = min(scale,
                            KNOBS.RK_TARGET_STORAGE_LAG_VERSIONS / worst_lag)
            target = KNOBS.RK_BASE_TPS * scale
            self.tps = (1 - smoothing) * self.tps + smoothing * target
            self._g_tps.set(round(self.tps, 2))  # flowlint: ignore[FLOW002]
            await self.loop.delay(KNOBS.RK_UPDATE_INTERVAL)
