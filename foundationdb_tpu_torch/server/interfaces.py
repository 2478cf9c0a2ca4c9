"""Request/reply structs and well-known endpoint tokens.

Reference: the *Interface.h headers — MasterInterface.h (GetCommitVersion),
ResolverInterface.h:83-91 (ResolveTransactionBatchRequest),
TLogInterface.h (TLogCommitRequest, TLogPeekRequest, TLogPopRequest),
StorageServerInterface.h (GetValueRequest, GetKeyValuesRequest, WatchValue),
MasterProxyInterface.h (CommitTransactionRequest, GetReadVersionRequest).

The port's copy of foundationdb_tpu/server/interfaces.py, token values
included. Payloads are plain dataclasses: the simulator delivers them by
reference (the real transport will serialize; see core/sim.py). Every
request that expects a reply carries it via the sim's reply-promise
mechanism, not a field here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.utils.types import Mutation


# Well-known endpoint tokens (fdbrpc/FlowTransport.h WLTOKEN_* pattern).
# Every token here must be BOTH registered by a role and reachable from a
# send site (protolint PROTO001); dead declarations were removed — their
# integers stay retired so a revived token cannot collide with frames from
# a mixed-version peer (4, 12, 15, 43, 97, 98 are burned).
class Token:
    MASTER_GET_COMMIT_VERSION = 1
    MASTER_PING = 2
    MASTER_DEPOSE = 3
    PROXY_COMMIT = 10
    PROXY_GET_READ_VERSION = 11
    PROXY_GET_COMMITTED_VERSION = 13
    PROXY_PING = 14
    RESOLVER_RESOLVE = 20
    RESOLVER_HOT_RANGES = 22  # conflict-hotspot snapshot (ratekeeper/DD poll)
    TLOG_COMMIT = 30
    TLOG_PEEK = 31
    TLOG_POP = 32
    STORAGE_GET_VALUE = 40
    STORAGE_GET_KEY_VALUES = 41
    STORAGE_GET_VALUES = 48  # batched point reads
    STORAGE_WATCH_VALUE = 42
    TLOG_LOCK = 33
    STORAGE_SET_LOGSYSTEM = 44
    STORAGE_GET_METRICS = 45
    STORAGE_ADD_SHARD = 46
    STORAGE_SET_SHARDS = 47
    RK_GET_RATE = 80
    QUEUE_STATS = 81
    WORKER_PING = 90
    WORKER_INIT_ROLE = 91
    CC_REGISTER_WORKER = 95
    CC_GET_DBINFO = 96
    CC_GET_STATUS = 99
    # Per-role counter snapshots for status aggregation (Status.actor.cpp's
    # workerEventsFetcher analogue): reply is a plain dict of counter
    # values. Each lives in its role's decade block, skipping burned ints.
    MASTER_METRICS = 5
    PROXY_METRICS = 16
    RESOLVER_METRICS = 21
    TLOG_METRICS = 34
    STORAGE_METRICS = 49
    RK_METRICS = 82


_TOKEN_NAMES_CACHE: dict[int, str] | None = None


def token_name(value: int) -> str:
    """Reverse lookup for diagnostics: 30 -> "TLOG_COMMIT". Covers
    CoordToken too; unknown values format as "token:<n>" so log lines stay
    greppable either way."""
    global _TOKEN_NAMES_CACHE
    names = _TOKEN_NAMES_CACHE
    if names is None:
        names = {v: k for k, v in vars(Token).items()
                 if not k.startswith("_") and isinstance(v, int)}
        from foundationdb_tpu_torch.server.coordination import CoordToken
        for k, v in vars(CoordToken).items():
            if not k.startswith("_") and isinstance(v, int):
                names.setdefault(v, k)
        _TOKEN_NAMES_CACHE = names
    return names.get(value, f"token:{value}")


# --- master ---

@dataclass
class GetCommitVersionRequest:
    """masterserver.actor.cpp:822 getVersion. requestNum dedupes retransmits.

    epoch fences deposed generations: well-known tokens are re-registered at
    the same address by each recruitment, so without the fence a zombie
    proxy could consume versions from the NEW master's chain and push them
    only to its own LOCKED TLogs — a permanent gap that wedges every
    later batch of the new generation (the reference avoids this with
    per-recruitment interface UIDs)."""

    proxy_id: int
    request_num: int
    epoch: int = 0


@dataclass
class GetCommitVersionReply:
    version: int
    prev_version: int


# --- proxy ---

@dataclass
class CommitTransactionRequest:
    """CommitTransaction.h:89-121 CommitTransactionRef + request wrapper."""

    read_snapshot: int
    read_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    write_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    mutations: list[Mutation] = field(default_factory=list)
    # Client-side span id for TraceBatch stitching (NativeAPI's
    # debugTransaction). Trailing + defaulted: wire-compatible with older
    # peers (utils/wire.py fills missing trailing fields from defaults).
    debug_id: str | None = None


@dataclass
class CommitReply:
    """CommitID on success; errors travel as FDBError through the reply."""

    version: int


@dataclass
class GetReadVersionRequest:
    """MasterProxyInterface.h GetReadVersionRequest (flags/priority subset)."""

    priority: int = 0
    debug_id: str | None = None  # client span id (trailing: wire-compatible)
    # how many client transactions this (batched) request stands for: the
    # client's GRV batcher coalesces N concurrent waiters into ONE wire
    # request, and the proxy both spends N ratekeeper tokens and counts N
    # GRVs served — the reference's transactionCount on
    # GetReadVersionRequest. Trailing-defaulted: wire-compatible with
    # older encoders (decoders fill 1).
    count: int = 1


@dataclass
class GetReadVersionReply:
    version: int


# --- resolver ---

@dataclass
class ResolveTransactionBatchRequest:
    """ResolverInterface.h:83-91. (prev_version -> version) chains batches
    into a total order per resolver across all proxies.

    State (metadata) transactions — those with mutations on the \\xff
    system keyspace — are registered with EVERY resolver via
    `state_txn_indices` (indices into `transactions`); their mutations ride
    only in resolver 0's request (`state_txn_mutations`, parallel to the
    indices; empty lists elsewhere), mirroring
    MasterProxyServer.actor.cpp:307-311 / ResolutionRequestBuilder."""

    prev_version: int
    version: int
    last_receive_version: int  # this proxy's own previous batch version
    transactions: list  # list[TxnConflictInfo]
    proxy_id: int = 0
    state_txn_indices: list = None  # list[int] | None
    state_txn_mutations: list = None  # list[list[Mutation]] | None


@dataclass
class ResolveTransactionBatchReply:
    committed: list[int]  # per-txn {CONFLICT, TOO_OLD, COMMITTED}
    # state txns from versions in (last_receive_version, version) — other
    # proxies' batches this proxy hasn't seen (Resolver.actor.cpp:170-190):
    # [(version, [(locally_committed, mutations), ...]), ...] version-sorted.
    # A proxy ANDs `locally_committed` across ALL resolvers' replies for the
    # global verdict (MasterProxyServer.actor.cpp:452-489).
    state_mutations: list = None


# --- tlog ---

@dataclass
class TLogCommitRequest:
    """TLogInterface.h TLogCommitRequest: version-ordered mutation push.
    `epoch` routes to the right generation on a shared TLog host."""

    prev_version: int
    version: int
    messages: dict[int, list[Mutation]]  # tag -> mutations for that tag
    known_committed_version: int = 0
    uid: str = ""


@dataclass
class TLogCommitReply:
    version: int


@dataclass
class TLogPeekRequest:
    """Pull messages for `tag` with version >= begin (ILogSystem::peek)."""

    tag: int
    begin: int
    uid: str = ""  # generation to peek on a shared TLog host


@dataclass
class TLogPeekReply:
    messages: list[tuple[int, list[Mutation]]]  # [(version, mutations)]
    end: int  # exclusive: peeker has everything < end for this tag
    popped: int
    # highest fully-acknowledged commit the pushers reported; storage caps
    # engine durability here so an unacked mutation can never outlive a
    # recovery rollback (storageserver updateStorage / kcv semantics)
    known_committed_version: int = 0


@dataclass
class TLogPopRequest:
    """Advance the durable point: messages for tag below `version` may go."""

    tag: int
    version: int
    uid: str = ""  # generation to pop on a shared TLog host


# --- storage ---

@dataclass
class GetValueRequest:
    key: bytes
    version: int


@dataclass
class GetValueReply:
    value: bytes | None
    version: int


@dataclass
class GetValuesRequest:
    """Batched point reads: the client-side read batcher coalesces every
    concurrent `get` bound for one storage team into a single RPC (the
    readVersionBatcher pattern of NativeAPI.actor.cpp:2709 applied to the
    data path — amortizing per-message cost is what lets a Python host
    approach the reference's per-core read rates)."""

    reads: list  # [(key, version), ...]


@dataclass
class GetValuesReply:
    """Parallel to request.reads: (0, value-or-None) | (1, error name).
    Per-key errors (wrong_shard_server on a moved key, transaction_too_old)
    must not fail the whole batch."""

    results: list


@dataclass
class KeySelector:
    """FDBTypes.h KeySelectorRef: resolves to a key by (base, or_equal, offset).

    first_greater_or_equal(k)  = (k, False, 1)
    first_greater_than(k)      = (k, True, 1)
    last_less_or_equal(k)      = (k, True, 0)
    last_less_than(k)          = (k, False, 0)
    """

    key: bytes
    or_equal: bool
    offset: int

    @staticmethod
    def first_greater_or_equal(key: bytes) -> "KeySelector":
        return KeySelector(key, False, 1)

    @staticmethod
    def first_greater_than(key: bytes) -> "KeySelector":
        return KeySelector(key, True, 1)

    @staticmethod
    def last_less_or_equal(key: bytes) -> "KeySelector":
        return KeySelector(key, True, 0)

    @staticmethod
    def last_less_than(key: bytes) -> "KeySelector":
        return KeySelector(key, False, 0)


@dataclass
class GetKeyValuesRequest:
    """storageserver.actor.cpp:1210 getKeyValues (selectors resolved server-side)."""

    begin: KeySelector
    end: KeySelector
    version: int
    limit: int = 0  # 0 = unlimited (subject to byte limit)
    limit_bytes: int = 0  # 0 = knob default
    reverse: bool = False


@dataclass
class GetKeyValuesReply:
    data: list[tuple[bytes, bytes]]
    more: bool
    version: int


@dataclass
class WatchValueRequest:
    """storageserver.actor.cpp:842 watchValueQ: resolve when value != expected."""

    key: bytes
    value: bytes | None  # value the client last saw
    version: int


# --- recovery / recruitment (WorkerInterface.h Initialize*Request family) ---

@dataclass
class TLogLockRequest:
    """Epoch end (ILogSystem::epochEnd): stop accepting commits; report how
    far this log got. masterserver recoverFrom locks the old generation."""

    epoch: int  # the NEW generation doing the locking (fence marker)
    uid: str = ""  # generation being locked (routing on a shared host)


@dataclass
class TLogLockReply:
    known_committed_version: int
    durable_version: int


@dataclass
class LogEpoch:
    """One generation of the log system (LogSystemConfig.h oldTLogs entry):
    versions in (begin, end] are served by these TLogs (end None = current).
    `uids` (parallel to addrs) are the per-instance generation ids that route
    requests on shared TLog hosts — UNIQUE per recovery attempt, so racing
    recoveries can never collide on a host (the reference's TLog UIDs in
    LogSystemConfig). `epoch` is the generation number."""

    begin: int
    end: int | None
    addrs: list[str]
    epoch: int = 0
    uids: list[str] | None = None  # None -> [""] per addr (direct clusters)
    # two-region: the first n_primary addrs are the primary-region TLogs,
    # the rest are SATELLITE TLogs (synchronously quorumed outside the
    # primary DC, TagPartitionedLogSystem's satellite log set). Peeks, pops
    # and locks treat them uniformly — every member holds every tag — but
    # the proxy's push quorum is per set, rebuilt from this split. None =
    # single-region epoch (all addrs primary).
    n_primary: int | None = None

    def uid_of(self, i: int) -> str:
        return self.uids[i] if self.uids else ""


@dataclass
class SetLogSystemRequest:
    """Master -> storage after recovery: new epoch list + rollback point
    (storageserver rollback :2211 discards versions the new log system does
    not know)."""

    epochs: list  # list[LogEpoch]
    rollback_to: int
    recovery_count: int


@dataclass
class GetStorageMetricsRequest:
    """StorageMetrics sampling (fdbserver/StorageMetrics.actor.h): byte
    counts + a split-point candidate per queried range, for the data
    distributor's shard tracker."""

    ranges: list  # list[(begin, end|None)]


@dataclass
class ShardMetrics:
    bytes: int
    split_key: bytes | None  # median key, None if too few rows


@dataclass
class AddShardRequest:
    """MoveKeys destination half (fetchKeys, storageserver.actor.cpp:1775):
    pause ingestion, snapshot [begin, end) from `source` at the current
    applied version, splice it in, extend the served ranges, resume. The
    fence version proves every mutation after it is dual-routed to this
    server's tag."""

    begin: bytes
    end: bytes | None
    source: str  # storage address to fetch the snapshot from
    fence_version: int


@dataclass
class SetShardsRequest:
    """Replace the served ranges (MoveKeys source side after the handoff).

    layout_version orders pushes: SET_SHARDS travels one_way, and a clogged
    link delays (and can reorder) packets — a stale assignment arriving after
    a newer one must not resurrect ranges the server no longer receives
    mutations for. None (direct tests) always applies."""

    shard_ranges: list  # list[(begin, end|None)]
    layout_version: tuple | None = None  # (epoch, DBInfo.version) at push
    # commit version of the metadata txn this layout reflects: the server
    # drops shard revocations fenced at/below it (the layout accounts for
    # those moves), while a delayed stale push — carrying an older version —
    # can never lift a newer fence. None (legacy/tests) lifts nothing.
    as_of_version: int | None = None


@dataclass
class UpdateShardsRequest:
    """RETIRED: shard-map changes now flow as \\xff/keyServers metadata
    transactions through the commit pipeline (systemdata.py). Kept only to
    pin wire id 32 (the registry is append-only)."""

    boundaries: list
    tags: list  # list[list[int]]


@dataclass
class InitRoleRequest:
    """worker.actor.cpp:694-794 InitializeTLog/Storage/Proxy/ResolverRequest,
    collapsed into one parameterized request."""

    role: str  # "tlog" | "storage" | "proxy" | "resolver" | "master"
    args: dict


@dataclass
class InitRoleReply:
    address: str
    incarnation: int = 0  # worker reboot count at recruit time


@dataclass
class RegisterWorkerRequest:
    address: str
    roles: list[str]
    # ProcessClass (fdbrpc/Locality.h): ranks this worker's fitness for each
    # role during recruitment ("stateless" | "transaction" | "storage" |
    # "unset")
    process_class: str = "unset"
    # LocalityData attributes (zone/machine default to the process itself)
    zone_id: str = ""
    machine_id: str = ""
    dc_id: str = ""


@dataclass
class DBInfo:
    """ServerDBInfo: everything a worker/client needs to find the cluster.
    Broadcast by the CC (ClusterController.actor.cpp ServerDBInfo)."""

    version: int
    epoch: int
    master: str | None
    proxies: list[str]
    resolvers: list[str]
    log_epochs: list  # list[LogEpoch]
    storages: list[tuple[str, int]]  # (address, tag)
    shard_boundaries: list[bytes]
    recovery_state: str = "unrecovered"
    ratekeeper: str | None = None
    # team per shard: the tags of the replicas serving shard i
    # (DDTeamCollection's server teams, DataDistribution.actor.cpp:515)
    shard_tags: list[list[int]] | None = None
    # dedicated GRV proxies (the grv_proxy/commit_proxy role split): clients
    # route read-version requests here when non-empty, commits to `proxies`.
    # Trailing-defaulted for wire compatibility with older encoders.
    grv_proxies: list[str] = field(default_factory=list)

    def teams(self) -> list[list[int]]:
        """shard -> replica tags, defaulting to the single-replica identity
        layout — THE source of truth for every consumer (client location
        cache, worker storage restore, consistency checker)."""
        return self.shard_tags or [[i] for i in
                                   range(len(self.shard_boundaries))]
