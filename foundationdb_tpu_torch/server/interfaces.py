"""Request/reply structs and well-known endpoint tokens of the resolver.

Copy of the resolver's part of foundationdb_tpu/server/interfaces.py
(reference: ResolverInterface.h:83-91). Payloads are plain dataclasses: the
simulator delivers them by reference. The token values are the JAX
package's, so the two packages can talk about the same endpoints.
"""

from __future__ import annotations

from dataclasses import dataclass


class Token:
    """Well-known endpoint tokens (fdbrpc/FlowTransport.h WLTOKEN_* pattern),
    the resolver's subset."""

    RESOLVER_RESOLVE = 20
    RESOLVER_METRICS = 21
    RESOLVER_HOT_RANGES = 22  # conflict-hotspot snapshot (ratekeeper/DD poll)


@dataclass
class ResolveTransactionBatchRequest:
    """ResolverInterface.h:83-91. (prev_version -> version) chains batches
    into a total order per resolver across all proxies.

    State (metadata) transactions are registered with every resolver via
    `state_txn_indices` (indices into `transactions`); their mutations ride
    in `state_txn_mutations`, parallel to the indices, mirroring
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
    state_mutations: list = None
