"""Error model: the port's copy of foundationdb_tpu/utils/errors.py.

Mirrors the public error-code surface of the reference
(`flow/error_definitions.h`) so client code written against FoundationDB's
error numbers keeps working; the implementation is our own.

Errors are exceptions; `FDBError.is_retryable` captures the client retry-loop
contract of `fdbclient/NativeAPI.actor.cpp:2180` (Transaction::onError).
"""

from __future__ import annotations

# name -> (code, retryable) — the subset of flow/error_definitions.h that is
# part of the client-visible contract, plus internal codes the pipeline uses.
_ERRORS = {
    "success": (0, False),
    "end_of_stream": (1, False),
    "operation_failed": (1000, False),
    "timed_out": (1004, False),
    "coordinated_state_conflict": (1005, False),
    "coordinators_changed": (1008, False),
    "server_request_queue_full": (1006, False),
    "all_alternatives_failed": (1010, False),
    "transaction_too_old": (1007, True),
    "not_committed": (1020, True),
    "commit_unknown_result": (1021, True),
    "transaction_cancelled": (1025, False),
    "connection_failed": (1026, False),
    "worker_removed": (1028, False),
    "cluster_not_fully_recovered": (1033, False),
    "tlog_stopped": (1034, False),
    "broken_promise": (1100, False),
    "operation_cancelled": (1101, False),
    "future_released": (1102, False),
    "platform_error": (1500, False),
    "io_error": (1510, False),
    "file_not_found": (1511, False),
    "io_timeout": (1521, False),
    "file_corrupt": (1522, False),
    "client_invalid_operation": (2000, False),
    "commit_read_incomplete": (2002, False),
    "key_outside_legal_range": (2003, False),
    "inverted_range": (2004, False),
    "invalid_option_value": (2006, False),
    # bad knob/config at role boot (validate_storage_engine,
    # validate_conflict_config): fail fast, never fall back silently
    "invalid_option": (2007, False),
    "used_during_commit": (2017, True),
    "invalid_mutation_type": (2048, False),
    "key_too_large": (2102, False),
    "value_too_large": (2103, False),
    "transaction_too_large": (2101, False),
    "restore_invalid_version": (2224, False),
    "unknown_error": (4000, False),
    "internal_error": (4100, False),
    # Internal to the pipeline (not in the reference's numbering):
    "future_version": (1009, True),
    "wrong_shard_server": (1037, False),
    # a dropped/unanswered RPC: the request may or may not have been
    # delivered; safe to retry at the transaction level (the reference's
    # request_maybe_delivered contract for idempotent/retried requests)
    "request_maybe_delivered": (1038, True),
    # ratekeeper-driven contention throttle: the proxy refused a commit
    # touching a hot range; detail carries "<advised_backoff> <begin_hex>
    # <end_hex>" so on_error can wait the server-advised time (the
    # reference's tag_throttled, error_definitions.h 1213)
    "transaction_throttled": (1213, True),
    "master_recovery_failed": (1200, False),
    "master_tlog_failed": (1201, False),
    "master_proxy_failed": (1204, False),
    "master_resolver_failed": (1205, False),
    "recruitment_failed": (1206, False),
    "no_more_servers": (1008, False),
}

_BY_CODE: dict[int, str] = {}
for _name, (_code, _r) in _ERRORS.items():
    _BY_CODE.setdefault(_code, _name)


class FDBError(Exception):
    """An error with a FoundationDB-compatible numeric code."""

    def __init__(self, name: str, detail: str = ""):
        if name not in _ERRORS:
            raise ValueError(f"unknown error name: {name}")
        self.name = name
        self.code, self.is_retryable = _ERRORS[name]
        self.detail = detail
        super().__init__(f"{name} ({self.code})" + (f": {detail}" if detail else ""))

    def __reduce__(self):
        return (FDBError, (self.name, self.detail))


def error_code(name: str) -> int:
    return _ERRORS[name][0]


def error_name(code: int) -> str:
    """Numeric code -> canonical name (fdb_get_error analogue)."""
    return _BY_CODE.get(code, "unknown_error")


def is_retryable_code(code: int) -> bool:
    name = _BY_CODE.get(code)
    return bool(name and _ERRORS[name][1])


def err(name: str, detail: str = "") -> FDBError:
    return FDBError(name, detail)
