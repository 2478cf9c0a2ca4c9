"""Error model: the port's copy of foundationdb_tpu/utils/errors.py,
trimmed to the errors the resolver slice uses.

Codes mirror the reference's `flow/error_definitions.h`. Errors are
exceptions; `FDBError.is_retryable` is the client retry-loop contract of
`fdbclient/NativeAPI.actor.cpp:2180` (Transaction::onError).
"""

from __future__ import annotations

# name -> (code, retryable): the codes of flow/error_definitions.h (and the
# JAX package's pipeline codes) that the resolver slice raises or sees.
_ERRORS = {
    "end_of_stream": (1, False),
    "timed_out": (1004, False),
    "broken_promise": (1100, False),
    "operation_cancelled": (1101, False),
    "platform_error": (1500, False),
    # bad knob/config at role boot: fail fast, never fall back silently
    "invalid_option": (2007, False),
    "transaction_too_large": (2101, False),
    "internal_error": (4100, False),
    # a dropped/unanswered RPC: it may or may not have been delivered
    "request_maybe_delivered": (1038, True),
}


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
