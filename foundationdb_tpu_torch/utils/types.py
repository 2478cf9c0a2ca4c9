"""Core data-plane types: mutations and atomic operations.

Reference surface:
- Mutation types: fdbclient/CommitTransaction.h:31 (MutationRef::Type).
- Atomic-op semantics: fdbclient/Atomic.h (doLittleEndianAdd :30, doAnd/doOr/
  doXor :60-105, doAppendIfFits :110, doMin/doMax :130-200, doByteMin/doByteMax
  :220, versionstamp transforms applied proxy-side).
- KeyRange semantics: fdbclient/FDBTypes.h (half-open [begin, end)).

The implementation is our own; only the observable semantics match, so every
binding/workload written against the reference behaves identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from foundationdb_tpu_torch.utils.errors import FDBError


class MutationType(IntEnum):
    """Numbering matches CommitTransaction.h:31 so serialized logs line up."""

    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD_VALUE = 2
    DEBUG_KEY_RANGE = 3
    DEBUG_KEY = 4
    NO_OP = 5
    AND = 6
    OR = 7
    XOR = 8
    APPEND_IF_FITS = 9
    AVAILABLE_FOR_REUSE = 10
    RESERVED_FOR_LOG_PROTOCOL_MESSAGE = 11
    MAX = 12
    MIN = 13
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15
    BYTE_MIN = 16
    BYTE_MAX = 17
    MIN_V2 = 18
    AND_V2 = 19


# Ops a client may pass to Transaction.atomic_op (reference:
# vexillographer/fdb.options MutationType section).
ATOMIC_OPS = frozenset({
    MutationType.ADD_VALUE, MutationType.AND, MutationType.OR, MutationType.XOR,
    MutationType.APPEND_IF_FITS, MutationType.MAX, MutationType.MIN,
    MutationType.BYTE_MIN, MutationType.BYTE_MAX, MutationType.MIN_V2,
    MutationType.AND_V2, MutationType.SET_VERSIONSTAMPED_KEY,
    MutationType.SET_VERSIONSTAMPED_VALUE,
})


@dataclass(frozen=True)
class Mutation:
    """One mutation: (type, param1, param2).

    SET_VALUE: param1=key, param2=value. CLEAR_RANGE: param1=begin, param2=end.
    Atomic ops: param1=key, param2=operand. (CommitTransaction.h:76 MutationRef)
    """

    type: MutationType
    param1: bytes
    param2: bytes

    def weight(self) -> int:
        return len(self.param1) + len(self.param2) + 12


def make_mutation(mtype: MutationType, param1: bytes, param2: bytes,
                  _new=object.__new__) -> Mutation:
    """Mutation constructor that skips the frozen-dataclass __init__ (three
    object.__setattr__ round-trips per instance). The client write path
    creates one Mutation per set/clear/atomic-op; at bench rates the
    generated __init__ is measurable. Field names must stay in sync with
    the dataclass above."""
    m = _new(Mutation)
    d = m.__dict__
    d["type"] = mtype
    d["param1"] = param1
    d["param2"] = param2
    return m


def mutations_weight(muts) -> int:
    """sum of Mutation.weight() over a batch without the per-mutation
    bound-method dispatch (the TLog calls this once per push/peek/pop for
    every mutation it moves)."""
    return sum(len(m.param1) + len(m.param2) for m in muts) + 12 * len(muts)


@dataclass(frozen=True)
class KeyRange:
    """Half-open [begin, end). Empty when end <= begin."""

    begin: bytes
    end: bytes

    def contains(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def intersects(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def __bool__(self) -> bool:
        return self.begin < self.end


# ---------------------------------------------------------------------------
# atomic-op evaluation (applied at storage servers and by the RYW overlay)
# ---------------------------------------------------------------------------

def _le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _int_to_le(v: int, width: int) -> bytes:
    return (v % (1 << (8 * width))).to_bytes(width, "little") if width else b""


def _pad_to(b: bytes, width: int) -> bytes:
    return b + b"\x00" * (width - len(b)) if len(b) < width else b[:width]


def apply_atomic_op(op: MutationType, existing: bytes | None, operand: bytes,
                    value_size_limit: int = 100_000) -> bytes:
    """Pure function computing the post-state of one atomic mutation.

    Semantics follow fdbclient/Atomic.h with the v2 fixes the reference made
    default at API 520+ (missing operand treated as zeros for AND; MIN of a
    missing value yields the operand).
    """
    if op == MutationType.ADD_VALUE:
        if not operand:
            return b""
        ex = existing or b""
        width = len(operand)
        return _int_to_le(_le_to_int(_pad_to(ex, width)) + _le_to_int(operand), width)
    if op in (MutationType.AND, MutationType.AND_V2):
        if existing is None:
            # AND_V2 (Atomic.h doAndV2): missing value acts as zeros
            return b"\x00" * len(operand)
        width = len(operand)
        ex = _pad_to(existing, width)
        return bytes(a & b for a, b in zip(ex, operand))
    if op == MutationType.OR:
        ex = _pad_to(existing or b"", len(operand))
        return bytes(a | b for a, b in zip(ex, operand))
    if op == MutationType.XOR:
        ex = _pad_to(existing or b"", len(operand))
        return bytes(a ^ b for a, b in zip(ex, operand))
    if op == MutationType.APPEND_IF_FITS:
        ex = existing or b""
        return ex + operand if len(ex) + len(operand) <= value_size_limit else ex
    if op == MutationType.MAX:
        if not operand:
            return existing or b""
        ex = _pad_to(existing or b"", len(operand))
        return operand if _le_to_int(operand) >= _le_to_int(ex) else ex
    if op in (MutationType.MIN, MutationType.MIN_V2):
        if existing is None:
            # MIN_V2 (Atomic.h doMinV2): missing value -> operand wins
            return operand
        if not operand:
            return b""
        ex = _pad_to(existing, len(operand))
        return operand if _le_to_int(operand) < _le_to_int(ex) else ex
    if op == MutationType.BYTE_MIN:
        if existing is None:
            return operand
        return min(existing, operand)
    if op == MutationType.BYTE_MAX:
        if existing is None:
            return operand
        return max(existing, operand)
    raise FDBError("invalid_mutation_type", f"atomic op {op}")


# Versionstamps: a 10-byte value (8-byte big-endian commit version + 2-byte
# big-endian batch order) substituted proxy-side at commit time
# (CommitTransaction.h versionstamp discussion; applied where the client left
# a 4-byte little-endian offset trailer, API >= 520).

def make_versionstamp(commit_version: int, batch_order: int) -> bytes:
    return commit_version.to_bytes(8, "big") + (batch_order & 0xFFFF).to_bytes(2, "big")


def substitute_versionstamp(param: bytes, stamp: bytes) -> bytes:
    """Replace the 10 bytes at the trailing 4-byte LE offset with `stamp`."""
    if len(param) < 4:
        raise FDBError("client_invalid_operation", "versionstamp param too short")
    offset = int.from_bytes(param[-4:], "little")
    body = param[:-4]
    if offset + 10 > len(body):
        raise FDBError("client_invalid_operation", "versionstamp offset out of range")
    return body[:offset] + stamp + body[offset + 10:]
