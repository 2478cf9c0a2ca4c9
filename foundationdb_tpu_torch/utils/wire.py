"""Versioned, typed wire/durable encoding — the serialize.h equivalent.

Reference: flow/serialize.h:188-241 (BinaryWriter/BinaryReader with protocol
versioning) and fdbrpc's ObjectSerializer. The reference serializes typed
structs field-by-field behind a protocol version; deserialization never
executes arbitrary code. This module does the same for the framework's
dataclass payloads: a small tagged binary format plus an explicit type
registry. Unlike pickle, decode can only build
whitelisted types — safe on untrusted bytes — and the format is versioned so
mixed-version clusters can reject frames they don't understand.

Format: one message = MAGIC byte, version byte, then one value.
Value = tag byte + payload:
  N none | T/F bool | i zigzag-varint int | d f64 | b bytes | s utf8 str
  l list | t tuple | m dict | S set | E enum (type-id varint + value varint)
  R registered struct: type-id varint, field-count varint, field values in
    dataclass declaration order. A decoder with a NEWER schema fills missing
    trailing fields from defaults; with an OLDER schema it ignores extras —
    the same forward/backward rule protocol-versioned BinaryReader gives the
    reference.

Struct/enum ids are pinned in _REGISTRY below (never renumber — append).

The encoder/decoder are exact-type-dispatched and cursor-local: this codec
is the single largest CPU consumer on every process of a running cluster
(client batchers, proxy pipeline, TLog frames), so the hot paths avoid
attribute lookups, method calls, and per-byte function calls.
"""

from __future__ import annotations

import struct
from dataclasses import MISSING, fields, is_dataclass
from enum import IntEnum
from operator import attrgetter

MAGIC = 0xF5
WIRE_VERSION = 1

_F64 = struct.Struct(">d")


class WireError(Exception):
    """Malformed or out-of-policy bytes. Deliberately NOT an FDBError: the
    caller decides whether this is file_corrupt (durable) or a dropped
    connection (network)."""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BY_ID: dict[int, type] = {}
_BY_TYPE: dict[type, int] = {}
_FIELDS: dict[int, tuple] = {}  # id -> dataclass fields tuple
_GETTERS: dict[int, object] = {}  # id -> attrgetter over field names
_loaded = False
_native = None  # the C codec (native/fdb_native.c), when buildable


def _ensure_registry():
    global _loaded
    if not _loaded:
        _loaded = True
        _register_all()
        _install_native()


def _install_native():
    """Route the hot path through the C codec. The Python codec stays the
    semantic authority: any native error falls back to it (int >64-bit,
    subclasses, schema skew, hostile bytes -> canonical WireError)."""
    global _native
    try:
        from foundationdb_tpu_torch import native
    except Exception:  # noqa: BLE001 — no compiler is a supported config
        return
    if not native.available() or not hasattr(native.mod, "wire_dumps"):
        return
    by_id = {}
    by_type = {}
    for tid, cls in _BY_ID.items():
        names = (tuple(f.name for f in _FIELDS[tid])
                 if tid in _FIELDS else None)
        # third slot: decode accelerator. Enums get a value -> member map
        # (skips the metaclass __call__); vanilla dataclasses get True,
        # licensing the C decoder to allocate + fill the instance dict
        # directly instead of calling the generated __init__ (the pickle
        # bypass — only sound when __init__ IS the generated assigner).
        if isinstance(cls, type) and issubclass(cls, IntEnum):
            extra = {int(m.value): m for m in cls}
        elif names is not None and _plain_dataclass(cls):
            extra = True
        else:
            extra = None
        by_id[tid] = (cls, names, extra)
        by_type[cls] = tid
    native.mod.wire_set_registry(by_id, by_type)
    _native = native.mod


def _plain_dataclass(cls: type) -> bool:
    """True when constructing == assigning each field: the dataclass's own
    generated __init__ (co_filename "<string>"), every field in init, and
    no __post_init__ / __slots__ hooks that the bypass would skip."""
    init = cls.__dict__.get("__init__")
    code = getattr(init, "__code__", None)
    return (code is not None and code.co_filename == "<string>"
            and not hasattr(cls, "__post_init__")
            and "__slots__" not in cls.__dict__
            and all(f.init for f in fields(cls)))


def register(type_id: int, cls: type):
    """Pin `cls` at `type_id`. Ids are part of the wire format: append-only."""
    if type_id in _BY_ID and _BY_ID[type_id] is not cls:
        raise ValueError(f"wire type id {type_id} already bound to {_BY_ID[type_id]}")
    _BY_ID[type_id] = cls
    _BY_TYPE[cls] = type_id
    if is_dataclass(cls):
        fs = fields(cls)
        _FIELDS[type_id] = fs
        names = [f.name for f in fs]
        if len(names) == 1:
            g = attrgetter(names[0])
            _GETTERS[type_id] = lambda o, _g=g: (_g(o),)
        else:
            _GETTERS[type_id] = attrgetter(*names)
    return cls


def _registered_id(cls: type) -> int:
    tid = _BY_TYPE.get(cls)
    if tid is None:
        raise WireError(f"type {cls.__name__} is not wire-registered")
    return tid


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _w_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_zigzag(out: bytearray, v: int):
    # arbitrary-precision zigzag: versions are int64 but nothing here caps at it
    _w_varint(out, (v << 1) if v >= 0 else (-v << 1) - 1)


# tag bytes (precomputed: ord() per tag was measurably hot)
_T_NONE, _T_TRUE, _T_FALSE = ord("N"), ord("T"), ord("F")
_T_INT, _T_FLOAT, _T_BYTES, _T_STR = ord("i"), ord("d"), ord("b"), ord("s")
_T_LIST, _T_TUPLE, _T_DICT, _T_SET = ord("l"), ord("t"), ord("m"), ord("S")
_T_ENUM, _T_STRUCT = ord("E"), ord("R")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _enc_int(out: bytearray, v: int):
    # inline zigzag-varint; ints < 2^6 (the common case: tags, flags, small
    # counters) take the single-append path
    u = (v << 1) if v >= 0 else ((-v << 1) - 1)
    out.append(_T_INT)
    while u > 0x7F:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def _enc_bytes(out: bytearray, v: bytes):
    out.append(_T_BYTES)
    n = len(v)
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    out += v


def _enc_str(out: bytearray, v: str):
    out.append(_T_STR)
    b = v.encode("utf-8")
    _w_varint(out, len(b))
    out += b


def _enc_float(out: bytearray, v: float):
    out.append(_T_FLOAT)
    out += _F64.pack(v)


def _enc_none(out: bytearray, _v):
    out.append(_T_NONE)


def _enc_bool(out: bytearray, v: bool):
    out.append(_T_TRUE if v else _T_FALSE)


def _enc_list(out: bytearray, v: list):
    out.append(_T_LIST)
    _w_varint(out, len(v))
    enc = _encode_value
    for x in v:
        enc(out, x)


def _enc_tuple(out: bytearray, v: tuple):
    out.append(_T_TUPLE)
    _w_varint(out, len(v))
    enc = _encode_value
    for x in v:
        enc(out, x)


def _enc_dict(out: bytearray, v: dict):
    out.append(_T_DICT)
    _w_varint(out, len(v))
    enc = _encode_value
    for k, x in v.items():
        enc(out, k)
        enc(out, x)


def _enc_set(out: bytearray, v):
    out.append(_T_SET)
    _w_varint(out, len(v))
    enc = _encode_value
    for x in v:
        enc(out, x)


_ENC_EXACT = {
    bytes: _enc_bytes,
    int: _enc_int,
    str: _enc_str,
    list: _enc_list,
    tuple: _enc_tuple,
    dict: _enc_dict,
    float: _enc_float,
    bool: _enc_bool,
    type(None): _enc_none,
    set: _enc_set,
    frozenset: _enc_set,
}


def _encode_value(out: bytearray, obj):
    f = _ENC_EXACT.get(type(obj))
    if f is not None:
        f(out, obj)
        return
    _encode_other(out, obj)


def _encode_other(out: bytearray, obj):
    """Subclass / registered-type cases, off the exact-type fast path."""
    tid = _BY_TYPE.get(type(obj))
    if tid is not None:
        if isinstance(obj, IntEnum):
            out.append(_T_ENUM)
            _w_varint(out, tid)
            _w_zigzag(out, int(obj))
            return
        out.append(_T_STRUCT)
        _w_varint(out, tid)
        vals = _GETTERS[tid](obj)
        _w_varint(out, len(vals))
        enc = _encode_value
        for v in vals:
            enc(out, v)
        return
    if isinstance(obj, IntEnum):
        raise WireError(f"type {type(obj).__name__} is not wire-registered")
    if isinstance(obj, (bytearray, memoryview)):
        _enc_bytes(out, bytes(obj))
        return
    if isinstance(obj, bool):  # bool subclasses
        _enc_bool(out, obj)
        return
    if isinstance(obj, int):  # int subclasses
        _enc_int(out, int(obj))
        return
    if isinstance(obj, float):
        _enc_float(out, float(obj))
        return
    if isinstance(obj, str):
        _enc_str(out, str(obj))
        return
    if isinstance(obj, list):
        _enc_list(out, obj)
        return
    if isinstance(obj, tuple):
        _enc_tuple(out, obj)
        return
    if isinstance(obj, dict):
        _enc_dict(out, obj)
        return
    if isinstance(obj, (set, frozenset)):
        _enc_set(out, obj)
        return
    if is_dataclass(obj):
        raise WireError(f"type {type(obj).__name__} is not wire-registered")
    # last resort: anything indexable as an int (numpy scalars from
    # device fetches routinely leak into versions/counters)
    try:
        _enc_int(out, obj.__index__())
    except AttributeError:
        raise WireError(f"unserializable type {type(obj).__name__}") from None


_MAX_CONTAINER = 1 << 24  # sanity bound: one frame never has 16M+ elements
_MAX_DEPTH = 64  # hostile nesting must raise WireError, not RecursionError


# ---------------------------------------------------------------------------
# decode — cursor-local: (data, pos) in, (value, pos) out; no per-byte calls
# ---------------------------------------------------------------------------

def _r_varint(data: bytes, pos: int, end: int) -> tuple[int, int]:
    shift = 0
    v = 0
    while True:
        if pos >= end:
            raise WireError("truncated")
        if shift > 1100:  # ~1024-bit bound: big ints round-trip, frames
            raise WireError("varint overflow")  # can't allocate unbounded
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _decode_value(data: bytes, pos: int, end: int,
                  depth: int = 0) -> tuple[object, int]:
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep")
    if pos >= end:
        raise WireError("truncated")
    tag = data[pos]
    pos += 1
    if tag == _T_INT:
        v, pos = _r_varint(data, pos, end)
        return ((v >> 1) if not v & 1 else -((v + 1) >> 1)), pos
    if tag == _T_BYTES:
        n, pos = _r_varint(data, pos, end)
        if pos + n > end:
            raise WireError("truncated")
        return data[pos:pos + n], pos + n
    if tag == _T_NONE:
        return None, pos
    if tag == _T_LIST or tag == _T_TUPLE or tag == _T_SET:
        n, pos = _r_varint(data, pos, end)
        if n > _MAX_CONTAINER:
            raise WireError("container too large")
        items = []
        dec = _decode_value
        for _ in range(n):
            v, pos = dec(data, pos, end, depth + 1)
            items.append(v)
        if tag == _T_TUPLE:
            return tuple(items), pos
        if tag == _T_SET:
            try:
                return set(items), pos
            except TypeError as e:
                raise WireError("unhashable set element") from e
        return items, pos
    if tag == _T_STRUCT:
        tid, pos = _r_varint(data, pos, end)
        cls = _BY_ID.get(tid)
        fs = _FIELDS.get(tid)
        if cls is None or fs is None:
            raise WireError(f"unknown struct id {tid}")
        n, pos = _r_varint(data, pos, end)
        if n > 256:
            raise WireError("struct too wide")
        vals = []
        dec = _decode_value
        for _ in range(n):
            v, pos = dec(data, pos, end, depth + 1)
            vals.append(v)
        if n != len(fs):
            vals = vals[:len(fs)]  # older schema sent extras we dropped
            for f in fs[len(vals):]:  # newer schema: fill from defaults
                if f.default is not MISSING:
                    vals.append(f.default)
                elif f.default_factory is not MISSING:
                    vals.append(f.default_factory())
                else:
                    raise WireError(
                        f"missing required field {cls.__name__}.{f.name}")
        try:
            return cls(*vals), pos
        except TypeError as e:
            raise WireError(f"bad struct {cls.__name__}") from e
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_FLOAT:
        if pos + 8 > end:
            raise WireError("truncated")
        return _F64.unpack_from(data, pos)[0], pos + 8
    if tag == _T_STR:
        n, pos = _r_varint(data, pos, end)
        if pos + n > end:
            raise WireError("truncated")
        try:
            return data[pos:pos + n].decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise WireError("bad utf-8") from e
    if tag == _T_DICT:
        n, pos = _r_varint(data, pos, end)
        if n > _MAX_CONTAINER:
            raise WireError("container too large")
        out = {}
        dec = _decode_value
        for _ in range(n):
            k, pos = dec(data, pos, end, depth + 1)
            v, pos = dec(data, pos, end, depth + 1)
            try:
                out[k] = v
            except TypeError as e:
                raise WireError("unhashable dict key") from e
        return out, pos
    if tag == _T_ENUM:
        tid, pos = _r_varint(data, pos, end)
        cls = _BY_ID.get(tid)
        u, pos = _r_varint(data, pos, end)
        v = (u >> 1) if not u & 1 else -((u + 1) >> 1)
        if cls is None or not issubclass(cls, IntEnum):
            raise WireError(f"unknown enum id {tid}")
        try:
            return cls(v), pos
        except ValueError as e:
            raise WireError(f"bad enum value {v}") from e
    raise WireError(f"unknown tag {tag:#x}")


class PreEncoded:
    """A reply already serialized to a complete wire frame (the storage
    server's C read path emits these). dumps() passes the bytes through
    untouched, so the frame must decode to the reply dataclass it stands
    for — producers are parity-tested against _py_dumps. Only handlers
    that saw `wants_bytes` on the reply promise may send one; in-process
    deliveries hand the payload object to the caller unserialized, where
    a PreEncoded would be a type error."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


def type_id(cls: type) -> int:
    """Registered wire id for `cls` (stable across processes — ids are
    pinned in _register_all). Native encoders take this id to emit frames
    without touching the registry."""
    _ensure_registry()
    return _registered_id(cls)


def dumps(obj) -> bytes:
    if type(obj) is PreEncoded:
        return obj.data
    _ensure_registry()
    if _native is not None:
        try:
            return _native.wire_dumps(obj)
        except Exception:  # noqa: BLE001 — fall back to the canonical codec
            pass
    return _py_dumps(obj)


def _py_dumps(obj) -> bytes:
    out = bytearray([MAGIC, WIRE_VERSION])
    _encode_value(out, obj)
    return bytes(out)


def loads(data: bytes):
    _ensure_registry()
    if _native is not None:
        try:
            return _native.wire_loads(data)
        except Exception:  # noqa: BLE001 — fall back for canonical errors
            pass
    return _py_loads(data)


def _py_loads(data):
    data = bytes(data)
    end = len(data)
    if end < 2:
        raise WireError("truncated")
    if data[0] != MAGIC:
        raise WireError("bad magic")
    if data[1] > WIRE_VERSION:
        raise WireError(f"wire version {data[1]} from the future")
    obj, pos = _decode_value(data, 2, end)
    if pos != end:
        raise WireError("trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# the pinned registry (append-only; ids are wire format)
# ---------------------------------------------------------------------------

def _register_all():
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.server import interfaces as I
    from foundationdb_tpu_torch.utils.types import KeyRange, Mutation, MutationType

    table = [
        (1, Mutation), (2, MutationType), (3, KeyRange), (4, TxnConflictInfo),
        (5, I.GetCommitVersionRequest), (6, I.GetCommitVersionReply),
        (7, I.CommitTransactionRequest), (8, I.CommitReply),
        (9, I.GetReadVersionRequest), (10, I.GetReadVersionReply),
        (11, I.ResolveTransactionBatchRequest),
        (12, I.ResolveTransactionBatchReply),
        (13, I.TLogCommitRequest), (14, I.TLogCommitReply),
        (15, I.TLogPeekRequest), (16, I.TLogPeekReply), (17, I.TLogPopRequest),
        (18, I.GetValueRequest), (19, I.GetValueReply), (20, I.KeySelector),
        (21, I.GetKeyValuesRequest), (22, I.GetKeyValuesReply),
        (23, I.WatchValueRequest), (24, I.TLogLockRequest),
        (25, I.TLogLockReply), (26, I.LogEpoch), (27, I.SetLogSystemRequest),
        (28, I.GetStorageMetricsRequest), (29, I.ShardMetrics),
        (30, I.AddShardRequest), (31, I.SetShardsRequest),
        (32, I.UpdateShardsRequest), (33, I.InitRoleRequest),
        (34, I.InitRoleReply), (35, I.RegisterWorkerRequest), (36, I.DBInfo),
    ]
    for tid, cls in table:
        register(tid, cls)

    from foundationdb_tpu_torch.server import coordination as coord
    from foundationdb_tpu_torch.server import ratekeeper as rk
    from foundationdb_tpu_torch.server.clustercontroller import ClusterConfig

    for tid, cls in [
        (37, coord.GenReadRequest), (38, coord.GenReadReply),
        (39, coord.GenWriteRequest), (40, coord.GenWriteReply),
        (41, coord.CandidacyRequest), (42, coord.LeaderReply),
        (43, rk.RateInfoReply), (44, rk.QueueStatsReply),
        (45, ClusterConfig),
        (46, I.GetValuesRequest), (47, I.GetValuesReply),
    ]:
        register(tid, cls)

    from foundationdb_tpu_torch.server import hotspot as hs

    for tid, cls in [
        (48, hs.HotRange), (49, hs.HotRangesReply), (50, hs.ThrottleEntry),
    ]:
        register(tid, cls)
