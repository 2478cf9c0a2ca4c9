"""Native transport data plane: the C framing/checksum/dispatch binding.

The port's copy of foundationdb_tpu/net/native_transport.py. It is the thin
ownership layer between `net/transport.py` and the C extension's transport
section (`native/fdb_native.c`): it decides whether the native plane is
available and enabled, resolves the wire-registry type ids + endpoint
tokens the C fast path needs (so the C side never hardcodes a protocol
number), and exposes the framing primitives (`frame`, `crc32c`) with
pure-Python fallbacks that are held byte-identical by the parity fuzzes in
tests/test_torch_native_transport.py. `crc32c` is the port's one CRC-32C:
net/http.py and storage/redwood.py call it too.

Fast-path token table:

    STORAGE_GET_VALUE       GetValueRequest      -> GetValueReply
    STORAGE_GET_VALUES      GetValuesRequest     -> GetValuesReply
    STORAGE_GET_KEY_VALUES  GetKeyValuesRequest  -> GetKeyValuesReply
    PROXY_GET_READ_VERSION  GetReadVersionRequest-> GetReadVersionReply

Everything else — and any frame the C parser does not byte-recognize — is
handed back to the Python dispatcher as a slow-path tuple. The fallback
contract is strict: the C plane may only answer when its reply would be
byte-identical to what the Python handler's PreEncoded path would produce;
when in doubt it falls back, and a connection whose native loop faults
degrades (with its buffered residue) to the pure-Python serve loop.
"""

from __future__ import annotations

import os
import struct

from foundationdb_tpu_torch import native

HEADER_LEN = 25
MAX_FRAME_BYTES = 64 * 1024 * 1024
_HEADER = struct.Struct(">IQQBI")

_CRC32C_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def _py_crc32c(data: bytes, crc: int = 0) -> int:
    table = _crc32c_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """Frame checksum — CRC-32C (Castagnoli), same polynomial native-side
    and here, so a frame built by either framer verifies on the other."""
    if native.available():
        return native.mod.crc32c(data, crc)
    return _py_crc32c(data, crc)


def py_frame(token: int, reply_id: int, kind: int, body: bytes) -> bytes:
    """Pure-Python frame assembly — the parity-fuzz reference framer."""
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError("frame body over MAX_FRAME_BYTES")
    return _HEADER.pack(len(body), token, reply_id, kind,
                        _py_crc32c(body)) + body


def frame(token: int, reply_id: int, kind: int, body: bytes) -> bytes:
    """Assemble one wire frame; byte-identical to the C transport_frame."""
    if native.available():
        return native.mod.transport_frame(token, reply_id, kind, body)
    return py_frame(token, reply_id, kind, body)


def available() -> bool:
    """True when the C extension carries the transport plane symbols."""
    return native.available() and hasattr(native.mod, "TransportConn")


def enabled() -> bool:
    """The NET_NATIVE_TRANSPORT gate: env var wins (bench workers export
    it), else the knob (server_main applies knobs before the transport is
    constructed, so role processes honor config files too)."""
    env = os.environ.get("NET_NATIVE_TRANSPORT")
    if env is not None:
        return env == "1"
    try:
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        return bool(getattr(KNOBS, "NET_NATIVE_TRANSPORT", 0))
    except Exception:  # noqa: BLE001 — knobs unavailable == gate closed
        return False


def new_table():
    """A per-transport TransportTable (dispatch config + counters), or
    None when the native plane is unavailable."""
    if not available():
        return None
    return native.mod.TransportTable()


def new_conn(table):
    """A per-connection TransportConn over `table`."""
    return native.mod.TransportConn(table)


def storage_wire_ids() -> tuple:
    """(tok_gv, tok_gvs, tok_gkv, tid_gv_req, tid_gv_rep, tid_gvs_req,
    tid_gvs_rep, tid_gkv_req, tid_gkv_rep, tid_sel) for
    TransportTable.enable_storage — resolved from the live registry so the
    C fast path can never drift from the Python codec's type ids."""
    from foundationdb_tpu_torch.server import interfaces as si
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()
    return (si.Token.STORAGE_GET_VALUE, si.Token.STORAGE_GET_VALUES,
            si.Token.STORAGE_GET_KEY_VALUES,
            wire._BY_TYPE[si.GetValueRequest],
            wire._BY_TYPE[si.GetValueReply],
            wire._BY_TYPE[si.GetValuesRequest],
            wire._BY_TYPE[si.GetValuesReply],
            wire._BY_TYPE[si.GetKeyValuesRequest],
            wire._BY_TYPE[si.GetKeyValuesReply],
            wire._BY_TYPE[si.KeySelector])


def grv_wire_ids() -> tuple:
    """(token, tid_req, tid_rep) for TransportTable.enable_grv."""
    from foundationdb_tpu_torch.server import interfaces as si
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()
    return (si.Token.PROXY_GET_READ_VERSION,
            wire._BY_TYPE[si.GetReadVersionRequest],
            wire._BY_TYPE[si.GetReadVersionReply])


# --------------------------------------------------------------------------
# Client plane: batched request encode + reply pump.
# Same ownership split as the server plane above: this module gates and
# binds, net/transport.py adopts, tests/test_torch_native_client.py holds the C
# side byte/decision-identical to the pure-Python references below.
# --------------------------------------------------------------------------

_REQUEST_KIND = 0  # transport.py _REQUEST; the encoder only emits requests


def client_available() -> bool:
    """True when the C extension carries the client plane symbols."""
    return (native.available()
            and hasattr(native.mod, "ClientConn")
            and hasattr(native.mod, "transport_client_encode"))


def client_enabled() -> bool:
    """The NET_NATIVE_CLIENT gate: env var wins (bench workers export it),
    else the knob — mirroring enabled() above."""
    env = os.environ.get("NET_NATIVE_CLIENT")
    if env is not None:
        return env == "1"
    try:
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        return bool(getattr(KNOBS, "NET_NATIVE_CLIENT", 0))
    except Exception:  # noqa: BLE001 — knobs unavailable == gate closed
        return False


def new_client_conn():
    """A per-connection ClientConn reply pump, or None when the client
    plane is unavailable (the caller runs the pure-Python reply loop)."""
    if not client_available():
        return None
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()  # the pump's dec_value needs the registry
    return native.mod.ClientConn()


def encode_batch(items) -> bytes:
    """One framed, CRC-stamped send buffer for a batch of
    (token, reply_id, payload) requests. Raises (OverflowError for
    payloads only the Python codec can express) instead of guessing —
    the caller falls back to the per-request Python path."""
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()  # enc_value resolves dataclasses through it
    return native.mod.transport_client_encode(items)


def py_encode_batch(items) -> bytes:
    """Pure-Python batch encoder — the parity-fuzz reference: the exact
    per-request bytes transport.py's fallback path would write."""
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()
    return b"".join(
        py_frame(token, reply_id, _REQUEST_KIND, wire._py_dumps(payload))
        for token, reply_id, payload in items)
