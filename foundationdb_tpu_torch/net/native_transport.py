"""Transport framing: the frame header, CRC-32C and the batch encoder.

The port's copy of foundationdb_tpu/net/native_transport.py, its pure-Python
branches only. In the JAX package this module is the ownership layer of a C
data plane (framing, checksum and the read-dominant fast-path tokens in its
native extension); the port has no C extension, so `available()` and
`client_available()` are False, and a NetTransport asked for either plane
(the NET_NATIVE_TRANSPORT or NET_NATIVE_CLIENT knob, or the environment
variable of that name, set to 1) raises invalid_option: it never serves the
Python path in the native plane's place.

The framing primitives (`frame`, `crc32c`, `encode_batch`) are the JAX
module's Python fallbacks, held byte-identical to it (and so to its C
framer) by tests/test_torch_native_transport.py: a frame either package
writes verifies in the other. The CRC-32C table here is the port's only
one; net/http.py's blob-store checksum uses it too.
"""

from __future__ import annotations

import os
import struct

from foundationdb_tpu_torch.utils.errors import FDBError

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
    """Frame checksum — CRC-32C (Castagnoli), the polynomial of the JAX
    package's C framer, so a frame built by either package verifies on the
    other."""
    return _py_crc32c(data, crc)


def py_frame(token: int, reply_id: int, kind: int, body: bytes) -> bytes:
    """Pure-Python frame assembly."""
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError("frame body over MAX_FRAME_BYTES")
    return _HEADER.pack(len(body), token, reply_id, kind,
                        _py_crc32c(body)) + body


def frame(token: int, reply_id: int, kind: int, body: bytes) -> bytes:
    """Assemble one wire frame; byte-identical to the JAX package's."""
    return py_frame(token, reply_id, kind, body)


def available() -> bool:
    """The C transport plane: the port has no C extension."""
    return False


def _gate(name: str) -> bool:
    """A native-plane gate: the environment variable wins, else the knob
    (server_main applies the spec's knobs before the transport is
    constructed)."""
    env = os.environ.get(name)
    if env is not None:
        return env == "1"
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    return bool(getattr(KNOBS, name, 0))


def enabled() -> bool:
    """The NET_NATIVE_TRANSPORT gate."""
    return _gate("NET_NATIVE_TRANSPORT")


def client_available() -> bool:
    """The C client plane: the port has no C extension."""
    return False


def client_enabled() -> bool:
    """The NET_NATIVE_CLIENT gate."""
    return _gate("NET_NATIVE_CLIENT")


def refuse_native() -> None:
    """Raise where the JAX package would open a native plane: an asked-for
    plane that the port cannot serve is an error, not the Python path."""
    for name, on in (("NET_NATIVE_TRANSPORT", enabled()),
                     ("NET_NATIVE_CLIENT", client_enabled())):
        if on:
            raise FDBError("invalid_option",
                           f"{name}=1: the C transport plane is not ported "
                           f"yet (the port has no C extension)")


_REQUEST_KIND = 0  # transport.py _REQUEST; the encoder only emits requests


def encode_batch(items) -> bytes:
    """One framed, CRC-stamped send buffer for a batch of
    (token, reply_id, payload) requests: the exact per-request bytes the
    transport's Python path writes."""
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()
    return b"".join(
        py_frame(token, reply_id, _REQUEST_KIND, wire._py_dumps(payload))
        for token, reply_id, payload in items)
