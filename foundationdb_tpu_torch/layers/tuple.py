"""Tuple layer: order-preserving typed tuple <-> key encoding.

Reference: bindings/python/fdb/tuple.py + design/tuple.md — the public
cross-language tuple FORMAT (type codes, excluded-byte escaping, int sizing
by magnitude, IEEE-754 sign-flip for floats) implemented from the spec so
keys sort by tuple value. Elements supported: None, bytes, unicode str, int,
float, bool, nested tuple.

pack(t) sorts byte-wise exactly like t sorts element-wise, which is the whole
point: range reads over a tuple prefix enumerate its logical children.
"""

from __future__ import annotations

import math
import struct

_NULL = 0x00
_BYTES = 0x01
_STRING = 0x02
_NESTED = 0x05
_INT_ZERO = 0x14  # 0x0c..0x1c: ints by byte length (negative below, positive above)
_DOUBLE = 0x21
_FALSE = 0x26
_TRUE = 0x27
_ESCAPE = 0xFF


def _encode_bytes_like(code: int, b: bytes, out: bytearray):
    out.append(code)
    for byte in b:
        out.append(byte)
        if byte == 0x00:
            out.append(_ESCAPE)  # \x00 -> \x00\xff keeps ordering + framing
    out.append(0x00)


def _encode_int(v: int, out: bytearray):
    if v == 0:
        out.append(_INT_ZERO)
        return
    if v > 0:
        n = (v.bit_length() + 7) // 8
        if n > 8:
            raise ValueError("int too large for tuple encoding")
        out.append(_INT_ZERO + n)
        out.extend(v.to_bytes(n, "big"))
    else:
        n = ((-v).bit_length() + 7) // 8
        if n > 8:
            raise ValueError("int too large for tuple encoding")
        out.append(_INT_ZERO - n)
        # one's-complement-style offset so more-negative sorts first
        out.extend((v + (1 << (8 * n)) - 1).to_bytes(n, "big"))


def _encode_double(v: float, out: bytearray):
    out.append(_DOUBLE)
    raw = bytearray(struct.pack(">d", v))
    if raw[0] & 0x80:  # negative: flip all bits so order reverses correctly
        for i in range(8):
            raw[i] ^= 0xFF
    else:  # positive: flip the sign bit so positives sort above negatives
        raw[0] ^= 0x80
    out.extend(raw)


def _encode(element, out: bytearray, nested: bool):
    if element is None:
        if nested:
            out.extend((_NULL, _ESCAPE))  # nested null needs an escape
        else:
            out.append(_NULL)
    elif element is True:
        out.append(_TRUE)
    elif element is False:
        out.append(_FALSE)
    elif isinstance(element, bytes):
        _encode_bytes_like(_BYTES, element, out)
    elif isinstance(element, str):
        _encode_bytes_like(_STRING, element.encode("utf-8"), out)
    elif isinstance(element, int):
        _encode_int(element, out)
    elif isinstance(element, float):
        _encode_double(element, out)
    elif isinstance(element, tuple):
        out.append(_NESTED)
        for e in element:
            _encode(e, out, nested=True)
        out.append(0x00)
    else:
        raise TypeError(f"tuple layer cannot encode {type(element).__name__}")


def pack(t: tuple, prefix: bytes = b"") -> bytes:
    out = bytearray(prefix)
    for e in t:
        _encode(e, out, nested=False)
    return bytes(out)


def _decode_bytes_like(data: bytes, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        b = data[pos]
        if b == 0x00:
            if pos + 1 < len(data) and data[pos + 1] == _ESCAPE:
                out.append(0x00)
                pos += 2
                continue
            return bytes(out), pos + 1
        out.append(b)
        pos += 1


def _decode(data: bytes, pos: int, nested: bool):
    code = data[pos]
    if code == _NULL:
        if nested:  # inside a nested tuple null is \x00\xff
            return None, pos + 2
        return None, pos + 1
    if code == _TRUE:
        return True, pos + 1
    if code == _FALSE:
        return False, pos + 1
    if code == _BYTES:
        return _decode_bytes_like(data, pos + 1)
    if code == _STRING:
        raw, p = _decode_bytes_like(data, pos + 1)
        return raw.decode("utf-8"), p
    if code == _DOUBLE:
        raw = bytearray(data[pos + 1: pos + 9])
        if raw[0] & 0x80:
            raw[0] ^= 0x80
        else:
            for i in range(8):
                raw[i] ^= 0xFF
        return struct.unpack(">d", bytes(raw))[0], pos + 9
    if code == _NESTED:
        out = []
        pos += 1
        while True:
            if data[pos] == 0x00:
                if pos + 1 < len(data) and data[pos + 1] == _ESCAPE:
                    out.append(None)
                    pos += 2
                    continue
                return tuple(out), pos + 1
            e, pos = _decode(data, pos, nested=True)
            out.append(e)
    if _INT_ZERO - 8 <= code <= _INT_ZERO + 8:
        n = code - _INT_ZERO
        if n == 0:
            return 0, pos + 1
        if n > 0:
            return int.from_bytes(data[pos + 1: pos + 1 + n], "big"), pos + 1 + n
        n = -n
        raw = int.from_bytes(data[pos + 1: pos + 1 + n], "big")
        return raw - (1 << (8 * n)) + 1, pos + 1 + n
    raise ValueError(f"unknown tuple type code {code:#x} at {pos}")


def unpack(key: bytes, prefix_len: int = 0) -> tuple:
    out = []
    pos = prefix_len
    while pos < len(key):
        e, pos = _decode(key, pos, nested=False)
        out.append(e)
    return tuple(out)


def range_of(t: tuple, prefix: bytes = b"") -> tuple[bytes, bytes]:
    """[begin, end) covering every key that extends tuple t."""
    p = pack(t, prefix)
    return p + b"\x00", p + b"\xff"


def compare(a: tuple, b: tuple) -> int:
    """Tuple order as the packed keys sort (tests rely on this agreeing
    with element-wise order)."""
    pa, pb = pack(a), pack(b)
    return -1 if pa < pb else (1 if pa > pb else 0)


def is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)
