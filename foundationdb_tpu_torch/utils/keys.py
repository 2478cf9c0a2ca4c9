"""Key encoding: byte-string keys <-> fixed-width device limbs.

FoundationDB keys are arbitrary byte strings ordered lexicographically
(fdbclient/FDBTypes.h). A TPU kernel needs fixed shapes, so keys are encoded as
``NUM_LIMBS`` big-endian uint32 limbs covering the first ``KEY_BYTES`` bytes
plus one length limb (KEY_BYTES is the default width; every function here
takes an explicit or buffer-inferred key_bytes, so engines can run narrower
or wider — compare cost on device scales with the limb count):

    encode(k) = (be32(k[0:4]), be32(k[4:8]), ..., min(len(k), key_bytes))

Lexicographic comparison of the limb tuples equals byte-wise comparison of the
keys, *exactly* for keys <= KEY_BYTES long. Longer keys collapse onto their
KEY_BYTES-byte prefix (length clamped), which can only merge distinct keys into
one — in conflict detection that produces false conflicts (safe, a retry),
never false commits. This is the fixed-width prefix-binning contract from
SURVEY.md §7 hard-part 2 (reference tiebreak machinery: SkipList.cpp:147-177).

Ranges are half-open [begin, end) like the reference's KeyRangeRef.

The PyTorch port stores limbs as int32 with the sign bit flipped
(u32 ^ 0x80000000, `to_signed_limbs`), which keeps their order under signed
comparison: torch's uint32 lacks the ops the engine needs (maximum, flip).
The padding sentinel 0xFFFFFFFF becomes 0x7FFFFFFF and encode(b"") becomes
0x80000000 in every limb.
"""

from __future__ import annotations

from bisect import bisect_right as _bisect_right

import numpy as np

KEY_BYTES = 24
NUM_LIMBS = KEY_BYTES // 4 + 1  # 6 data limbs + 1 length limb = 7


def num_limbs(key_bytes: int) -> int:
    return key_bytes // 4 + 1


def encode_key(key: bytes, out: np.ndarray | None = None, round_up: bool = False,
               key_bytes: int | None = None) -> np.ndarray:
    """Encode one key to a (num_limbs(key_bytes),) uint32 vector.

    The width defaults to KEY_BYTES (24); passing `out` infers it from the
    buffer as (len(out)-1)*4, and `key_bytes` overrides explicitly — narrow
    engines (ConflictShapes.key_bytes) encode through the same function.

    A key longer than KEY_BYTES is not exactly representable; the encoding
    must round *conservatively* depending on which end of a half-open range
    the key is:

    - range BEGIN (round_up=False): truncation rounds down (the encoded key
      sorts <= the real key), growing the range leftward — safe.
    - range END (round_up=True): the encoding is the supremum of every key
      sharing the truncated prefix (length limb KEY_BYTES+1 sorts strictly
      after all real keys with that prefix), growing the range rightward —
      safe. Without this, a range whose endpoints share a 24-byte prefix
      would collapse to empty and a committed write would vanish from
      history: a false commit.
    """
    if key_bytes is None:
        key_bytes = KEY_BYTES if out is None else (len(out) - 1) * 4
    nl = num_limbs(key_bytes)
    if out is None:
        out = np.zeros(nl, dtype=np.uint32)
    k = key[:key_bytes]
    padded = k + b"\x00" * (key_bytes - len(k))
    out[: nl - 1] = np.frombuffer(padded, dtype=">u4")
    if len(key) > key_bytes and round_up:
        out[nl - 1] = key_bytes + 1
    else:
        out[nl - 1] = min(len(key), key_bytes)
    return out


def encode_keys_bulk(keys: list[bytes], key_bytes: int = KEY_BYTES, *,
                     round_up: bool = False) -> np.ndarray:
    """Vectorised `encode_key` over a list: (num_limbs(key_bytes), N) uint32.

    Pads (and truncates) every key to key_bytes in one numpy fixed-width
    bytes array, then reads all data limbs with one big-endian frombuffer —
    no per-key Python loop, so a full batch's ~16k endpoints encode in about
    a millisecond. Same values as encode_key, including the round_up rule
    for keys longer than key_bytes."""
    n = len(keys)
    nl = num_limbs(key_bytes)
    out = np.empty((nl, n), dtype=np.uint32)
    if n == 0:
        return out
    padded = np.array(keys, dtype=f"S{key_bytes}")  # pads with NUL, truncates
    out[: nl - 1] = np.frombuffer(padded.tobytes(), dtype=">u4").reshape(
        n, nl - 1).T
    lens = np.fromiter(map(len, keys), dtype=np.int64, count=n)
    out[nl - 1] = np.where(lens > key_bytes,
                           key_bytes + 1 if round_up else key_bytes, lens)
    return out


def to_signed_limbs(limbs: np.ndarray) -> np.ndarray:
    """uint32 limbs -> the port's order-preserving int32 limbs."""
    return (np.asarray(limbs, dtype=np.uint32)
            ^ np.uint32(0x80000000)).view(np.int32)


def from_signed_limbs(limbs: np.ndarray) -> np.ndarray:
    """Inverse of to_signed_limbs."""
    return (np.asarray(limbs, dtype=np.int32).view(np.uint32)
            ^ np.uint32(0x80000000))


def strinc(key: bytes) -> bytes:
    """First key not prefixed by `key` (reference: fdbclient's strinc)."""
    k = key.rstrip(b"\xff")
    if not k:
        raise ValueError("key is all 0xff; no strinc exists")
    return k[:-1] + bytes([k[-1] + 1])


def key_after(key: bytes) -> bytes:
    """Immediate successor in lexicographic order."""
    return key + b"\x00"


def partition_boundaries(n: int) -> list[bytes]:
    """n contiguous key-space partitions: [b""] + n-1 single-byte cuts.
    Shared by cluster builders, the recovery recruiter, and tests so shard
    layouts can never drift between them."""
    if n <= 1:
        return [b""]
    return [b""] + [bytes([int(256 * i / n)]) for i in range(1, n)]


def partition_index(boundaries: list[bytes], key: bytes) -> int:
    """Index of the partition owning `key` for sorted begin-boundaries
    (boundaries[0] == b""). Shared by shard maps, resolver maps, and the
    client location cache so ownership can never diverge between them."""
    return max(0, _bisect_right(boundaries, key) - 1)
