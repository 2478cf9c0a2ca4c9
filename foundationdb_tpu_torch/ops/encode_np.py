"""The numpy encode of one conflict chunk, without torch.

`BatchEncoder._encode_numpy` (ops/conflict.py) calls `encode_numpy`; the
C pass `encode_conflict_ranges` (native/fdb_native.c) writes the same
bytes. It lives apart from the engine so that a process that must not
load torch (the sanitizer harness, native/sanitize.py) holds the C pass to
it. `host` is the chunk's fields as numpy views: rb, re, wb, we (L, N)
int32; rtxn, wtxn (N,) int32; snapshot (T,) int32; txn_valid (T,) uint8.
"""

from __future__ import annotations

import numpy as np

from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError

NEG = -(1 << 30)  # "no version", below any clamped offset (conflict_ref.NEG)
PAD_LIMB = 0x7FFFFFFF  # the padding sentinel 0xFFFFFFFF, sign-flipped


def clamp_off(version: int, base_version: int) -> int:
    """`version` as the int32 offset from `base_version`, clamped to
    [NEG, 2^31 - 1]."""
    off = version - base_version
    return int(max(min(off, (1 << 31) - 1), NEG))


def encode_numpy(host: dict, txns, skip, *, txns_per_chunk: int, reads: int,
                 writes: int, key_bytes: int, strided: bool,
                 base_version: int):
    """The chunk's fields with a per-txn loop and numpy bulk encodes. In
    the strided layout txn t's i-th range lands in slot t * stride + i;
    else the ranges pack in order, each slot naming its txn (T for
    padding). Raises internal_error when the ranges exceed the shape."""
    T = txns_per_chunk
    rkeys_b, rkeys_e, wkeys_b, wkeys_e, rt, wt = [], [], [], [], [], []
    # rs/ws: the strided layout's slot of each range
    rs, ws = [], []
    rpt, wpt = reads // T, writes // T
    snap, valid = host["snapshot"], host["txn_valid"]
    snap.fill(0)
    valid.fill(0)
    for t, txn in enumerate(txns):
        if skip is not None and skip[t]:
            continue
        valid[t] = 1
        snap[t] = clamp_off(txn.read_snapshot, base_version)
        for i, (b, e) in enumerate(txn.read_ranges):
            rkeys_b.append(b)
            rkeys_e.append(e)
            rs.append(t * rpt + i)
        rt.extend([t] * len(txn.read_ranges))
        for i, (b, e) in enumerate(txn.write_ranges):
            wkeys_b.append(b)
            wkeys_e.append(e)
            ws.append(t * wpt + i)
        wt.extend([t] * len(txn.write_ranges))
    if len(rt) > reads or len(wt) > writes:
        raise FDBError("internal_error",
                       f"{len(rt)} reads / {len(wt)} writes exceed the "
                       f"chunk shape {reads}/{writes}")
    for name, keys, slots, up in (
            ("rb", rkeys_b, rs, False), ("re", rkeys_e, rs, True),
            ("wb", wkeys_b, ws, False), ("we", wkeys_e, ws, True)):
        out = host[name]
        out.fill(PAD_LIMB)
        if keys:
            idx = slots if strided else slice(len(keys))
            out[:, idx] = keylib.to_signed_limbs(
                keylib.encode_keys_bulk(keys, key_bytes, round_up=up))
    for name, owners, n, per in (("rtxn", rt, reads, rpt),
                                 ("wtxn", wt, writes, wpt)):
        out = host[name]
        if strided:
            out[:] = np.arange(n, dtype=np.int32) // per
        else:
            out.fill(T)
            out[:len(owners)] = owners
