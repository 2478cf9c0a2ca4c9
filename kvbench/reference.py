"""The plain reference: FoundationDB's conflict resolution over a stream of
batches, in NumPy, written from the semantics and not from the program.

It imports nothing of the program and takes only the raw inputs of
kvbench/gen.py (key bytes, ranges, snapshots, versions). What it computes
(fdbserver/SkipList.cpp, ConflictSet.h):

- A transaction with reads whose snapshot is below the MVCC floor before
  its batch is too old. The floor before batch j is V(j - 1) - window.
- Otherwise it conflicts when a read range overlaps a write range that a
  committed transaction wrote at a version above its snapshot (the
  history check).
- Otherwise, in batch order, it conflicts when a read range overlaps a
  write range of an earlier transaction of the same batch that committed
  ("earlier txns win"); else it commits.
- The committed transactions' writes enter the history at the batch's
  version.

Keys are compared as byte strings. Every range endpoint of the stream is
ranked once in lexicographic order, so a range is a run of elementary
slots between consecutive endpoints and two ranges overlap exactly when
they share a slot. The history is the newest committed version of each
slot.

The window replays the pool in passes (kvbench/gen.py). The verdicts of a
pass depend only on the history at its start that is still above the
floor, and that history depends only on the pass before; so once a pass
starts with a history (moved by the passes' span) that an earlier pass
started with, the passes from there on repeat. `pass_verdicts` runs
passes until that happens and says where the loop starts.
"""

from __future__ import annotations

import hashlib
import zlib

import numpy as np

# ConflictSet.h TransactionConflictStatus numbering
CONFLICT, TOO_OLD, COMMITTED = 0, 1, 2
NONE = np.iinfo(np.int64).min // 2  # a slot no committed write covers


def key_ranks(keys: list[bytes]) -> np.ndarray:
    """The rank of every key in lexicographic byte order (equal keys share
    a rank). A key padded with zero bytes to the longest key, then its
    length, orders as the key: a proper prefix pads to zeros where the
    longer key has its next byte or ties on the padding and is shorter."""
    n = len(keys)
    lengths = np.fromiter(map(len, keys), dtype=np.int64, count=n)
    words = max(1, -(-int(lengths.max(initial=0)) // 8))
    padded = np.zeros((n, words * 8), dtype=np.uint8)
    flat = np.frombuffer(b"".join(keys), dtype=np.uint8)
    starts = np.cumsum(lengths) - lengths
    padded[np.repeat(np.arange(n), lengths),
           np.arange(flat.size) - np.repeat(starts, lengths)] = flat
    cols = padded.view(">u8").reshape(n, words)
    order = np.lexsort([lengths] + [cols[:, c] for c in
                                    range(words - 1, -1, -1)])
    scols, slens = cols[order], lengths[order]
    new = np.ones(n, dtype=bool)
    new[1:] = (scols[1:] != scols[:-1]).any(axis=1) | (slens[1:] != slens[:-1])
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.cumsum(new) - 1
    return ranks


def _range_max(hist: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """max(hist[lo:hi]) per range (NONE for an empty range)."""
    out = np.full(lo.shape, NONE, dtype=np.int64)
    width = hi - lo
    for off in range(int(width.max(initial=0))):
        live = off < width
        out = np.where(live, np.maximum(
            out, hist[np.where(live, lo + off, 0)]), out)
    return out


def _range_set(hist: np.ndarray, lo: np.ndarray, hi: np.ndarray, value):
    width = hi - lo
    for off in range(int(width.max(initial=0))):
        live = off < width
        hist[(lo + off)[live]] = value


def resolve_batch(hist, writers, version, floor, snapshot, rlo, rhi, wlo,
                  whi):
    """One batch: verdicts (T,) int8, and `hist` updated in place.

    rlo/rhi (T, nr) and wlo/whi (T, nw) are the slot runs [lo, hi) of the
    txns' reads and writes. `writers` is two scratch arrays of hist's
    shape holding T, which the batch leaves holding T."""
    T = snapshot.shape[0]
    has_reads = np.full(T, rlo.shape[1] > 0)
    too_old = has_reads & (snapshot < floor)
    hit = (_range_max(hist, rlo, rhi) > snapshot[:, None]) & (rhi > rlo)
    eligible = ~too_old & ~hit.any(axis=1)

    # earlier txns win: a txn whose reads meet no write of an earlier txn
    # of the batch (committed or not) keeps `eligible`; the others are
    # decided in order against the earliest committed writer of each slot
    txn = np.arange(T, dtype=np.int64)
    wown = np.broadcast_to(txn[:, None], wlo.shape)
    first_writer, first_committed = writers
    for off in range(int((whi - wlo).max(initial=0))):
        live = (off < whi - wlo) & ~too_old[:, None]
        np.minimum.at(first_writer, (wlo + off)[live], wown[live])
    earliest = np.full(rlo.shape, T, dtype=np.int64)
    for off in range(int((rhi - rlo).max(initial=0))):
        live = off < rhi - rlo
        earliest = np.where(live, np.minimum(
            earliest, first_writer[np.where(live, rlo + off, 0)]), earliest)
    maybe = eligible & (earliest.min(axis=1, initial=T) < txn)
    committed = eligible & ~maybe
    for off in range(int((whi - wlo).max(initial=0))):
        live = (off < whi - wlo) & committed[:, None]
        np.minimum.at(first_committed, (wlo + off)[live], wown[live])
    for t in np.flatnonzero(maybe).tolist():
        if any(first_committed[lo:hi].min(initial=T) < t
               for lo, hi in zip(rlo[t].tolist(), rhi[t].tolist())):
            continue
        committed[t] = True
        for lo, hi in zip(wlo[t].tolist(), whi[t].tolist()):
            first_committed[lo:hi] = np.minimum(first_committed[lo:hi], t)

    verdict = np.where(too_old, TOO_OLD,
                       np.where(committed, COMMITTED, CONFLICT))
    _range_set(hist, wlo[committed].ravel(), whi[committed].ravel(), version)
    for scratch in writers:
        _range_set(scratch, wlo.ravel(), whi.ravel(), T)
    return verdict.astype(np.int8)


def pass_verdicts(stream, passes: int, log=None):
    """Verdicts of the stream's pool pass by pass, until the history at a
    pass's start repeats one seen before or `passes` passes ran: (list of
    (P, T) int8 arrays, one a pass; loop_from). Where the history at the
    start of pass len(out) equals that at the start of pass q, loop_from
    is q and every later pass repeats the loop q .. len(out) - 1
    (`verdicts_of_pass`); else loop_from is None."""
    ranks = key_ranks(stream.keys)
    rlo, rhi = ranks[stream.rb], ranks[stream.re]
    wlo, whi = ranks[stream.wb], ranks[stream.we]
    hist = np.full(int(ranks.max(initial=0)) + 1, NONE, dtype=np.int64)
    P, span = stream.batches, stream.span
    writers = [np.full(hist.shape, stream.txns, dtype=np.int64)
               for _ in range(2)]
    floors = stream.floors()
    seen = {hashlib.blake2b(hist.tobytes()).digest(): 0}
    out = []
    for p in range(passes):
        shift = p * span
        out.append(np.stack([
            resolve_batch(hist, writers, shift + int(stream.versions[j]),
                          shift + int(floors[j]),
                          shift + stream.snapshot[j], rlo[j], rhi[j],
                          wlo[j], whi[j]) for j in range(P)]))
        # the history that the next pass can still see, in its own terms
        live = hist > shift + int(stream.versions[-1]) - stream.window
        start = np.where(live, hist - shift - span, NONE)
        q = seen.setdefault(hashlib.blake2b(start.tobytes()).digest(), p + 1)
        if q <= p:
            if log:
                log(f"reference: pass {p + 1} starts as pass {q} did")
            return out, q
    return out, None


def verdicts_of_pass(out: list, loop_from, n: int):
    """Pass n's verdicts from `pass_verdicts`' result, or None where it
    did not run that far."""
    if n < len(out):
        return out[n]
    if loop_from is None:
        return None
    return out[loop_from + (n - loop_from) % (len(out) - loop_from)]


def digests(verdicts: np.ndarray) -> list[int]:
    """CRC-32 of each batch's verdict row (int8), as the harness takes
    them from the program's answers."""
    return [zlib.crc32(np.ascontiguousarray(row, dtype=np.int8))
            for row in verdicts]
