"""DiskQueue: durable append-only queue over two alternating checksummed files.

Reference: fdbserver/DiskQueue.actor.cpp + IDiskQueue.h:49-51 — the TLog's and
memory engine's WAL. Pages carry checksums; recovery scans forward and stops
at the first torn/corrupt page, so a crash can only lose a suffix. Space is
reclaimed by popping: when every entry in the older file has been popped, that
file is truncated and becomes the new tail — two files alternate forever.

Entries get monotonically increasing sequence numbers. The owner maps its own
notion of position (e.g. TLog versions) to sequences.

File interface required: append(bytes), sync(), read_all() -> bytes,
truncate(), truncate_to(size) — satisfied by core.sim.SimFile (which loses
unsynced appends on a simulated kill) and storage.localfile.LocalFile (real
fsync'd files; truncate_to = ftruncate).
"""

from __future__ import annotations

import struct
import zlib

_MAGIC = 0xFDB0D1C3
# magic, seq, pop_seq (queue's pop floor when written), payload_len, crc;
# the crc covers seq/pop_seq/len AND the payload (whole-page integrity, like
# the reference's page checksums — a flipped header field must not be trusted)
_HEADER = struct.Struct("<IQQII")
_CRCBODY = struct.Struct("<QQI")


def _page_crc(seq: int, pop_seq: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(
        _CRCBODY.pack(seq, pop_seq, len(payload)))) & 0xFFFFFFFF


def _parse_entries(raw: bytes):
    """Yield (seq, pop_seq, payload, end_offset) until the first torn page."""
    off = 0
    n = len(raw)
    while off + _HEADER.size <= n:
        magic, seq, pop_seq, plen, crc = _HEADER.unpack_from(raw, off)
        if magic != _MAGIC or off + _HEADER.size + plen > n:
            return
        payload = raw[off + _HEADER.size: off + _HEADER.size + plen]
        if _page_crc(seq, pop_seq, payload) != crc:
            return
        off += _HEADER.size + plen
        yield seq, pop_seq, payload, off


class DiskQueue:
    def __init__(self, file0, file1):
        self.files = [file0, file1]
        self.active = 0  # writes go here; 1-active is the front being popped
        self.next_seq = 0
        self.pop_seq = 0  # entries with seq < pop_seq are discarded
        # live (unpopped, committed-or-pending) entries per file: [ (seq, payload) ]
        self._entries: list[list[tuple[int, bytes]]] = [[], []]
        self._unsynced = False

    # -- write path --

    def push(self, payload: bytes) -> int:
        seq = self.next_seq
        self.next_seq += 1
        crc = _page_crc(seq, self.pop_seq, payload)
        page = _HEADER.pack(_MAGIC, seq, self.pop_seq, len(payload), crc) + payload
        self.files[self.active].append(page)
        self._entries[self.active].append((seq, payload))
        self._unsynced = True
        return seq

    def commit(self):
        """Make all pushed entries durable (group commit: one sync)."""
        if self._unsynced:
            self.files[self.active].sync()
            self._unsynced = False

    # -- reclaim --

    def pop(self, upto_seq: int):
        """Discard entries with seq < upto_seq; truncate+swap when the front
        file is fully popped (DiskQueue.actor.cpp two-file alternation)."""
        self.pop_seq = max(self.pop_seq, upto_seq)
        front = 1 - self.active
        self._entries[front] = [e for e in self._entries[front]
                                if e[0] >= self.pop_seq]
        self._entries[self.active] = [e for e in self._entries[self.active]
                                      if e[0] >= self.pop_seq]
        if not self._entries[front]:
            self.files[front].truncate()
            # swap: future writes fill the emptied file, old active drains
            self.active = front

    # -- recovery --

    def recover(self) -> list[tuple[int, bytes]]:
        """Rebuild state from the two files after a restart.

        Returns surviving entries in sequence order. A torn tail in the file
        holding the newest entries truncates the queue there (suffix loss
        only, matching AsyncFileNonDurable crash semantics).
        """
        per_file = [list(_parse_entries(f.read_all())) for f in self.files]
        # the file whose entries start later is the active (newer) one
        def first_seq(entries):
            return entries[0][0] if entries else -1

        if first_seq(per_file[0]) >= first_seq(per_file[1]):
            newer, older = 0, 1
        else:
            newer, older = 1, 0
        entries = per_file[older] + per_file[newer]
        # pop floor self-described by the pages: popped entries are dead even
        # if still physically present in a not-yet-truncated file
        floor = max((p for _s, p, _d, _o in entries), default=0)
        # enforce contiguity from the floor: stop at the first gap (a lost
        # middle page means everything after it is unusable)
        out: list[tuple[int, bytes]] = []
        live: set[int] = set()
        for seq, _pop, payload, _off in entries:
            if seq < floor:
                continue
            if out and seq != out[-1][0] + 1:
                break
            out.append((seq, payload))
            live.add(seq)
        # Truncate each file's DEAD TAIL (pages past the last survivor):
        # reused sequence numbers appended after them would otherwise alias
        # stale dead pages on the next recovery. Per-file page runs are
        # seq-contiguous (files are wiped at swap), so survivors are always a
        # prefix-after-floor and dead pages past them are a physical tail.
        # Removing only dead bytes keeps recovery crash-idempotent on real
        # files (no window where committed data exists only in memory).
        for f_idx in (older, newer):
            keep_to = 0
            for seq, _pop, _d, end_off in per_file[f_idx]:
                if seq in live or seq < floor:
                    keep_to = end_off
                else:
                    break
            parsed_to = per_file[f_idx][-1][3] if per_file[f_idx] else 0
            if keep_to < parsed_to or keep_to < len(self.files[f_idx].read_all()):
                self.files[f_idx].truncate_to(keep_to)
            self._entries[f_idx] = [(s, d) for s, _p, d, _o in per_file[f_idx]
                                    if s in live]
        self.active = newer
        self.next_seq = out[-1][0] + 1 if out else 0
        self.pop_seq = floor
        self._unsynced = False
        return out

    # -- introspection (tests) --

    @property
    def live_entries(self) -> list[tuple[int, bytes]]:
        both = self._entries[1 - self.active] + self._entries[self.active]
        return sorted(both)
