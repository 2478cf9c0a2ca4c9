"""Backup key schema: the system-keyspace layout the backup agent and the
proxies' mutation-log tee share.

Reference: fdbclient/FileBackupAgent.actor.cpp — proxies tee every committed
mutation in a backed-up range into \\xff/blog/<version><seq>
(MasterProxyServer.actor.cpp:664-776). Backup metadata lives in the system
keyspace (all flowing through the metadata pipeline, so every proxy's tee
switches on/off at a fenced version):
  \\xff/backup/state         active | stopped
  \\xff/backup/beginVersion  decimal
  \\xff/backup/endVersion    decimal (written by stop)
  \\xff/backupRanges/<begin> -> <end>  (ranges the proxies tee)

The port's copy of the schema part of foundationdb_tpu/backup/agent.py; the
BackupAgent and RestoreAgent classes are not ported yet.
"""

from __future__ import annotations

BLOG_PREFIX = b"\xff/blog/"
BLOG_END = b"\xff/blog0"
STATE_KEY = b"\xff/backup/state"
BEGIN_KEY = b"\xff/backup/beginVersion"
END_KEY = b"\xff/backup/endVersion"
RANGES_PREFIX = b"\xff/backupRanges/"
RANGES_END = b"\xff/backupRanges0"


def backup_keys():
    return dict(blog=BLOG_PREFIX, state=STATE_KEY, begin=BEGIN_KEY,
                end=END_KEY, ranges=RANGES_PREFIX)


def blog_key(version: int, seq: int) -> bytes:
    return BLOG_PREFIX + version.to_bytes(8, "big") + seq.to_bytes(4, "big")


def parse_blog_key(key: bytes) -> tuple[int, int]:
    raw = key[len(BLOG_PREFIX):]
    return int.from_bytes(raw[:8], "big"), int.from_bytes(raw[8:12], "big")
