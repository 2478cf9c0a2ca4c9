"""Backup containers: where snapshot/log files land.

Reference: fdbclient/BackupContainer.actor.cpp — file/blob-store abstraction
with kvrange and log files. Here: a directory container (real files, the
deployment path) and an in-memory container (deterministic sim tests).
"""

from __future__ import annotations

import os

from foundationdb_tpu_torch.utils import wire


class BackupContainer:
    """In-memory container (sim tests): name -> bytes."""

    def __init__(self):
        self._files: dict[str, bytes] = {}

    def write_file(self, name: str, obj) -> None:
        self._files[name] = wire.dumps(obj)

    def read_file(self, name: str):
        return wire.loads(self._files[name])

    def list_files(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self._files if n.startswith(prefix))


class BlobStoreBackupContainer(BackupContainer):
    """Object-store container over HTTP (fdbrpc/BlobStore.actor.cpp): files
    are objects under <bucket>/<name>, written with a CRC-32C integrity
    header that reads verify, with bounded retries around every request."""

    #: retry pacing (the reference blob store's bounded exponential backoff,
    #: BlobStore.actor.cpp knobs REQUEST_TRIES/BACKOFF): first retry after
    #: BACKOFF_BASE seconds, doubling up to BACKOFF_MAX.
    BACKOFF_BASE = 0.05
    BACKOFF_MAX = 1.0

    def __init__(self, url: str, bucket: str = "backup", retries: int = 3,
                 sleep=None):
        from foundationdb_tpu_torch.net.http import HTTPConnection, HTTPError, _crc32c
        import time
        assert url.startswith("blobstore://"), url
        hostport = url[len("blobstore://"):].rstrip("/")
        host, _, port = hostport.partition(":")
        self._conn = HTTPConnection(host, int(port))
        self._bucket = bucket
        self._retries = retries
        self._HTTPError = HTTPError
        self._crc = _crc32c
        self._sleep = sleep if sleep is not None else time.sleep

    def _request(self, method, path, headers=None, body=b""):
        last = None
        for attempt in range(self._retries):
            if attempt:
                # back off before every retry: hammering a briefly
                # unavailable store back-to-back (and compounding with
                # HTTPConnection's own reconnect attempt) turns transient
                # blips into instant failures
                self._sleep(min(self.BACKOFF_MAX,
                                self.BACKOFF_BASE * (2 ** (attempt - 1))))
            try:
                return self._conn.request(method, path, headers, body)
            except (OSError, self._HTTPError) as e:
                last = e
        raise self._HTTPError(f"blobstore request failed: {last}")

    def write_file(self, name: str, obj) -> None:
        from urllib.parse import quote
        data = wire.dumps(obj)
        status, _h, _b = self._request(
            "PUT", f"/{self._bucket}/{quote(name)}",
            {"x-crc32c": str(self._crc(data))}, data)
        if status != 200:
            raise self._HTTPError(f"PUT {name}: HTTP {status}")

    def read_file(self, name: str):
        from urllib.parse import quote
        status, headers, body = self._request(
            "GET", f"/{self._bucket}/{quote(name)}")
        if status == 404:
            raise KeyError(name)
        if status != 200:
            raise self._HTTPError(f"GET {name}: HTTP {status}")
        want = headers.get("x-crc32c")
        if want is not None and int(want) != self._crc(body):
            raise self._HTTPError(f"GET {name}: checksum mismatch")
        return wire.loads(body)

    def list_files(self, prefix: str = "") -> list[str]:
        from urllib.parse import quote
        status, _h, body = self._request(
            "GET", f"/{self._bucket}?prefix={quote(prefix)}")
        if status != 200:
            raise self._HTTPError(f"LIST: HTTP {status}")
        return [n for n in body.decode().split("\n") if n]


class DirBackupContainer(BackupContainer):
    """Directory-backed container (wire-encoded files on disk)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def write_file(self, name: str, obj) -> None:
        tmp = os.path.join(self.path, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(wire.dumps(obj))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, name))

    def read_file(self, name: str):
        with open(os.path.join(self.path, name), "rb") as f:
            return wire.loads(f.read())

    def list_files(self, prefix: str = "") -> list[str]:
        return sorted(n for n in os.listdir(self.path)
                      if n.startswith(prefix) and not n.endswith(".tmp"))
