"""Minimal HTTP/1.1 + blob store: the backup system's remote container.

Reference: fdbrpc/HTTP.actor.cpp (request framing, response parsing,
Content-Length bodies, connection reuse) and fdbrpc/BlobStore.actor.cpp
(an S3-compatible object client: PUT/GET/DELETE objects, prefix listing,
per-request integrity checksums, bounded retries with backoff). Both are
implemented here from the protocol, not translated: a compact blocking
client used by BlobStoreBackupContainer, and a threaded server used as the
test double for a real object store.

The wire protocol is the S3-ish subset the reference speaks:
  PUT    /<bucket>/<object>   body = bytes, X-Crc32c = checksum
  GET    /<bucket>/<object>   -> 200 body (X-Crc32c) | 404
  DELETE /<bucket>/<object>   -> 200
  GET    /<bucket>?prefix=p   -> 200 newline-separated object names
"""

from __future__ import annotations

import socket
import threading
from urllib.parse import quote, unquote

from foundationdb_tpu_torch.net import native_transport


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the transport's (the C extension's where it is
    built, else its table-driven fallback): the SAME polynomial in both, and
    in the JAX package, so a store written by either package verifies in
    the other — zlib.crc32 (plain CRC-32) here would fail every cross-host
    restore."""
    return native_transport.crc32c(data)


# ---------------------------------------------------------------- client

class HTTPError(Exception):
    pass


def _recv_until(sock: socket.socket, sep: bytes, buf: bytearray) -> bytes:
    while sep not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise HTTPError("connection closed mid-response")
        buf += chunk
    i = buf.index(sep)
    head = bytes(buf[:i])
    del buf[:i + len(sep)]
    return head


def _recv_exact(sock: socket.socket, n: int, buf: bytearray) -> bytes:
    while len(buf) < n:
        chunk = sock.recv(65536)
        if not chunk:
            raise HTTPError("connection closed mid-body")
        buf += chunk
    body = bytes(buf[:n])
    del buf[:n]
    return body


class HTTPConnection:
    """One keep-alive connection; request() reconnects once on a dead
    socket (the reference's connection-pool-with-retry, HTTP.actor.cpp)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._buf = bytearray()

    def _connect(self):
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._buf = bytearray()

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def request(self, method: str, path: str,
                headers: dict[str, str] | None = None,
                body: bytes = b"") -> tuple[int, dict[str, str], bytes]:
        for attempt in (0, 1):
            if self._sock is None:
                self._connect()
            try:
                return self._round_trip(method, path, headers or {}, body)
            except (OSError, HTTPError):
                self.close()
                if attempt:
                    raise
        raise HTTPError("unreachable")

    def _round_trip(self, method, path, headers, body):
        h = {"host": f"{self.host}:{self.port}",
             "content-length": str(len(body)), **headers}
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n"
        self._sock.sendall(head.encode() + body)
        status_line = _recv_until(self._sock, b"\r\n", self._buf)
        parts = status_line.split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/1."):
            raise HTTPError(f"bad status line: {status_line!r}")
        status = int(parts[1])
        rheaders: dict[str, str] = {}
        while True:
            line = _recv_until(self._sock, b"\r\n", self._buf)
            if not line:
                break
            k, _, v = line.partition(b":")
            rheaders[k.decode().strip().lower()] = v.decode().strip()
        rbody = _recv_exact(self._sock, int(rheaders.get("content-length", 0)),
                            self._buf)
        return status, rheaders, rbody


# ---------------------------------------------------------------- server

class BlobStoreServer:
    """Threaded in-process object store (the test double for S3): real TCP,
    real HTTP framing, dict-backed objects."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"blobstore://{self.host}:{self.port}"

    def close(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        buf = bytearray()
        try:
            while True:
                req_line = _recv_until(conn, b"\r\n", buf)
                method, target, _ver = req_line.decode().split(None, 2)
                headers: dict[str, str] = {}
                while True:
                    line = _recv_until(conn, b"\r\n", buf)
                    if not line:
                        break
                    k, _, v = line.partition(b":")
                    headers[k.decode().strip().lower()] = v.decode().strip()
                body = _recv_exact(conn, int(headers.get("content-length", 0)),
                                   buf)
                status, rheaders, rbody = self._handle(method, target, body)
                head = (f"HTTP/1.1 {status} X\r\ncontent-length: "
                        f"{len(rbody)}\r\n" + "".join(
                            f"{k}: {v}\r\n" for k, v in rheaders.items())
                        + "\r\n")
                conn.sendall(head.encode() + rbody)
        except (HTTPError, OSError, ValueError):
            pass
        finally:
            conn.close()

    def _handle(self, method, target, body):
        path, _, query = target.partition("?")
        key = unquote(path.lstrip("/"))
        if method == "PUT":
            with self._lock:
                self._objects[key] = body
            return 200, {}, b""
        if method == "DELETE":
            with self._lock:
                self._objects.pop(key, None)
            return 200, {}, b""
        if method == "GET" and query.startswith("prefix="):
            prefix = unquote(query[len("prefix="):])
            with self._lock:
                names = sorted(k[len(key) + 1:] for k in self._objects
                               if k.startswith(key + "/")
                               and k[len(key) + 1:].startswith(prefix))
            return 200, {}, "\n".join(names).encode()
        if method == "GET":
            with self._lock:
                obj = self._objects.get(key)
            if obj is None:
                return 404, {}, b""
            return 200, {"x-crc32c": str(_crc32c(obj))}, obj
        return 400, {}, b""
