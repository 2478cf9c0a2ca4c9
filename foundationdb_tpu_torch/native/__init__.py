"""Native (C) host hot paths of the port, compiled at first use.

`fdb_native.c` is the port's copy of the JAX package's C extension (see
its header comment for the two differences): the conflict chunk encoder
that feeds the resolvers on the card, bulk key encoding, CRC-32C, the wire
codec, the IndexedSet and VStore skiplists, the redwood block codec, blooms
and run handles, and the transport's server and client planes. Where the
extension builds, the modules that use it take its path; where there is no
C compiler, they fall back to their pure-Python paths, so the port still
works — just slower on the host.

The first use (`available()`, `mod`, `build_error()`) compiles the source
with `cc -O3 -shared -fPIC` against the running Python's headers into
`foundationdb_tpu_torch/_build/`, under a name keyed by a hash of the source
and the command, and loads it. The compile writes a temporary file that is
renamed into place, under a file lock, so processes that start on a fresh
checkout at once never load a half-written library.

Usage:
    from foundationdb_tpu_torch import native
    if native.available():
        native.mod.encode_keys_into(keys, buf, round_up)

The module is loaded from its own file and left out of `sys.modules`, so
the JAX package's extension (same init symbol) loads beside it in one
process, each with its own static state.

Set FDBTPU_TORCH_NATIVE_SO=/path/to/lib.so to load that prebuilt library
instead of building one (`native/sanitize.py` runs the port against an
ASan/UBSan build this way). A path that names no file leaves the extension
unavailable, with the reason in `build_error()`; it never builds. The name
is the port's own: the JAX package's loader reads FDBTPU_NATIVE_SO, and one
variable must not redirect both loaders of a process.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "fdb_native.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")
OVERRIDE_ENV = "FDBTPU_TORCH_NATIVE_SO"

_lock = threading.Lock()
_loaded = False
_build_error: str | None = None


def _command(out: Path) -> list[str]:
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "cc")
    return [cc, *CFLAGS, f"-I{include}", str(SRC), "-o", str(out)]


def library_name() -> str:
    """The built library's file name: the source, the compile command
    (compiler, flags, Python headers) and the interpreter's extension ABI
    hashed."""
    h = hashlib.sha256(" ".join(_command(Path("x"))).encode())
    h.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    h.update(SRC.read_bytes())
    return f"fdb_native-{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path in `build_dir`, compiled there first if it is not
    yet. Raises RuntimeError with the compiler's output on failure. Safe
    to call from several processes at once: one compiles, under an
    exclusive lock on the directory's lock file, into a temporary file that
    it renames into place; the others wait on the lock and find it."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / library_name()
    if lib.exists():
        return lib
    with open(build_dir / ".fdb_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = build_dir / f".{lib.name}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(_command(tmp), capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"cc exited {proc.returncode}: {proc.stderr[-2000:]}")
            os.replace(tmp, lib)
        finally:
            if tmp.exists():
                tmp.unlink()
    return lib


def load(path: Path):
    """The extension module at `path`. The interpreter enters a
    single-phase extension in sys.modules under its init name; the entry
    is put back as it was, so that name never holds the port's module."""
    before = sys.modules.get("fdb_native")
    spec = importlib.util.spec_from_file_location("fdb_native", str(path))
    try:
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
    finally:
        if before is None:
            sys.modules.pop("fdb_native", None)
        else:
            sys.modules["fdb_native"] = before
    return m


def _ensure():
    global _loaded, _build_error, mod
    if _loaded:
        return
    with _lock:
        if _loaded:
            return
        m = None
        override = os.environ.get(OVERRIDE_ENV)
        try:
            if override and not os.path.exists(override):
                _build_error = f"{OVERRIDE_ENV} does not exist: {override}"
            else:
                m = load(Path(override) if override else build())
        except (OSError, RuntimeError, ImportError,
                subprocess.TimeoutExpired) as e:
            _build_error = f"{type(e).__name__}: {e}"
        mod = m
        _loaded = True


def __getattr__(name):
    if name == "mod":
        _ensure()
        return mod
    raise AttributeError(name)


def available() -> bool:
    """True when the extension is built and loaded (building it first)."""
    _ensure()
    return mod is not None


def build_error() -> str | None:
    """Why the extension is not available (None when it is)."""
    _ensure()
    return _build_error
