"""The port's C extension under ASan/UBSan, and the loader's override.

`python -m foundationdb_tpu_torch.native.sanitize` builds the port's
fdb_native.c with the sanitizers and runs seven fuzz families on it, the
library loaded through FDBTPU_TORCH_NATIVE_SO. It skips (exit 75) where
there is no C compiler or no shared sanitizer runtime, and so do these
tests. Leaks whose stacks never enter the library (the interpreter's own)
are counted and pass; the planted-leak mutation shows that a leak the
extension makes still fails the run.

The loader: an override that names no file leaves the extension
unavailable with the reason and builds nothing; one that names a library
loads it, out of `sys.modules`; and an edited source never loads the
library built from the old one (the name carries the source's hash).
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from foundationdb_tpu_torch import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
HAVE_CC = shutil.which(os.environ.get("CC", "cc")) is not None
needs_cc = pytest.mark.skipif(not HAVE_CC, reason="no C compiler")
MARKERS = ("vstore parity OK", "redwood codec parity OK",
           "transport framing fuzz OK", "redwood read path fuzz OK",
           "transport plane fuzz OK", "client plane fuzz OK",
           "encoder parity OK")


def run_harness(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.native.sanitize",
         "--sanitize=address,undefined", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if proc.returncode == 75:
        pytest.skip("no C compiler or sanitizer runtime on this host")
    return proc.returncode, proc.stdout + proc.stderr


def test_seven_families_run_clean_under_the_sanitizers():
    rc, out = run_harness()
    assert rc == 0, out
    for marker in MARKERS:
        assert f"sanitize: {marker}" in out, out
    assert "sanitize: leak check: ran" in out, out
    assert "sanitize: leaks outside the extension: " in out, out
    assert "with a frame in the extension" not in out, out
    assert "sanitize: no sanitizer reports against the extension" in out


def test_a_leak_planted_on_the_encoders_path_fails_the_run(tmp_path):
    """A malloc that is never freed, made on every encode call: the leak
    filter that passes the interpreter's leaks does not hide it."""
    src = native.SRC.read_text()
    head = ("static PyObject *py_encode_conflict_ranges(PyObject *self, "
            "PyObject *args) {\n")
    assert src.count(head) == 1
    planted = ("static void *volatile planted_sink;\n"
               "static void planted_leak(void) {\n"
               "    planted_sink = malloc(48);\n"
               "    planted_sink = NULL;\n"
               "}\n\n" + head + "    planted_leak();\n")
    mutant = tmp_path / "fdb_native.c"
    mutant.write_text(src.replace(head, planted))
    rc, out = run_harness("--source", str(mutant))
    assert rc == 1, out
    assert "leak(s) with a frame in the extension" in out, out
    assert "planted_leak" in out, out


def _loader_probe(env, code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), **env))


def test_override_naming_no_file_is_an_error_and_builds_nothing(tmp_path):
    code = ("from foundationdb_tpu_torch import native\n"
            "def boom(*a, **k):\n"
            "    raise AssertionError('the override must not build')\n"
            "native.build = boom\n"
            "print(native.available(), native.build_error())\n")
    missing = tmp_path / "none.so"
    proc = _loader_probe({native.OVERRIDE_ENV: str(missing)}, code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == (
        f"False {native.OVERRIDE_ENV} does not exist: {missing}")


@needs_cc
def test_override_loads_the_named_library_out_of_sys_modules(tmp_path):
    lib = native.build(tmp_path)
    code = ("import sys\n"
            "from foundationdb_tpu_torch import native\n"
            "def boom(*a, **k):\n"
            "    raise AssertionError('the override must not build')\n"
            "native.build = boom\n"
            "assert native.available(), native.build_error()\n"
            "assert 'fdb_native' not in sys.modules\n"
            "print(native.mod.__spec__.origin)\n")
    proc = _loader_probe({native.OVERRIDE_ENV: str(lib)}, code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(lib)


def test_the_jax_loaders_variable_does_not_redirect_the_ports(tmp_path):
    """FDBTPU_NATIVE_SO is the JAX package's: the port's loader ignores it
    (here it names no file, and the port's extension is still found)."""
    code = ("from foundationdb_tpu_torch import native\n"
            "print(native.available() == (native.build_error() is None))\n")
    proc = _loader_probe({"FDBTPU_NATIVE_SO": str(tmp_path / "none.so")},
                         code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"
    assert "FDBTPU_NATIVE_SO" not in proc.stdout


@needs_cc
def test_an_edited_source_never_loads_the_old_library(tmp_path,
                                                      monkeypatch):
    """The library's name hashes the source: after an edit the loader
    builds anew beside the old library instead of loading it."""
    src = tmp_path / "fdb_native.c"
    shutil.copyfile(native.SRC, src)
    monkeypatch.setattr(native, "SRC", src)
    out = tmp_path / "build"
    old = native.build(out)
    src.write_text(src.read_text() + "\n/* edited */\n")
    new = native.build(out)
    assert new != old and old.exists() and new.exists()
    assert native.load(new).crc32c(b"123456789") == 0xE3069283
