"""ASan/UBSan run of the port's C extension over seven fuzz families.

    python -m foundationdb_tpu_torch.native.sanitize --sanitize=address,undefined

builds `fdb_native.c` (or `--source FILE`, a copy of it) with `-g -O1
-fno-omit-frame-pointer -fsanitize=...` into a temporary directory, then
re-runs itself on that library in a child: the sanitizer runtimes
LD_PRELOADed into the uninstrumented interpreter, PYTHONMALLOC=malloc (so
the extension's heap traffic through CPython is shadowed too), the
library named by the loader's override (FDBTPU_TORCH_NATIVE_SO),
ASAN_OPTIONS=exitcode=99:detect_leaks=1:abort_on_error=0 (its reports
written to files under `log_path`) and
UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1.

The child runs the fuzz bodies of the port's parity suites, imported from
the test modules and never forked: the VStore read path
(tests/test_torch_native_vstore.py), the redwood block codec
(tests/test_torch_native_fuzz.py), the transport's framing fuzz at a live
listener (tests/test_torch_transport.py), the redwood read path
(tests/test_torch_native_redwood.py), the transport's server plane
(tests/test_torch_native_server.py), the client plane
(tests/test_torch_native_client.py) and the chunk encoder
`encode_conflict_ranges` against the numpy encode over both layouts, with
its refusals (tests/test_torch_native_fuzz.py). Each family prints an
"... OK" marker. The child loads neither torch nor jax: third-party
libraries under ASan drown the run in reports that are not the port's.

Leaks: the child asks LeakSanitizer for a recoverable check at its end and
the parent reads the report. A leak whose stack has a frame in the
library (its path or its source's, both under the build directory) fails
the run; a leak whose stack never enters it (the interpreter's own) is
counted and printed, and passes. No suppression by function name is used:
such a pattern matches any frame of a stack, so it would also hide an
object the extension allocated through that function and leaked.

Exit codes: 0 clean; 75 no C compiler or no shared sanitizer runtime on
this host (EX_TEMPFAIL: callers skip); 1 a build, parity or sanitizer
failure; 2 a usage error.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

from foundationdb_tpu_torch.native import OVERRIDE_ENV, SRC

EX_TEMPFAIL = 75
REPO = Path(__file__).resolve().parents[2]
RUNTIMES = {"address": "libasan.so", "undefined": "libubsan.so"}
MARKERS = ("vstore parity OK", "redwood codec parity OK",
           "transport framing fuzz OK", "redwood read path fuzz OK",
           "transport plane fuzz OK", "client plane fuzz OK",
           "encoder parity OK")
CHILD_TIMEOUT_S = 900
_LEAK_HEAD = re.compile(
    r"^(Direct|Indirect) leak of (\d+) byte\(s\) in (\d+) object\(s\)")


def say(msg: str):
    print(f"sanitize: {msg}", flush=True)


# ----------------------------------------------------------------- parent

def runtimes(cc: str, sanitizers: list[str]) -> list[str] | None:
    """The shared runtime of each sanitizer (ASan's first, as LD_PRELOAD
    needs it), or None where the compiler has none."""
    libs = []
    for name in sorted(sanitizers, key=lambda s: s != "address"):
        out = subprocess.run([cc, f"-print-file-name={RUNTIMES[name]}"],
                             capture_output=True, text=True).stdout.strip()
        if not os.path.isabs(out):
            return None
        libs.append(out)
    return libs


def build(cc: str, source: Path, flag: str, out_dir: Path) -> Path:
    """The instrumented library, built from a copy of `source` in
    `out_dir` (so every frame of it, by library or by source path, lies
    under `out_dir`). Raises RuntimeError with the compiler's output."""
    src = out_dir / "fdb_native.c"
    shutil.copyfile(source, src)
    so = out_dir / "fdb_native.so"
    include = sysconfig.get_paths()["include"]
    proc = subprocess.run(
        [cc, "-g", "-O1", "-fno-omit-frame-pointer", "-shared", "-fPIC",
         f"-fsanitize={flag}", "-Wall", f"-I{include}", str(src), "-o",
         str(so)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cc exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return so


def leak_blocks(report: str):
    """(bytes, objects, stack text) of each leak in an LSan report."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        m = _LEAK_HEAD.match(line)
        if not m:
            continue
        stack = []
        for frame in lines[i + 1:]:
            if not frame.strip():
                break
            stack.append(frame)
        yield int(m.group(2)), int(m.group(3)), "\n".join(stack)


def read_reports(log_dir: Path, stderr: str, build_dir: Path):
    """-> (errors, leaks in the library, leaks outside it) from the
    sanitizer log files and the child's stderr."""
    reports = [p.read_text(errors="replace")
               for p in sorted(log_dir.glob("asan.*"))]
    errors = []
    for text in reports + [stderr]:
        for line in text.splitlines():
            if ("ERROR: AddressSanitizer" in line
                    or "runtime error:" in line):
                errors.append(line.strip())
    inside, outside = [], []
    for text in reports:
        for nbytes, objects, stack in leak_blocks(text):
            hit = str(build_dir) in stack
            (inside if hit else outside).append((nbytes, objects, stack))
    return errors, inside, outside


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.native.sanitize",
        description="ASan/UBSan build of the port's C extension, with its "
                    "parity fuzzes run against it")
    parser.add_argument("--sanitize", default="address,undefined",
                        help="comma-separated sanitizers (address, "
                             "undefined)")
    parser.add_argument("--source", default=str(SRC),
                        help="the C file to build (default: the port's "
                             "fdb_native.c)")
    parser.add_argument("--child", metavar="SO", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child(args.child)
    sanitizers = [s for s in args.sanitize.split(",") if s]
    unknown = [s for s in sanitizers if s not in RUNTIMES]
    if unknown or not sanitizers:
        parser.error(f"unknown sanitizer(s) {unknown}; choose from "
                     f"{sorted(RUNTIMES)}")
    flag = ",".join(sanitizers)
    cc = os.environ.get("CC", "cc")
    if shutil.which(cc) is None:
        say(f"no C compiler ({cc!r}) on PATH: skipping")
        return EX_TEMPFAIL
    tmp = Path(tempfile.mkdtemp(prefix="fdb_sanitize_"))
    try:
        probe = tmp / "probe.c"
        probe.write_text("int main(void) { return 0; }\n")
        if subprocess.run([cc, f"-fsanitize={flag}", str(probe), "-o",
                           str(tmp / "probe")],
                          capture_output=True).returncode != 0:
            say(f"{cc} cannot link -fsanitize={flag}: skipping")
            return EX_TEMPFAIL
        libs = runtimes(cc, sanitizers)
        if libs is None:
            say("no shared sanitizer runtime to preload: skipping")
            return EX_TEMPFAIL
        build_dir = tmp / "build"
        build_dir.mkdir()
        try:
            so = build(cc, Path(args.source), flag, build_dir)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            say(f"build failed: {e}")
            return 1
        say(f"built {so} with -fsanitize={flag}")
        return run_child(so, libs, tmp, build_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_child(so: Path, libs: list[str], tmp: Path, build_dir: Path) -> int:
    log_dir = tmp / "logs"
    log_dir.mkdir()
    env = dict(os.environ)
    env.update({
        "LD_PRELOAD": " ".join(libs),
        "PYTHONMALLOC": "malloc",
        OVERRIDE_ENV: str(so),
        "ASAN_OPTIONS": "exitcode=99:detect_leaks=1:abort_on_error=0:"
                        f"log_path={log_dir / 'asan'}",
        "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
        "PYTHONPATH": os.pathsep.join(
            [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else [])),
    })
    for gate in ("NET_NATIVE_TRANSPORT", "NET_NATIVE_CLIENT"):
        env.pop(gate, None)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "foundationdb_tpu_torch.native.sanitize",
             "--child", str(so)], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=CHILD_TIMEOUT_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out = "timeout", (e.stdout or b"").decode(errors="replace")
        err = (e.stderr or b"").decode(errors="replace")
    print(out, end="", flush=True)
    errors, inside, outside = read_reports(log_dir, err, build_dir)
    failures = []
    if rc != 0:
        failures.append(f"the fuzz process exited {rc}")
    missing = [m for m in MARKERS if f"sanitize: {m}" not in out]
    if missing:
        failures.append(f"families that did not finish: {missing}")
    if errors:
        failures.append(f"{len(errors)} sanitizer error(s): {errors[:5]}")
    say(f"leaks outside the extension: {len(outside)} allocation(s), "
        f"{sum(b for b, _o, _s in outside)} byte(s) (passed: no frame in "
        f"the library)")
    if inside:
        failures.append(
            f"{len(inside)} leak(s) with a frame in the extension, "
            f"{sum(b for b, _o, _s in inside)} byte(s); the first:\n"
            f"{inside[0][2]}")
    if failures:
        if err.strip():
            print(err[-4000:], file=sys.stderr)
        for f in failures:
            say(f"FAILED: {f}")
        return 1
    say("no sanitizer reports against the extension")
    return 0


# ------------------------------------------------------------------ child

def child(so: str) -> int:
    """The seven families on the library at `so` (the loader's override),
    then LSan's recoverable leak check; leaves through os._exit so the
    interpreter's teardown adds nothing to the report."""
    import ctypes
    import gc

    sys.path[:0] = [str(REPO / "tests"), str(REPO)]
    from foundationdb_tpu_torch import native
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    if not native.available():
        say(f"the extension is unavailable: {native.build_error()}")
        return 1
    if native.mod.__spec__.origin != so:
        say(f"loaded {native.mod.__spec__.origin}, not the override {so}")
        return 1

    def family(marker, body):
        KNOBS.reset()
        body()
        KNOBS.reset()
        say(marker)

    import test_torch_native_client as TC
    import test_torch_native_fuzz as TF
    import test_torch_native_redwood as TN
    import test_torch_native_server as TS
    import test_torch_native_vstore as TV
    import test_torch_transport as TT

    def vstore():
        assert TV.HAVE_NATIVE
        for seed in (1, 2, 3):
            TV.test_vstore_parity_fuzz(seed)
        TV.test_vstore_too_old_parity()
        for seed in (11, 12):
            TV.test_vstore_encoded_reply_parity(seed)

    def codec():
        for seed in (2, 3, 4):
            TF.fuzz_codec_parity(seed)

    def redwood_read_path():
        for seed in (21, 22):
            TN.fuzz_bloom_parity(seed)
            TN.fuzz_run_handle_parity(seed)
            TN.fuzz_run_open_rejects_corrupt(seed)
            TN.fuzz_runs_cascade_parity(seed)
        TN.fuzz_store_lifecycle_parity(seed=23)
        TN.fuzz_batched_encode_parity(seed=24)

    def server_plane():
        for seed in (31, 32):
            TS.fuzz_frame_parity(seed)
            TS.fuzz_stream_reject_parity(seed)
            TS.fuzz_fast_path_parity(seed)
        TS.test_dead_conn_refuses_more_input()
        TS.test_counters_track_frames_and_hits()

    def client_plane():
        for seed in (41, 42):
            TC.fuzz_encode_parity(seed)
            TC.fuzz_reply_pump_parity(seed)
        TC.test_encode_unsupported_payload_raises_for_whole_batch()
        TC.test_pump_error_reply_with_detail_decodes()
        TC.test_pump_dead_latch_and_residue()

    def encoder():
        assert TF.HAVE_NATIVE
        for seed in (1, 2, 3):
            TF.fuzz_encoder_parity(seed)
        TF.encoder_refusals()

    family("vstore parity OK", vstore)
    family("redwood codec parity OK", codec)
    family("transport framing fuzz OK",
           TT.test_framing_fuzz_rejects_garbage_without_wedging)
    family("redwood read path fuzz OK", redwood_read_path)
    family("transport plane fuzz OK", server_plane)
    family("client plane fuzz OK", client_plane)
    family("encoder parity OK", encoder)
    assert "torch" not in sys.modules and "jax" not in sys.modules, \
        "a fuzz family loaded torch or jax"

    gc.collect()
    check = getattr(ctypes.CDLL(None), "__lsan_do_recoverable_leak_check",
                    None)
    say(f"leak check: {'ran' if check is not None else 'no LSan'}"
        + (f", {'leaks reported' if check() else 'no leak'}"
           if check is not None else ""))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
