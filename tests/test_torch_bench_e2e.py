"""The port's end-to-end driver (foundationdb_tpu_torch/bench_e2e.py and
bench.py's `run_e2e`) against the repository's bench_e2e.py, on the CPU.

- Op streams: `_run_phase` of both drivers, on the same deterministic sim
  loop with a recording stub database and a counted fake clock, issues
  the same calls with the same keys and values for every phase kind and
  client ids 0-3 (mixed-contended with one transaction_throttled
  rejection, and the penalty it seeds).
- Reports: `run` of both drivers over real processes (oracle backend,
  merged and two-proxy topologies) gives reports that round-trip through
  JSON with equal topology and equal nested keys, but for the port's own
  keys ("boot_s", "resolver"), which name what the core actually ran.
- The device and sharded backends run on device="cpu" at small shapes;
  device="cuda" where CUDA is absent raises platform_error and leaves no
  process behind.
- Pure pieces equal the reference's: `_pcts`, `_merge_pcts`, `_zipf_idx`,
  `interleaved_medians`, `_stage_breakdown` on the same trace files,
  `_engine_rows`' counts and shapes, `_cluster_restart_rows`' virtual
  seconds.
- The stray-process killer touches only processes that this driver
  started; the driver and bench.py import nothing of JAX.

The reference's own `_kill_stray_servers` pkills every JAX server_main on
the host (other test files' servers too), so it is replaced by a no-op
while this file runs the reference's `run`; and since other test files
call it, the reference's servers and workers that this file starts are
launched through `python -c` with their argv hex-encoded, where none of
its `pkill -f` patterns can match them.
"""

import json
import os
import random
import re
import subprocess
import sys
import time
import types

import pytest
import torch

import bench_e2e as ref
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch import bench
from foundationdb_tpu_torch import bench_e2e as port
from foundationdb_tpu_torch.core.eventloop import EventLoop
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("write", "read", "mixed", "mixed-contended", "zipfian-read")
PORT_KEYS = ("boot_s", "resolver")  # the port's own report keys
# test_bench_smoke.py's sharded slice's chunk shape (the preload's 100-write
# txns fit one chunk) at the driver's own state size: 2,000 keys make at
# most ~4,000 boundaries, so 8,192 slots hold every run's state
SMALL = {"CONFLICT_BATCH_TXNS": 16, "CONFLICT_BATCH_READS_PER_TXN": 2,
         "CONFLICT_BATCH_WRITES_PER_TXN": 8,
         "CONFLICT_STATE_CAPACITY": 8192}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The servers inherit the environment: one torch thread each, so the
    cores' plain steps do not fight the other test processes for cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


# ---------------------------------------------------------------- op streams

class Throttled(Exception):
    name = "transaction_throttled"

    def __init__(self, key):
        super().__init__(self.name)
        self.key = key


class StubTxn:
    def __init__(self, db, tid):
        self.db, self.tid = db, tid

    async def _hop(self):
        await self.db.loop.delay(0.001)

    async def get_read_version(self):
        self.db.log.append((self.tid, "grv"))
        await self._hop()
        return 1

    async def get(self, key):
        self.db.log.append((self.tid, "get", key))
        await self._hop()
        return b"v"

    async def get_many(self, keys):
        self.db.log.append((self.tid, "get_many", tuple(keys)))
        await self._hop()
        return [b"v"] * len(keys)

    def set(self, key, value):
        self.db.log.append((self.tid, "set", key, value))

    async def commit(self):
        self.db.commits += 1
        n = self.db.commits
        self.db.log.append((self.tid, "commit"))
        await self._hop()
        if n == self.db.throttle_at:
            raise Throttled(self.db.last_hot)


class StubDb:
    """Records every call; the `throttle_at`-th commit raises a
    transaction_throttled whose key then stays penalized."""

    def __init__(self, loop, throttle_at=0):
        self.loop, self.log, self.commits = loop, [], 0
        self.throttle_at, self.penalized = throttle_at, set()
        self.last_hot = None

    def create_transaction(self):
        self.log.append(("create",))
        return StubTxn(self, len(self.log))

    def _penalty_wait(self, write_ranges):
        self.log.append(("penalty", tuple(write_ranges)))
        key = write_ranges[0][0]
        self.last_hot = key
        return 0.5 if key in self.penalized else 0.0

    def _note_throttle(self, e):
        self.log.append(("note_throttle", e.key))
        self.penalized.add(e.key)
        return 0.5


def drive(module, monkeypatch, kind):
    loop = EventLoop()
    db = StubDb(loop, throttle_at=30 if kind == "mixed-contended" else 0)
    ticks = [0]

    def perf_counter():
        ticks[0] += 1
        return ticks[0] * 1e-3

    monkeypatch.setattr(module.time, "perf_counter", perf_counter)
    out = loop.run_future(loop.spawn(module._run_phase(
        loop, db, kind, 4, 0.4, ramp=0.01)))
    monkeypatch.undo()
    return db.log, out


@pytest.mark.parametrize("kind", KINDS)
def test_op_streams_equal_the_reference(monkeypatch, kind):
    got_log, got = drive(port, monkeypatch, kind)
    want_log, want = drive(ref, monkeypatch, kind)
    assert got_log == want_log
    assert got == want
    n_txn = sum(1 for e in got_log if e == ("create",))
    assert n_txn > 8, n_txn
    if kind == "mixed-contended":
        assert any(e[0] == "note_throttle" for e in got_log)
        assert any(e[0] == "penalty" for e in got_log)
        assert got[4].get("transaction_throttled") == 1
    if kind == "write":
        assert not any(e[1] in ("get", "get_many") for e in got_log
                       if len(e) > 1)


# ------------------------------------------------------------------- reports

# The reference killer's patterns (bench_e2e.py:86), and the launcher that
# runs a reference server (`-m foundationdb_tpu.net.server_main spec`) or
# worker (`bench_e2e.py --worker spec`) from its hex-encoded argv
REF_KILL_PATTERNS = ("foundationdb_tpu.net.server_main",
                     "bench_e2e.py --worker")
LAUNCH = ("import json, runpy, sys; a = json.loads(bytes.fromhex(sys.argv[1]))"
          "; sys.argv = a[1:] if a[0] == '-m' else a"
          "; runpy.run_module(a[1], run_name='__main__', alter_sys=True) "
          "if a[0] == '-m' else runpy.run_path(a[0], run_name='__main__')")


def unmatched_subprocess(launched):
    """The reference module's `subprocess`, but for a Popen that starts
    its servers and workers through LAUNCH (each command appended to
    `launched`)."""
    def popen(cmd, *a, **kw):
        if cmd[1:3] == ["-m", "foundationdb_tpu.net.server_main"] \
                or cmd[2:3] == ["--worker"]:
            cmd = [cmd[0], "-c", LAUNCH, json.dumps(cmd[1:]).encode().hex()]
        launched.append(cmd)
        return subprocess.Popen(cmd, *a, **kw)
    return types.SimpleNamespace(**dict(vars(subprocess), Popen=popen))


@pytest.fixture(scope="module")
def reports():
    """The reference's and the port's oracle reports at n_proxies 0 and 2:
    booting the process clusters is this file's whole cost. The
    reference's processes start through LAUNCH (under "launched")."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "_kill_stray_servers", lambda: None)
    launched = []
    mp.setattr(ref, "subprocess", unmatched_subprocess(launched))
    out = {"launched": launched}
    try:
        for n in (0, 2):
            kw = dict(clients=20, seconds=0.5, backend="oracle",
                      n_proxies=n, n_storage=1, n_client_procs=1)
            out[("ref", n)] = ref.run(**kw)
            out[("port", n)] = port.run(**kw)
    finally:
        mp.undo()
    return out


def key_paths(d, path=()):
    """Every nested key path; the port's own keys and each phase's
    `resolver` left out, `errors` a leaf (its keys are error names)."""
    out = set()
    for k, v in d.items():
        if k in PORT_KEYS:
            continue
        out.add(path + (k,))
        if isinstance(v, dict) and k != "errors":
            out |= key_paths(v, path + (k,))
    return out


@pytest.mark.parametrize("n_proxies", [0, 2], ids=["merged", "fanout2"])
def test_report_is_the_references_report(reports, n_proxies):
    got = json.loads(json.dumps(reports[("port", n_proxies)]))
    want = json.loads(json.dumps(reports[("ref", n_proxies)]))
    assert got["topology"] == want["topology"] == {
        "commit_proxies": max(n_proxies, 1), "grv_proxies": 0,
        "storage": 1, "replicas": 1, "client_procs": 1,
        "merged_core": n_proxies == 0}
    assert key_paths(got) == key_paths(want)
    assert got["resolver"] == {"backend": "oracle", "device": None}
    labels = {"core", "storage0"} | {f"proxy{i}" for i in range(n_proxies)}
    assert set(got["boot_s"]) == labels
    for kind in ("write", "read", "mixed"):
        entry = got[kind]
        assert entry["ops_per_sec"] > 0, (kind, entry)
        assert "grv_ms_p50" in entry
        if kind != "read":
            assert "commit_ms_p50" in entry and "commit_ms_p99" in entry
        assert entry["resolver"] == {"chunks": 0, "launches": {}}


def test_reference_processes_escape_the_reference_killer(reports):
    """Every reference server and worker the fixture started (the core,
    the proxies and the storage server of each run, a worker a phase) has
    a command line that no pattern of the reference's `pkill -f`
    matches."""
    argvs = [json.loads(bytes.fromhex(cmd[3])) for cmd in reports["launched"]]
    assert sum(a[0] == "-m" for a in argvs) == 2 + 4
    assert sum(a[1:2] == ["--worker"] for a in argvs) == 3 * 2
    for cmd in reports["launched"]:
        assert cmd[1:3] == ["-c", LAUNCH]
        line = " ".join(cmd)
        assert not any(re.search(p, line) for p in REF_KILL_PATTERNS), line
    # the reference's own argv, which the launcher hides, would match
    for argv in (["-m", "foundationdb_tpu.net.server_main", "{}"],
                 [ref._SELF, "--worker", "{}"]):
        assert any(re.search(p, " ".join(argv)) for p in REF_KILL_PATTERNS)


def test_reports_leave_no_marked_process(reports):
    """Every process the runs in this process started was waited for and
    unmarked (other test processes' runs may hold pid files meanwhile)."""
    mine = []
    for name in (os.listdir(port._PID_DIR)
                 if os.path.isdir(port._PID_DIR) else []):
        try:
            with open(os.path.join(port._PID_DIR, name)) as f:
                if int(f.read().split()[1]) == os.getpid():
                    mine.append(name)
        except (OSError, IndexError, ValueError):
            continue
    assert mine == []


# ------------------------------------------- the device backends on the CPU

def test_device_backend_runs_on_the_cpu(monkeypatch):
    seen = {}
    breakdown = port._stage_breakdown

    def kept(trace_dir):
        seen["dir"] = trace_dir
        return breakdown(trace_dir)
    monkeypatch.setattr(port, "_stage_breakdown", kept)
    report = port.run(clients=20, seconds=0.5, backend="device",
                      device="cpu", phases=("write", "mixed"),
                      n_client_procs=1, extra_knobs=SMALL, trace=True)
    decoded = json.loads(json.dumps(report))
    assert decoded["conflict_backend"] == "device"
    assert decoded["resolver"] == {"backend": "cpu", "device": "cpu"}
    assert "accelerator" not in decoded
    for kind in ("write", "mixed"):
        assert decoded[kind]["ops_per_sec"] > 0
        assert "commit_ms_p50" in decoded[kind]
        assert decoded[kind]["resolver"]["chunks"] > 0
    # the stage breakdown of the same trace files, by the reference's
    # trace_analyze, is the port's
    assert json.loads(json.dumps(ref._stage_breakdown(seen["dir"]))) == \
        decoded["stage_breakdown"]
    assert decoded["stage_breakdown"]["stages"]["Resolver.Dispatch"]["n"] > 0


def test_sharded_backend_runs_on_the_cpu():
    report = port.run(clients=20, seconds=0.5, backend="sharded",
                      device="cpu", phases=("write",), n_client_procs=1,
                      extra_knobs=dict(SMALL, CONFLICT_NUM_SHARDS=2))
    decoded = json.loads(json.dumps(report))
    assert decoded["conflict_backend"] == "sharded"
    assert decoded["resolver"] == {"backend": "cpux2", "device": "cpu"}
    assert decoded["write"]["ops_per_sec"] > 0
    assert "commit_ms_p50" in decoded["write"]


def test_cuda_without_a_card_raises_and_leaves_nothing(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spawned = []
    popen = port._popen

    def kept(cmd, **kw):
        spawned.append(popen(cmd, **kw))
        return spawned[-1]
    monkeypatch.setattr(port, "_popen", kept)
    with pytest.raises(FDBError) as ei:
        port.run(clients=20, seconds=0.5, backend="device",
                 phases=("write",), n_client_procs=1, n_proxies=2)
    assert ei.value.name == "platform_error"
    # the core exits with platform_error; the proxies and the storage
    # server, which build no engine, booted and were killed
    assert len(spawned) == 4
    assert all(p.poll() is not None for p in spawned)


def test_a_named_card_holds_several_shards(monkeypatch):
    from foundationdb_tpu_torch.parallel import sharded_conflict as tsh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [str(d) for d in tsh.make_resolver_mesh(2, "cuda:0")] == [
        "cuda:0", "cuda:0"]
    assert [str(d) for d in tsh.make_resolver_mesh(0, "cuda:0")] == [
        "cuda:0"]
    for bad in ((2, "cuda"), (1, "cuda:1")):
        with pytest.raises(FDBError) as ei:
            tsh.make_resolver_mesh(*bad)
        assert ei.value.name == "invalid_option"


# ---------------------------------------------------------------- bench.py

def test_run_e2e_runs_each_backend_in_its_own_process(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        if "device" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "platform_error")
        return subprocess.CompletedProcess(cmd, 0, '{"write": {}}', "")
    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    out = bench.run_e2e()
    assert out == {"oracle": {"write": {}},
                   "device": {"error": "platform_error"}}
    for (cmd, kw), backend in zip(calls, ("oracle", "device")):
        assert cmd[1:] == ["-m", "foundationdb_tpu_torch.bench_e2e",
                           backend, "--device=cuda"]
        assert kw["env"]["PYTHONPATH"] == ROOT


def test_bench_main_fails_when_an_e2e_run_failed(monkeypatch, capsys):
    """Both entries are printed, and a failed device subprocess makes the
    command exit non-zero."""
    def fake_run(cmd, **kw):
        if "device" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "poisoned")
        return subprocess.CompletedProcess(cmd, 0, '{"write": {}}', "")
    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setattr(bench, "run_kernel",
                        lambda *a, **kw: {"txns_per_sec": 1.0})
    assert bench.main([]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["e2e"] == {"oracle": {"write": {}},
                          "device": {"error": "poisoned"}}
    monkeypatch.setattr(bench.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 0, "{}", ""))
    assert bench.main([]) == 0


def test_bench_main_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setenv("FDB_TPU_BENCH_E2E", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FDBError) as ei:
        bench.run_main()
    assert ei.value.name == "platform_error"


# -------------------------------------------------------------- pure pieces

def test_pure_pieces_equal_the_reference():
    rng = random.Random(7)
    for _ in range(20):
        lat = [rng.random() for _ in range(rng.randrange(0, 300))]
        assert port._pcts(list(lat)) == ref._pcts(list(lat))
    parts = [port._pcts([rng.random() for _ in range(n)])
             for n in (0, 5, 120, 33)]
    assert port._merge_pcts(parts) == ref._merge_pcts(parts)
    assert port._merge_pcts([]) == ref._merge_pcts([]) == {}
    for r in [i / 997 for i in range(998)] + [0.0, 1.0]:
        assert port._zipf_idx(r) == ref._zipf_idx(r)
    assert port._ZIPF_CDF == ref._ZIPF_CDF
    assert port._KEYTAB == ref._KEYTAB
    assert (port.BASELINES, port.KEYS, port.HOT_KEYS) == (
        ref.BASELINES, ref.KEYS, ref.HOT_KEYS)


def test_interleaved_medians_equal_the_reference():
    def variants():
        rng = random.Random(11)

        def thunk(label):
            return lambda: {"read": {"ops_per_sec": rng.random(),
                                     "label": label}}
        return [(label, thunk(label)) for label in ("a", "b", "c")]
    got = port.interleaved_medians(variants(), phase="read", trials=5)
    want = ref.interleaved_medians(variants(), phase="read", trials=5)
    assert got == want
    assert len(got["a"]["read"]["trials"]) == 5


def test_engine_rows_equal_the_reference():
    try:
        got = port._engine_rows(2000, 128, 25_600)
        want = ref._engine_rows(2000, 128, 25_600)
    finally:
        JKNOBS.reset()
    timed = ("load_seconds", "recover_seconds", "cold_point_reads_per_sec",
             "cold_scan_keys_per_sec")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            assert {f: x for f, x in got[k].items() if f not in timed} == \
                {f: x for f, x in v.items() if f not in timed}, k
        else:
            assert got[k] == v, k


def test_cluster_restart_rows_equal_the_reference():
    from foundationdb_tpu.utils import trace as jtrace
    from foundationdb_tpu_torch.utils import trace as ttrace
    ttrace.set_sink(lambda _f: None)
    jtrace.set_sink(lambda _f: None)
    try:
        got = port._cluster_restart_rows(n_keys=20)
        want = ref._cluster_restart_rows(n_keys=20)
    finally:
        ttrace.set_sink(None)
        jtrace.set_sink(None)
        JKNOBS.reset()
    assert set(got) == set(want)
    for engine in ("memory", "ssd", "redwood"):
        assert got[engine]["sim_seconds"] == want[engine]["sim_seconds"]
    assert {k: v for k, v in got.items() if not isinstance(v, dict)} == \
        {k: v for k, v in want.items() if not isinstance(v, dict)}


# --------------------------------------------------------- the scoped killer

def test_the_killer_touches_only_this_drivers_processes(tmp_path):
    spec = {"listen": f"127.0.0.1:{port._free_port()}",
            "data_dir": str(tmp_path / "other"),
            "knobs": {"CONFLICT_BACKEND": "oracle"}, "roles": []}
    env = dict(os.environ, PYTHONPATH=ROOT)
    other = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.net.server_main",
         json.dumps(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    sleeper = [sys.executable, "-c", "import time; time.sleep(120)"]
    marked = port._popen(sleeper)
    # a process of a driver that still runs (here: the other server's
    # pid stands for a live driver) is not a stray either
    live = subprocess.Popen(sleeper)
    with open(os.path.join(port._PID_DIR, str(live.pid)), "w") as f:
        f.write(f"{port._start_time(live.pid)} {other.pid}")
    try:
        assert other.stdout.readline().startswith(b"ready")
        port._kill_stray_servers()
        assert marked.wait(timeout=10) == -9
        time.sleep(0.2)
        assert other.poll() is None
        assert live.poll() is None
        assert not os.path.exists(os.path.join(port._PID_DIR,
                                               str(marked.pid)))
    finally:
        for p in (other, marked, live):
            if p.poll() is None:
                p.kill()
            p.wait()
        port._unmark([live])


def test_driver_imports_nothing_of_jax():
    code = ("import foundationdb_tpu_torch.bench_e2e, "
            "foundationdb_tpu_torch.bench, sys; "
            "assert 'jax' not in sys.modules and not any("
            "m == 'foundationdb_tpu' or m.startswith('foundationdb_tpu.') "
            "for m in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
