"""The port's randomized simulation harness against the JAX harness.

The same seed goes through `testing.simulated_cluster` of both packages:
the seed draws the cluster (topology, replication, storage engine, conflict
backend and a buggified knob subset), picks or takes a spec, and runs its
workloads with their faults on the drawn RecoverableCluster. Each run
records:

- the SpecResult (rotations, epochs, virtual end time);
- every attempt's outcome with its virtual time and every DBInfo a cluster
  controller publishes (test_torch_recovery.py's Recorder);
- each workload's counters (ConflictRange's `checked` and `conflicts`,
  the fuzzers' models, ...) and the faults the workloads and the simulator
  log (Attrition's kills and reboots, each clogged pair, region kills,
  configuration changes, servers removed), with their virtual times;
- the final contents, read through a transaction after the spec's checks,
  and the virtual time then.

The two records must be equal, exactly. Under the device and sharded
backends the JAX side runs its JAX engines (CONFLICT_CPU_FALLBACK="jax",
the device engine pinned to one compiled program as in
test_torch_recovery.py) and the port's engines run their plain PyTorch
versions (CONFLICT_DEVICE="cpu"); the sharded draws run two shards on both
sides. This file holds tests/test_sim_tiers.py's ten pinned (spec, seed)
pairs and its harness checks; test_torch_sim_sweep.py and
test_torch_workloads.py import the helpers below.
"""

import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import test_torch_recovery as rec
from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.testing import simulated_cluster as j_sc
from foundationdb_tpu.testing import workloads as j_wl
from foundationdb_tpu.utils import trace as j_trace
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch.testing import simulated_cluster as t_sc
from foundationdb_tpu_torch.testing import workloads as t_wl
from foundationdb_tpu_torch.utils import trace as t_trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

PORT = SimpleNamespace(**vars(rec.PORT), sc=t_sc, wl=t_wl, trace=t_trace)
JAX = SimpleNamespace(**vars(rec.JAX), sc=j_sc, wl=j_wl, trace=j_trace)
STACKS = (PORT, JAX)

# tests/test_sim_tiers.py's pinned pairs and sweep seeds
PINNED_FAST = [
    ("cycle", 15),            # single/memory/sharded
    ("zipfian-hotkey", 2),    # single/memory/oracle (needs flat)
    ("zipfian-read-hotspot", 25),  # double/memory/oracle (needs flat)
    ("conflict-range", 2),    # single/memory/oracle
    ("fuzz-api", 19),         # single/redwood/oracle
    ("serializability", 23),  # single/ssd/oracle
    ("ryow", 22),             # single/memory/oracle
    ("change-config", 33),    # double/redwood/oracle (needs flat)
    ("remove-servers", 36),   # double/memory/device + spare storage
    ("kill-region", 49),      # two_region/ssd/oracle
]
FAST_SWEEP_SEEDS = [1, 2, 3, 4, 5, 7, 8, 10, 13, 15, 19, 25, 38, 46]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Both banks reset around each test; the port's engines on the CPU,
    the JAX engines on the XLA CPU backend, the JAX device engine pinned
    to one program per shape (decisions do not depend on the bucket). The
    port's trace events are dropped, and torch runs one thread: the
    harness's steps are small, and the suite's workers share the cores."""
    TKNOBS.reset()
    TKNOBS.set("CONFLICT_DEVICE", "cpu")
    JKNOBS.set("CONFLICT_CPU_FALLBACK", "jax")

    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, JKNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    t_trace.set_sink(lambda _fields: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    t_trace.set_sink(None)
    TKNOBS.reset()


def set_knobs(**kw):
    """The same knob values on both banks."""
    TKNOBS.overrides(**kw)
    JKNOBS.overrides(**kw)


def plain(value):
    """`value` if it is plain data (numbers, strings, bytes and containers
    of them), else None: a workload's counters and models, not its
    handles."""
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, (list, tuple, set, frozenset)):
        items = [plain(v) for v in value]
        return type(value)(items) if all(
            i is not None or v is None for i, v in zip(items, value)) \
            else None
    if isinstance(value, dict):
        items = {k: plain(v) for k, v in value.items()}
        return items if all(plain(k) is not None for k in items) and all(
            i is not None or value[k] is None for k, i in items.items()) \
            else None
    return None


def counters(w):
    """A workload's plain attributes but its cluster, rng and deadline."""
    out = {}
    for k, v in vars(w).items():
        if k in ("cluster", "rng", "stop_at"):
            continue
        p = plain(v)
        if p is not None or v is None:
            out[k] = p
    return type(w).__name__, out


# the trace events the workloads and the simulator log for their faults
FAULT_EVENTS = ("AttritionKill", "AttritionReboot", "AttritionStorageKill",
                "ChangeConfigApplied", "KillRegion", "RemovedServerSafely",
                "QuietDatabaseDone", "QuietDatabaseTimeout", "ClogPair")


def record(S, go, contents_time=60_000.0):
    """Run `go(S)`, which boots its RecoverableCluster(s) and runs them
    through `RecoverableCluster.run`, under the Recorder's hooks and hooks
    that note the clusters and every workload `init` sees, and with a
    trace sink that keeps the FAULT_EVENTS (at their virtual time) and
    drops the rest. Then read the last cluster's contents through a
    transaction. The hooks add no await and no timer."""
    with pytest.MonkeyPatch.context() as mp:
        r = rec.Recorder(S, mp)
        clusters: list = []
        workloads: list = []
        events: list = []

        def sink(fields):
            if fields["Type"] in FAULT_EVENTS:
                events.append((r.now() if r.loop else None, sorted(
                    (k, v) for k, v in fields.items() if k != "Time")))
        S.trace.set_sink(sink)
        run = S.cluster.RecoverableCluster.run
        init = S.wl.Workload.init

        def recorded_run(c, future, max_time=1000.0):
            if not clusters or clusters[-1] is not c:
                clusters.append(c)
            r.loop = c.loop
            return run(c, future, max_time)

        def recorded_init(w, cluster, rng, stop_at):
            workloads.append(w)
            return init(w, cluster, rng, stop_at)

        mp.setattr(S.cluster.RecoverableCluster, "run", recorded_run)
        mp.setattr(S.wl.Workload, "init", recorded_init)

        async def read_all(db):
            await db.refresh()

            async def read(tr):
                return await tr.get_range(b"", b"\xff")
            return await db.transact(read, max_retries=500)

        try:
            result = go(S)
            c = clusters[-1]
            db = c.database()
            rows = c.run(c.loop.spawn(read_all(db)), max_time=contents_time)
        finally:
            S.trace.set_sink((lambda _fields: None) if S is PORT else None)
    return SimpleNamespace(
        result=result, attempts=r.attempts, dbinfos=r.dbinfos,
        epochs=r.epochs(), counters=[counters(w) for w in workloads],
        events=events,
        contents=[tuple(kv) for kv in rows], end=c.loop.now(),
        clusters=len(clusters))


def spec_record(result):
    """A run's result as plain data: a RandomizedResult or SpecResult
    field by field, a workload by its counters, containers item by item."""
    if hasattr(result, "draw"):
        return (result.seed, result.spec, result.draw.distinct_tuple(),
                spec_record(result.result))
    if hasattr(result, "rotations") and hasattr(result, "elapsed"):
        return (result.seed, result.rotations, result.epochs,
                result.elapsed)
    if isinstance(result, (list, tuple)):
        return [spec_record(r) for r in result]
    if hasattr(result, "stop_at"):  # an initialized workload
        return counters(result)
    return result


def assert_same_records(port, jax):
    assert spec_record(port.result) == spec_record(jax.result)
    assert port.attempts == jax.attempts
    assert port.dbinfos == jax.dbinfos
    assert port.counters == jax.counters
    assert port.events == jax.events
    assert port.contents == jax.contents
    assert port.end == jax.end
    assert port.clusters == jax.clusters
    assert port.dbinfos and port.attempts  # something was compared


def both(go, **kw):
    """`go` on the port, then on the JAX package, held equal; the port's
    record."""
    port = record(PORT, go, **kw)
    jax = record(JAX, go, **kw)
    assert_same_records(port, jax)
    return port


def randomized(seed, spec=None, **kw):
    def go(S):
        return S.sc.run_randomized_spec(seed, spec=spec, **kw)
    return go


@pytest.mark.parametrize("spec_name,seed", PINNED_FAST,
                         ids=[s for s, _ in PINNED_FAST])
def test_fast_spec_matches_jax(spec_name, seed):
    port = both(randomized(seed, spec_name))
    assert port.result.spec == spec_name
    assert port.result.result.elapsed > 0


def test_pinned_draws_are_what_the_reference_pins():
    """The pinned seeds draw, in the port, the clusters test_sim_tiers.py's
    comments name."""
    want = {"cycle": ("single", "memory", "sharded"),
            "zipfian-hotkey": ("single", "memory", "oracle"),
            "zipfian-read-hotspot": ("double", "memory", "oracle"),
            "conflict-range": ("single", "memory", "oracle"),
            "fuzz-api": ("single", "redwood", "oracle"),
            "serializability": ("single", "ssd", "oracle"),
            "ryow": ("single", "memory", "oracle"),
            "change-config": ("double", "redwood", "oracle"),
            "remove-servers": ("double", "memory", "device"),
            "kill-region": ("two_region", "ssd", "oracle")}
    for name, seed in PINNED_FAST:
        d = t_sc.ClusterDraw.draw(seed)
        assert (d.replication, d.storage_engine,
                d.conflict_backend) == want[name], name
        assert t_sc.SPECS[name].compatible(d)
    assert t_sc.ClusterDraw.draw(36).spare_storage > 0


def test_fast_sweep_draws_are_distinct_and_cover_the_axes():
    """test_sim_tiers.py's pure draw check, on the port: the sweep seeds
    draw pairwise-distinct environments covering every replication mode,
    engine and default backend."""
    draws = [t_sc.ClusterDraw.draw(s) for s in FAST_SWEEP_SEEDS]
    assert len({d.distinct_tuple() for d in draws}) == len(draws)
    assert len(draws) >= 12
    assert {d.replication for d in draws} == \
        {"single", "double", "two_region"}
    assert {d.storage_engine for d in draws} == {"memory", "ssd", "redwood"}
    assert {d.conflict_backend for d in draws} == \
        {"oracle", "device", "sharded"}


def test_spec_failure_carries_the_repro_line():
    """A failing spec surfaces the port's one-line repro command, with the
    draw, in the exception pytest reports."""
    class AlwaysFails(t_wl.Workload):
        name = "AlwaysFails"

        async def check(self, db):
            raise AssertionError("injected failure")

    spec = t_sc.Spec("always-fails", "fast", lambda rng: [AlwaysFails()],
                     duration=2.0)
    with pytest.raises(t_sc.SpecFailure) as ei:
        t_sc.run_randomized_spec(2, spec=spec, allow_backends=("oracle",))
    msg = str(ei.value)
    assert "--seed 2 --spec always-fails" in msg
    assert "python -m foundationdb_tpu_torch.testing.simulated_cluster" \
        in msg
    assert "drew:" in msg and "injected failure" in msg


def test_incompatible_explicit_spec_is_rejected():
    d = t_sc.ClusterDraw.draw(2)
    assert d.replication != "two_region"
    with pytest.raises(ValueError):
        t_sc.run_randomized_spec(2, spec="kill-region")


def test_backup_attrition_equals_reference():
    """The slow spec that runs a live backup under attrition and restores
    it into a fresh cluster (test_sim_tiers.py's pinned seed 24, its full
    35 virtual seconds) gives equal records on both harnesses; the knob
    bank is restored."""
    before = dict(TKNOBS._values)
    port = both(randomized(24, "backup-attrition"))
    assert TKNOBS._values == before
    assert port.result.spec == "backup-attrition"
    assert port.clusters == 1
    (backup,) = [c for name, c in port.counters
                 if name == "BackupUnderAttritionWorkload"]
    assert backup["writes"] > 0 and backup["end_version"] > 0
    assert any(k.startswith(b"bk/") for k, _v in port.contents)


def test_default_device_draw_raises_platform_error_without_a_card():
    """With the port's default CONFLICT_DEVICE ("cuda") and no card, a
    device draw refuses; it never falls back to the CPU or the oracle."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    TKNOBS.set("CONFLICT_DEVICE", "cuda")
    before = dict(TKNOBS._values)
    for seed, spec in ((36, "remove-servers"), (15, "cycle")):
        with pytest.raises(rec.PORT.errors.FDBError) as ei:
            t_sc.run_randomized_spec(seed, spec=spec, duration=2.0)
        assert ei.value.name == "platform_error"
        assert TKNOBS._values == before


def test_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import foundationdb_tpu_torch.testing\n"
            "import foundationdb_tpu_torch.storage.redwood\n"
            "from foundationdb_tpu_torch.testing import simulated_cluster\n"
            "simulated_cluster.ClusterDraw.draw(7)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'foundationdb_tpu')]\n"
            "assert not bad, bad\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)


def test_cli_replays_a_seed_on_the_cpu_knobs(capsys):
    """`main` replays one seed and prints the reference's OK line."""
    assert t_sc.main(["--seed", "2", "--spec", "conflict-range",
                      "--duration", "5"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("OK seed=2 spec=conflict-range [single/memory/")
