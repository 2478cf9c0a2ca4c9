"""Randomized simulation harness: seed -> ClusterDraw -> spec -> repro line.

Reference: fdbserver/SimulatedCluster.actor.cpp:1239 (simulationSetupAndRun)
— the simulator NEVER runs on a fixed cluster. Every seed draws a random
topology (process / proxy / resolver / tlog counts), replication mode,
storage engine, conflict backend, and a buggified knob subset; the spec's
workloads then run against whatever came up. Fault coverage comes from
randomizing the ENVIRONMENT, not just the fault schedule ("Torturing
Databases for Fun and Profit", OSDI '14).

Specs are organized into graded tiers mirroring the reference's
tests/fast|slow/ split: the fast tier runs as a seeded sweep inside tier-1
CI; the slow tier sits behind the `slow` pytest marker.

Every failure prints a ONE-LINE REPRO command: the draw is a pure function
of the seed, so `python -m foundationdb_tpu_torch.testing.simulated_cluster
--seed N --spec NAME` replays the identical cluster, knobs, faults, and
workload schedule.

This is the PyTorch port's copy of the JAX package's harness, line for line
but for the device plumbing: the draws are the reference's, seed for seed,
and their device and sharded backends run the port's engines on the
CONFLICT_DEVICE knob's device (a card by default; the tests set "cpu").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from foundationdb_tpu_torch.testing import fuzz_workloads as F
from foundationdb_tpu_torch.testing import workloads as W
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

# static batch shapes for the device conflict engines: the reference's
# simulator shape, identical across draws so every device/sharded draw runs
# the same engine shape (tests/test_fault_cocktail.py idiom)
_ACCEL_FAST_SHAPE = {
    "CONFLICT_BATCH_TXNS": 16,
    "CONFLICT_BATCH_READS_PER_TXN": 2,
    "CONFLICT_BATCH_WRITES_PER_TXN": 2,
    "CONFLICT_STATE_CAPACITY": 2048,
}

DEFAULT_BACKENDS = ("oracle", "device", "sharded")
DEFAULT_ENGINES = ("memory", "ssd", "redwood")

# sharded draws run the key-partitioned engine; 2 shards keeps it small
# while still crossing a cut boundary
_SHARDED_SIM_SHAPE = {
    "CONFLICT_NUM_SHARDS": 2,
}


def _ensure_mesh_devices():
    """Sharded draws need CONFLICT_NUM_SHARDS shards. On CUDA each shard
    takes a card: with fewer cards attached, shrink the mesh width instead
    (one H100 runs a 1-wide engine, which still runs the sharded chunk;
    per-shard "earlier txns win" may then abort other txns than at width 2,
    never committing a conflicting one). On the CPU the shards share the
    CPU (make_resolver_mesh), so the width stays."""
    import torch
    if torch.device(KNOBS.CONFLICT_DEVICE).type != "cuda":
        return
    avail = torch.cuda.device_count()
    if 0 < avail < int(KNOBS.CONFLICT_NUM_SHARDS):
        KNOBS.set("CONFLICT_NUM_SHARDS", avail)

# redwood draws shrink the engine's budgets so test-scale datasets actually
# flush and compact (at the production defaults a 25s spec never fills the
# 4MB memtable and the LSM path would go unexercised)
_REDWOOD_SIM_SHAPE = {
    "REDWOOD_MEMTABLE_BYTES": 2_048,
    "REDWOOD_BLOCK_BYTES": 512,
    "REDWOOD_COMPACTION_FAN_IN": 2,
}


@dataclass(frozen=True)
class ClusterDraw:
    """Everything SimulatedCluster randomizes per seed, as one record. A
    pure function of the seed (see draw()): the repro line only needs the
    seed, the rest is documentation for the human reading the failure."""

    seed: int
    replication: str       # "single" | "double" | "two_region"
    storage_engine: str    # "memory" | "ssd" | "redwood"
    conflict_backend: str  # "oracle" | "device" | "sharded"
    n_workers: int
    n_proxies: int
    n_resolvers: int
    n_tlogs: int
    n_storage: int
    n_replicas: int
    spare_storage: int     # storage workers beyond n_storage * n_replicas
    knobs: tuple           # sorted (name, value) buggified subset

    @classmethod
    def draw(cls, seed: int,
             allow_backends: tuple = DEFAULT_BACKENDS,
             allow_engines: tuple = DEFAULT_ENGINES,
             allow_two_region: bool = True,
             buggify_probability: float = 0.25) -> "ClusterDraw":
        """The per-seed environment draw (SimulatedCluster.actor.cpp:1239).
        Pure: same (seed, allow-lists) -> same draw, no global state read
        beyond the static knob registry."""
        rng = DeterministicRandom(seed)
        r = rng.random()
        if allow_two_region and r < 0.25:
            replication = "two_region"
        elif r < 0.60:
            replication = "double"
        else:
            replication = "single"
        engine = allow_engines[rng.randint(0, len(allow_engines) - 1)]
        backend = allow_backends[rng.randint(0, len(allow_backends) - 1)]
        knobs = tuple(sorted(KNOBS.draw_buggified(
            rng.fork(), probability=buggify_probability).items()))
        if replication == "two_region":
            # the dual-region layout fixes the txn-subsystem shape
            # (RecoverableCluster.two_region); the seed still draws the
            # storage width
            return cls(seed=seed, replication=replication,
                       storage_engine=engine, conflict_backend=backend,
                       n_workers=6, n_proxies=1, n_resolvers=1, n_tlogs=1,
                       n_storage=rng.randint(1, 2), n_replicas=1,
                       spare_storage=0, knobs=knobs)
        n_replicas = 2 if replication == "double" else 1
        n_proxies = rng.randint(1, 3)
        n_resolvers = rng.randint(1, 2)
        n_tlogs = rng.randint(1, 3)
        n_storage = rng.randint(1, 3)
        spare = rng.randint(0, 1)
        n_workers = max(5, max(n_proxies, n_resolvers) + n_tlogs + 2)
        return cls(seed=seed, replication=replication,
                   storage_engine=engine, conflict_backend=backend,
                   n_workers=n_workers, n_proxies=n_proxies,
                   n_resolvers=n_resolvers, n_tlogs=n_tlogs,
                   n_storage=n_storage, n_replicas=n_replicas,
                   spare_storage=spare, knobs=knobs)

    # -- identity --

    def topology(self) -> tuple:
        return (self.n_workers, self.n_proxies, self.n_resolvers,
                self.n_tlogs, self.n_storage, self.n_replicas,
                self.spare_storage)

    def distinct_tuple(self) -> tuple:
        """(topology, replication, engine, knobs): the axes the sweep must
        demonstrably vary across seeds."""
        return (self.topology(), self.replication, self.storage_engine,
                self.conflict_backend, self.knobs)

    def summary(self) -> str:
        kn = ",".join(f"{k}={v}" for k, v in self.knobs) or "-"
        return (f"{self.replication}/{self.storage_engine}/"
                f"{self.conflict_backend} workers={self.n_workers} "
                f"proxies={self.n_proxies} resolvers={self.n_resolvers} "
                f"tlogs={self.n_tlogs} "
                f"storage={self.n_storage}x{self.n_replicas}"
                f"+{self.spare_storage} knobs[{kn}]")

    def repro_line(self, spec_name: str, duration: float) -> str:
        return (f"python -m foundationdb_tpu_torch.testing.simulated_cluster "
                f"--seed {self.seed} --spec {spec_name} "
                f"--duration {duration:g}  # drew: {self.summary()}")

    # -- realization --

    def apply_knobs(self):
        """Install the draw into the global knob bank (caller saves and
        restores around the run): buggified subset first, then the engine /
        backend picks, then the accelerator fast shapes (which must win so
        device draws share one compiled batch shape)."""
        for k, v in self.knobs:
            KNOBS.set(k, v)
        KNOBS.set("STORAGE_ENGINE", self.storage_engine)
        KNOBS.set("CONFLICT_BACKEND", self.conflict_backend)
        if self.conflict_backend in ("device", "sharded"):
            for k, v in _ACCEL_FAST_SHAPE.items():
                KNOBS.set(k, v)
            # the port's engines run on CONFLICT_DEVICE with no fallback: a
            # device draw on a machine without the card refuses here
            # (platform_error), before a cluster boots
            from foundationdb_tpu_torch.utils.cudaenv import resolve_device
            resolve_device(KNOBS.CONFLICT_DEVICE)
        if self.conflict_backend == "sharded":
            for k, v in _SHARDED_SIM_SHAPE.items():
                KNOBS.set(k, v)
            _ensure_mesh_devices()
        if self.storage_engine == "redwood":
            for k, v in _REDWOOD_SIM_SHAPE.items():
                KNOBS.set(k, v)

    def factory(self) -> Callable:
        """cluster_factory for run_spec: boots the drawn shape."""
        from foundationdb_tpu_torch.server.cluster import RecoverableCluster

        def make(cluster_seed: int):
            if self.replication == "two_region":
                c = RecoverableCluster.two_region(
                    seed=cluster_seed, n_storage=self.n_storage,
                    n_replicas=self.n_replicas)
                # pre-create the client OUTSIDE every killable region, so a
                # KillRegion on the primary doesn't take the workload driver
                # down with it (tests/test_tworegion.py idiom)
                c.net.new_process("client:0", dc_id="client")
                return c
            return RecoverableCluster(
                seed=cluster_seed, n_workers=self.n_workers,
                n_proxies=self.n_proxies, n_resolvers=self.n_resolvers,
                n_tlogs=self.n_tlogs, n_storage=self.n_storage,
                n_replicas=self.n_replicas,
                n_storage_workers=(self.n_storage * self.n_replicas
                                   + self.spare_storage))
        return make


# ---------------------------------------------------------------------------
# graded spec tiers (the reference's tests/fast/ vs tests/slow/ split)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Spec:
    """One named test spec: a workload battery + what it needs from the
    drawn cluster (tests/fast/CycleTest.txt etc. as data)."""

    name: str
    tier: str                  # "fast" | "slow"
    build: Callable            # (rng) -> list[Workload]
    duration: float = 25.0
    needs: str = ""            # "" | "flat" | "two_region" | "spare_storage"
    knobs: tuple = ()          # (name, value) overrides the spec REQUIRES
    # (applied after the draw's, since the spec can't pass without them)

    def compatible(self, draw: ClusterDraw) -> bool:
        if self.needs == "two_region":
            return draw.replication == "two_region"
        if self.needs == "flat":
            return draw.replication != "two_region"
        if self.needs == "spare_storage":
            # exclusion drain moves the victim's replicas onto the spare —
            # it needs a replacement worker AND double replication (the
            # team stays readable while DD re-replicates the drained copy)
            return draw.replication == "double" and draw.spare_storage > 0
        return True


def _cycle_battery(rng):
    return [W.CycleWorkload(), W.ConsistencyCheckWorkload(),
            W.RandomCloggingWorkload(), W.AttritionWorkload()]


def _fuzz_api_battery(rng):
    return [F.FuzzApiCorrectnessWorkload(), W.CycleWorkload(),
            W.RandomCloggingWorkload(), W.AttritionWorkload()]


def _zipfian_hotkey_battery(rng):
    # the contention loop through a recovery: zipfian RMW hammering plus
    # attrition (worker kills -> full recoveries) and clogging
    return [F.ZipfianHotKeyWorkload(), W.RandomCloggingWorkload(),
            W.AttritionWorkload()]


def _zipfian_read_hotspot_battery(rng):
    # the read scale-out loop through faults: skewed readers asserting
    # version-consistency across every replica + the versioned hot-key
    # cache, while clogging forces hedged fail-overs and attrition forces
    # replica catch-up / cache rebuild after recoveries
    return [F.ZipfianReadHotspotWorkload(), W.RandomCloggingWorkload(),
            W.AttritionWorkload()]


def _serializability_battery(rng):
    return [F.SerializabilityWorkload(), W.RandomCloggingWorkload(),
            W.AttritionWorkload()]


def _ryow_battery(rng):
    return [F.RyowCorrectnessWorkload(), W.RandomCloggingWorkload()]


def _conflict_range_battery(rng):
    return [W.ConflictRangeWorkload(), W.RandomCloggingWorkload()]


def _change_config_battery(rng):
    return [W.CycleWorkload(), F.ChangeConfigWorkload(),
            W.RandomCloggingWorkload()]


def _remove_servers_battery(rng):
    return [W.CycleWorkload(), F.RemoveServersSafelyWorkload(),
            W.RandomCloggingWorkload()]


def _kill_region_battery(rng):
    return [W.CycleWorkload(), F.KillRegionWorkload(),
            W.RandomCloggingWorkload()]


def _backup_attrition_battery(rng):
    return [F.BackupUnderAttritionWorkload(), W.CycleWorkload(),
            W.RandomCloggingWorkload(), W.AttritionWorkload()]


def _swizzled_battery(rng):
    return [W.CycleWorkload(), F.FuzzApiCorrectnessWorkload(),
            W.ConflictRangeWorkload(), W.ConsistencyCheckWorkload(),
            W.SwizzleCloggingWorkload(), W.AttritionWorkload()]


def _two_region_fuzz_battery(rng):
    return [F.FuzzApiCorrectnessWorkload(), F.KillRegionWorkload(),
            W.RandomCloggingWorkload()]


SPECS: dict[str, Spec] = {s.name: s for s in [
    Spec("cycle", "fast", _cycle_battery),
    Spec("fuzz-api", "fast", _fuzz_api_battery),
    # needs=flat: under two_region + attrition this workload's per-key
    # commit ledger catches an acked-commit rollback across recovery (see
    # ROADMAP "two-region durability under attrition") — a pre-existing
    # exposure, tracked separately from the contention loop this spec pins
    Spec("zipfian-hotkey", "fast", _zipfian_hotkey_battery, needs="flat",
         # the throttle loop must ENGAGE at test scale: lower the conflict
         # threshold so the zipfian hot range crosses it within the run
         knobs=(("RK_THROTTLE_CONFLICT_RATE", 4.0),
                ("RK_THROTTLE_RELEASE_TPS", 8.0))),
    # needs=flat for the same acked-commit-rollback exposure as
    # zipfian-hotkey; under a "double" draw the readers exercise the
    # hedged multi-replica path, under "single" the same invariants pin
    # the cache alone. The knobs force the hot-range sketch to flag the
    # zipfian prefix within the run so the versioned cache engages.
    Spec("zipfian-read-hotspot", "fast", _zipfian_read_hotspot_battery,
         needs="flat",
         knobs=(("READ_CACHE_HOT_RATE", 1.0),
                ("READ_CACHE_REFRESH", 0.25),
                ("READ_CACHE_SAMPLE", 1))),
    Spec("serializability", "fast", _serializability_battery),
    Spec("ryow", "fast", _ryow_battery),
    Spec("conflict-range", "fast", _conflict_range_battery),
    Spec("change-config", "fast", _change_config_battery, needs="flat"),
    Spec("remove-servers", "fast", _remove_servers_battery,
         needs="spare_storage",
         knobs=(("DD_INTERVAL_SECONDS", 1.0),
                ("DD_STORAGE_FAILURE_SECONDS", 4.0))),
    Spec("kill-region", "fast", _kill_region_battery, needs="two_region"),
    Spec("backup-attrition", "slow", _backup_attrition_battery,
         duration=35.0, needs="flat"),
    Spec("swizzled-battery", "slow", _swizzled_battery, duration=60.0),
    Spec("two-region-fuzz", "slow", _two_region_fuzz_battery,
         duration=40.0, needs="two_region"),
]}

FAST_SPECS = [s for s in SPECS.values() if s.tier == "fast"]
SLOW_SPECS = [s for s in SPECS.values() if s.tier == "slow"]


@dataclass
class RandomizedResult:
    seed: int
    spec: str
    draw: ClusterDraw
    result: W.SpecResult


class SpecFailure(AssertionError):
    """A randomized spec failed; str() carries the one-line repro command
    (so pytest's report shows exactly how to replay the seed)."""


def run_randomized_spec(seed: int, spec: Spec | str | None = None,
                        tier: str = "fast", duration: float | None = None,
                        allow_backends: tuple = DEFAULT_BACKENDS,
                        allow_engines: tuple = DEFAULT_ENGINES,
                        allow_two_region: bool = True,
                        max_time: float = 600_000.0) -> RandomizedResult:
    """The harness entry point: draw the cluster from the seed, pick (or
    take) a spec, boot run_spec on the drawn cluster, and print a one-line
    repro command on ANY failure. Restores the global knob bank afterward."""
    draw = ClusterDraw.draw(seed, allow_backends=allow_backends,
                            allow_engines=allow_engines,
                            allow_two_region=allow_two_region)
    rng = DeterministicRandom(seed ^ 0x5BEC)
    if isinstance(spec, str):
        spec = SPECS[spec]
    if spec is None:
        cands = [s for s in SPECS.values()
                 if s.tier == tier and s.compatible(draw)]
        spec = cands[rng.randint(0, len(cands) - 1)]
    elif not spec.compatible(draw):
        raise ValueError(
            f"spec {spec.name!r} needs {spec.needs!r} but seed {seed} "
            f"drew {draw.replication}: pick a seed whose draw fits")
    dur = spec.duration if duration is None else duration
    saved = dict(KNOBS._values)
    try:
        draw.apply_knobs()
        for k, v in spec.knobs:
            KNOBS.set(k, v)
        workloads = spec.build(rng.fork())
        try:
            result = W.run_spec(seed, workloads=workloads, duration=dur,
                                buggify=False, max_time=max_time,
                                cluster_factory=draw.factory())
        except (AssertionError, Exception) as e:  # noqa: B014 — repro line
            # on EVERY failure class, then re-raise with it attached
            line = draw.repro_line(spec.name, dur)
            print(f"\n*** simulation spec failed — repro:\n    {line}",
                  flush=True)
            raise SpecFailure(
                f"spec {spec.name!r} failed under draw "
                f"[{draw.summary()}]: {e}\n  repro: {line}") from e
    finally:
        KNOBS._values.clear()
        KNOBS._values.update(saved)
    return RandomizedResult(seed=seed, spec=spec.name, draw=draw,
                            result=result)


def sweep(seeds, tier: str = "fast",
          wall_clock_budget: float | None = None,
          **kw) -> list[RandomizedResult]:
    """Run a seeded sweep of the tier, optionally wall-clock-capped (CI's
    bounded fast-tier sweep). Seeds beyond the budget are skipped — callers
    assert a minimum completed count, so a too-slow environment fails
    loudly instead of hanging."""
    import time
    t0 = time.monotonic()
    out: list[RandomizedResult] = []
    for s in seeds:
        if wall_clock_budget is not None \
                and time.monotonic() - t0 > wall_clock_budget:
            break
        out.append(run_randomized_spec(s, tier=tier, **kw))
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Replay one randomized simulation spec (the repro "
                    "command printed by a failing sweep).")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spec", default=None,
                    choices=sorted(SPECS), help="spec name; default: the "
                    "seed's own tier draw")
    ap.add_argument("--tier", default="fast", choices=("fast", "slow"))
    ap.add_argument("--duration", type=float, default=None)
    args = ap.parse_args(argv)
    r = run_randomized_spec(args.seed, spec=args.spec, tier=args.tier,
                            duration=args.duration)
    print(f"OK seed={r.seed} spec={r.spec} [{r.draw.summary()}] "
          f"epochs={r.result.epochs} elapsed={r.result.elapsed:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
