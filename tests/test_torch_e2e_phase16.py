"""chip_smoke.py's phase 16 at a small size on the CPU.

16b and 16c run the port's end-to-end driver in this process with the
core started as `recorded_server_main` (the engine on the CPU at the
chunk shape of test_bench_smoke.py's sharded slice): every resolver batch
held to the oracle (16c, two shards: the clipped-oracle model, through
its re-cuts), every process exiting 0 on SIGTERM, the reports well
formed. The replay into the clipped-oracle model follows the port's
sharded engine through re-cuts, and it and the report checks are also
held to inputs that must fail them.
"""

import argparse

import pytest
import torch

from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
SMALL = {"CONFLICT_BATCH_TXNS": 16, "CONFLICT_BATCH_READS_PER_TXN": 2,
         "CONFLICT_BATCH_WRITES_PER_TXN": 8,
         "CONFLICT_STATE_CAPACITY": 8192}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The servers inherit the environment: one torch thread each, so the
    cores' plain steps do not fight the other test processes for cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True)
def _port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def test_chip_smoke_phase16_checks_pass_on_the_cpu():
    import chip_smoke

    out = chip_smoke.e2e_phase(CPU, runs=("16b", "16c"), sizes={
        "16b": {"clients": 40, "seconds": 1.5, "n_client_procs": 1,
                "extra_knobs": SMALL},
        "16c": {"clients": 40, "seconds": 0.5, "n_client_procs": 1,
                "extra_knobs": dict(SMALL, CONFLICT_NUM_SHARDS=2)}})
    b, c = out["16b"], out["16c"]
    assert b["resolver"] == {"backend": "cpu", "device": "cpu"}
    assert c["resolver"] == {"backend": "cpux2", "device": "cpu"}
    for run in (b, c):
        assert run["resolved_batches"] > 0
        assert run["mismatched_batches"] == 0
        assert run["chunks"] > 0
    assert set(b["boot_s"]) == {"core", "proxy0", "proxy1", "storage0",
                                "storage1"}
    assert b["mixed"]["ops_per_sec"] > 0
    assert b["mixed-contended"]["ops_per_sec"] > 0
    assert set(chip_smoke.E2E_STAGES) <= set(b["stages"])
    assert c["write"]["ops_per_sec"] > 0


def hook_of(requests, replies, cuts, cuts0, recuts=()):
    rec = {"requests": requests, "replies": replies, "cuts": cuts,
           "cuts0": cuts0, "recuts": list(recuts), "recovery_version": 0,
           "buckets": {"16x8": len(replies)}}
    return argparse.Namespace(instances=[rec], roles=[lambda: None])


def test_clipped_replay_holds_shards_across_a_recut():
    import chip_smoke
    from foundationdb_tpu_torch.ops.batch import COMMITTED, CONFLICT
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet

    cuts, recut = [b"", b"m"], [b"", b"q"]
    # txn 0 writes [a, b) and [x, y); txn 1 reads [a, b): it conflicts in
    # shard 0 only; txn 2 reads [x, y) at the same snapshot. At 30 the cut
    # moves to q: shard 0 acquires [m, q), filled at 30, so txn 3's read
    # there at 25 conflicts, while txn 4's read of [x, y) at 15 on shard
    # 1's retained range commits
    t0 = TxnConflictInfo(0, [], [(b"a", b"b"), (b"x", b"y")])
    t1 = TxnConflictInfo(0, [(b"a", b"b")], [])
    t2 = TxnConflictInfo(0, [(b"x", b"y")], [])
    t3 = TxnConflictInfo(25, [(b"n", b"o")], [])
    t4 = TxnConflictInfo(15, [(b"x", b"y")], [])
    reqs = {10: argparse.Namespace(transactions=[t0]),
            20: argparse.Namespace(transactions=[t1, t2]),
            30: argparse.Namespace(transactions=[t3, t4])}
    oracles = [OracleConflictSet(0), OracleConflictSet(0)]
    want = {v: chip_smoke.shard_oracle_detect(oracles, cuts,
                                              reqs[v].transactions, v)
            for v in (10, 20)}
    assert want[20] == [CONFLICT, CONFLICT]
    want[30] = [CONFLICT, COMMITTED]
    decided = {10: cuts, 20: cuts, 30: recut}

    hook = hook_of(reqs, dict(want), decided, cuts, [(30, recut)])
    assert chip_smoke.replay_into_oracles(hook, clipped=True) == (3, 0, 0)
    assert hook.instances[0]["recuts_replayed"] == 1
    assert hook.instances[0]["after_recut"] == 1

    # the same statuses without the re-cut applied differ at 30 (txn 3
    # commits in the old partition), and the cuts differ from the
    # engine's: both count
    hook = hook_of(reqs, dict(want), decided, cuts)
    assert chip_smoke.replay_into_oracles(hook, clipped=True) == (3, 2, 0)

    bad = dict(want)
    bad[20] = [want[10][0]] * 2
    hook = hook_of(reqs, bad, {10: cuts, 20: cuts}, cuts)
    reqs.pop(30)
    bad.pop(30)
    assert chip_smoke.replay_into_oracles(hook, clipped=True) == (2, 1, 0)


@pytest.mark.parametrize("recuts", [
    ((4, [b"", b"\x40"]), (8, [b"", b"\xc0"])),
    ((3, [b"", b"\xe0"]), (6, [b"", b"\x10"]), (6, [b"", b"\x90"]))],
    ids=["down-up", "up-down-twice"])
def test_clipped_replay_follows_the_sharded_engine_through_recuts(recuts):
    """The port's sharded engine on two CPU shards, its partition recorded
    as phase 16c records it and re-cut between batches (twice before one
    batch in the second case), decides every batch as the clipped-oracle
    model that replays its re-cuts."""
    import numpy as np

    import chip_smoke
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        ShardedDeviceConflictSet)
    eng = ShardedDeviceConflictSet(devices=["cpu"] * 2, capacity=1024,
                                   txns=16, reads_per_txn=4,
                                   writes_per_txn=4)
    rec = {"requests": {}, "replies": {}, "recovery_version": 0,
           "buckets": {}}
    chip_smoke.record_cuts(eng, rec)
    rng = np.random.default_rng(7)

    def rrange():
        a = bytes(rng.integers(0, 256, int(rng.integers(1, 3))).tolist())
        return (a, a + bytes([int(rng.integers(1, 256))]))
    version, planned = 100, list(recuts)
    for i in range(12):
        while planned and planned[0][0] == i:
            cuts = planned.pop(0)[1]
            eng.rebalance_cuts(cuts, version)
        txns = [TxnConflictInfo(
            version - int(rng.integers(0, 60)),
            [rrange() for _ in range(int(rng.integers(0, 4)))],
            [rrange() for _ in range(int(rng.integers(0, 4)))])
            for _ in range(16)]
        rec["requests"][version] = argparse.Namespace(transactions=txns)
        rec["replies"][version] = eng.detect(txns, version)
        version += int(rng.integers(5, 30))
    assert eng.rebalances == len(recuts)
    hook = argparse.Namespace(instances=[rec], roles=[lambda: None])
    statuses = [s for v in rec["replies"].values() for s in v]
    assert len(set(statuses)) > 1
    assert chip_smoke.replay_into_oracles(hook, clipped=True) == (12, 0, 0)
    assert rec["recuts_replayed"] == len(recuts)
    assert rec["after_recut"] == 12 - recuts[0][0]


def test_report_checks_catch_a_missing_phase_and_latency():
    import chip_smoke

    entry = {"ops_per_sec": 10.0, "grv_ms_p50": 1.0, "commit_ms_p50": 2.0,
             "commit_ms_p99": 3.0, "committed_txns_per_sec": 2.0}
    report = {"write": dict(entry), "resolver": {"backend": "cpu"},
              "read": {"ops_per_sec": 0.0, "committed_txns_per_sec": 40.0}}
    bad = chip_smoke.e2e_report_failures(
        "16x", report, ("write", "read", "mixed"), "cuda", clients=10,
        seconds=4.0)
    assert len(bad) == 4, bad  # read's ops and GRV, no mixed, the engine
    assert chip_smoke.e2e_report_failures("16x", report, ("write",),
                                          "cpu") == []
    # a reading phase whose window held under 16 transactions a client
    # timed no GRV (the driver times every 16th); a write phase always does
    report["read"] = {"ops_per_sec": 1.0, "committed_txns_per_sec": 39.0}
    assert chip_smoke.e2e_report_failures(
        "16x", report, ("read",), clients=10, seconds=4.0) == []
    del report["write"]["grv_ms_p50"]
    assert len(chip_smoke.e2e_report_failures(
        "16x", report, ("write",), clients=10, seconds=4.0)) == 1
