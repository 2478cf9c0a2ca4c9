"""chip_smoke.py's phase 15 at a small size on the CPU.

15a: two server_main processes (the txn one recorded by
`recorded_server_main`, its two resolvers on the port's engine on the CPU
at the small shape), the fdb_c lifecycle and error-mapping checks, two
short conformance runs through `bindingtester.compare_runs`, the
multiversion checks, the resolvers' metrics over the wire, SIGTERM, and
every resolver batch held to a fresh oracle. 15b: `graft_entry.entry` on
the CPU held field for field to the plain step, and the dryrun over four
shards; a step that differs from the plain one is reported.
"""

import pytest
import torch

from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
SMALL_RUNS = ((977, 300, b"bt_c/", b"bt_n/"), (31337, 200, b"bt2_c/",
                                                b"bt2_n/"))


@pytest.fixture(autouse=True)
def _port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def test_chip_smoke_phase15a_checks_pass_on_the_cpu(monkeypatch):
    import chip_smoke
    from test_torch_transport import SHAPE_KNOBS, free_addr

    monkeypatch.setattr(chip_smoke, "net_addresses",
                        lambda n: [free_addr() for _ in range(n)])
    a, failures = chip_smoke.bindings_process_phase(
        CPU, 15, runs=SMALL_RUNS, knobs=SHAPE_KNOBS, min_compared=100)
    assert failures == []
    assert a["ops"] == 1000 and a["compared"] > 100
    assert a["attempts"] >= a["commits"] > 0
    assert a["resolved_batches"] > 0 and a["mismatched_batches"] == 0
    assert [r["backend"] for r in a["resolvers"]] == ["device", "device"] \
        or all(r["device"] == "cpu" for r in a["resolvers"])
    assert all(r["decided_batches"] > 0 for r in a["resolvers"])
    assert a["device_bytes"] == [None, None]
    assert a["chunks"] > 0


def test_chip_smoke_phase15b_checks_pass_on_the_cpu():
    import chip_smoke

    b, failures = chip_smoke.graft_phase(CPU, shards=4)
    assert failures == []
    assert b["device"] == "cpu" and b["fields"] == 6 + 1 + 6
    assert b["committed"] == 256
    assert b["dryrun"]["shards"] == 4


def test_phase15b_reports_a_step_that_differs(monkeypatch):
    import chip_smoke
    from foundationdb_tpu_torch import graft_entry

    entry = graft_entry.entry

    def flipped(device=None):
        fn, args = entry(device)

        def wrong(state, batch):
            state2, statuses, info = fn(state, batch)
            return state2, statuses.flip(0) * 0, info
        return wrong, args
    monkeypatch.setattr(graft_entry, "entry", flipped)
    _b, failures = chip_smoke.graft_phase(CPU, shards=1)
    assert len(failures) == 1 and "['statuses']" in failures[0]
