"""chip_smoke.py's phase 14 at a small size on the CPU.

14b: 13a's one-process boot on the transport's C planes (one proxy), its
checks and phase 14's: every resolver batch equal to the oracle, every
acknowledged write read back, the read and GRV fast paths hit, each
storage server and the proxy own their transport's plane, the client
plane settles, no connection degrades to Python. 14a's recorder: the C
pass's chunks of an engine on the CPU, recorded and held byte for byte to
the numpy encoder and a second C pass (`check_encodes`), and a chunk that
differs is reported. `NativeTally` counts which planes served.

The module skips only where there is no C compiler.
"""

import os
import shutil

import pytest
import torch

from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

HAVE_CC = shutil.which(os.environ.get("CC", "cc")) is not None
pytestmark = pytest.mark.skipif(
    not HAVE_CC, reason="no C compiler: the port's extension cannot be built")


@pytest.fixture(autouse=True)
def _port_knobs(monkeypatch):
    monkeypatch.delenv("NET_NATIVE_TRANSPORT", raising=False)
    monkeypatch.delenv("NET_NATIVE_CLIENT", raising=False)
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def test_chip_smoke_phase14b_checks_pass_on_the_cpu(monkeypatch):
    import chip_smoke
    from test_torch_transport import SHAPE_KNOBS, free_addr

    monkeypatch.setattr(chip_smoke, "net_addresses",
                        lambda n: [free_addr() for _ in range(n)])
    b, failures, tally = chip_smoke.native_planes_phase(
        torch.device("cpu"), 1, {"attempts_per_wall_s": 1.0},
        knobs=SHAPE_KNOBS, n_clients=8, n_attempts=3, n_keys=300)
    assert failures == []
    assert b["attempts"] == 24 and b["committed"] >= 1
    assert b["read_back_mismatches"] == {"client": 0, "storage": 0}
    assert b["mismatched_batches"] == 0 and b["resolved_batches"] > 0
    assert b["native_read_hits"] > 0 and b["native_grv_hits"] > 0
    assert b["degraded_connections"] == 0
    assert b["beside_13a"] == {"attempts_per_wall_s": 1.0, "mix_s": None,
                               "committed": None}
    planes = b["planes"]
    assert planes["storage_owners"] == 2 and planes["grv_owners"] == 1
    assert planes["client"]["ClientNativeSettles"] > 0
    summary = tally.summary()
    assert summary["stores"] == {"NativeVersionedMap": 2}
    assert summary["wire_codec"] == "c"
    assert summary["encoder_chunks"]["c"] > 0
    assert summary["encoder_chunks"]["python"] == 0
    assert summary["transports"]["server_tables"] == \
        summary["transports"]["built"]


def test_native_tally_sees_the_python_planes():
    """Without the planes' gates the tally counts no C server table and no
    client plane, and the transports' C counters stay 0."""
    import chip_smoke
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    with chip_smoke.NativeTally("x") as tally:
        t = NetTransport(RealEventLoop(), "127.0.0.1:1")
        t.close()
    s = tally.summary()
    assert s["transports"] == {"built": 1, "server_tables": 0,
                               "client_planes": 0}
    assert not any(s["plane_counters"].values())
    assert s["encoder_chunks"] == {"c": 0, "python": 0}


def test_phase14a_records_and_checks_every_c_chunk():
    import chip_smoke
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet

    cs = DeviceConflictSet(device="cpu", capacity=1024, txns=16,
                           reads_per_txn=2, writes_per_txn=2)
    records, restore = chip_smoke.record_encodes()
    try:
        for v in range(1, 4):
            txns = [TxnConflictInfo(v * 10, [(b"k%d" % t, b"k%d\x00" % t)],
                                    [(b"w%d" % (t + v), b"w%d\x00" % t)])
                    for t in range(40)]
            cs.detect(txns, v * 10 + 5)
    finally:
        restore()
    assert len(records) == 9  # 40 txns a batch in chunks of 16
    out, failures = chip_smoke.check_encodes(records, "cpu")
    assert failures == [] and out["chunks"] == 9
    assert set(out["encode_ms"]) == {"c_run", "c", "numpy"}
    # a recorded chunk whose bytes differ is reported
    records[0]["fields"]["rb"][0, 0] ^= 1
    _out, failures = chip_smoke.check_encodes(records[:1], "cpu")
    assert len(failures) == 2 and "['rb']" in failures[0]
