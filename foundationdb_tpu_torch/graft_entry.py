"""Driver entry points of the port (the counterpart of `__graft_entry__.py`).

- `entry(device=None)`: the flagship device program, the batched MVCC
  conflict step (`ops/conflict_ref.py` `conflict_step`, the resolver's
  engine in place of the reference's `fdbserver/SkipList.cpp`), with an
  example state and batch: `(fn, (state, batch))`, and `fn(*args)` runs
  one step. On a card its phases are the hand-written kernels
  (`ops/kernels.py` `PHASES`); on the CPU their plain versions.
- `dryrun_multichip(n, device=None)`: one conflict set key-partitioned
  over n shards (`parallel/sharded_conflict.py`, the reference's
  multi-resolver topology), and the two-step check of a write spanning
  every shard, then a stale read that must conflict. On CUDA the shards
  are n attached cards; on the CPU n shards share it.

The device is the CONFLICT_DEVICE knob's ("cuda") unless the caller names
one; asking for CUDA where there is none raises platform_error.
"""

from __future__ import annotations

import functools

import numpy as np

from foundationdb_tpu_torch.utils.knobs import KNOBS

ENTRY_SHAPES = dict(capacity=1024, txns=256, reads=256, writes=256)
MAX_WRITE_LIFE = 5_000_000
EXAMPLE_VERSION = 200


def _device(device):
    from foundationdb_tpu_torch.utils import cudaenv
    return cudaenv.resolve_device(KNOBS.CONFLICT_DEVICE if device is None
                                  else device)


def example_txns(shapes, seed: int = 0):
    """The reference's `_example_batch` transactions: one read range and
    one write range a txn, from `np.random.RandomState(seed)`."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo

    rng = np.random.RandomState(seed)
    txns = []
    for _ in range(shapes.txns):
        a, b = sorted(rng.randint(0, 2**31, size=2))
        key_r = a.item().to_bytes(8, "big")
        key_w = b.item().to_bytes(8, "big")
        txns.append(TxnConflictInfo(
            read_snapshot=int(rng.randint(0, 100)),
            read_ranges=[(key_r, key_r + b"\xff")],
            write_ranges=[(key_w, key_w + b"\xff")],
        ))
    return txns


def _example_batch(shapes, device, seed: int = 0) -> dict:
    """The example chunk encoded by the port's `BatchEncoder` on
    `device`, at commit version EXAMPLE_VERSION."""
    from foundationdb_tpu_torch.ops.conflict import BatchEncoder

    return BatchEncoder(shapes, device).encode_batch(
        example_txns(shapes, seed), commit_version=EXAMPLE_VERSION)


def entry(device=None):
    """(fn, (state, batch)): one conflict step at K=1,024, T=256, 256
    reads and 256 writes, the default MVCC window; `fn(state, batch)` ->
    (state', statuses, info) leaves its inputs as they were."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import ConflictShapes

    dev = _device(device)
    shapes = ConflictShapes(**ENTRY_SHAPES)
    phases = kernels.PHASES if dev.type == "cuda" else ref.PLAIN
    fn = functools.partial(ref.conflict_step, max_write_life=MAX_WRITE_LIFE,
                           phases=phases)
    state = ref.init_state(shapes.capacity, shapes.limbs, dev,
                           phases=phases)
    return fn, (state, _example_batch(shapes, dev))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded conflict set over `n_devices` shards
    (`make_resolver_mesh`: n attached cards on CUDA, more than are
    attached raising invalid_option; n shards sharing the CPU on the CPU)
    and two steps: a write spanning every shard commits, then a read of
    an older snapshot over it conflicts. Raises RuntimeError on a wrong
    verdict; returns both steps' statuses."""
    from foundationdb_tpu_torch.ops.batch import COMMITTED, TxnConflictInfo
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        ShardedDeviceConflictSet, make_resolver_mesh)

    devices = make_resolver_mesh(n_devices, _device(device).type)
    cs = ShardedDeviceConflictSet(
        devices=devices, capacity=64, txns=8, reads_per_txn=2,
        writes_per_txn=2)
    whole = (b"\x00", b"\xff\xff")
    first = cs.detect(
        [TxnConflictInfo(read_snapshot=0, write_ranges=[whole]),
         TxnConflictInfo(read_snapshot=0, read_ranges=[(b"\x80", b"\x81")])],
        commit_version=10)
    if first[0] != COMMITTED:
        raise RuntimeError(f"the write spanning {n_devices} shards did not "
                           f"commit: {first}")
    second = cs.detect(
        [TxnConflictInfo(read_snapshot=5, read_ranges=[(b"\x80", b"\x81")])],
        commit_version=20)
    if second[0] == COMMITTED:
        raise RuntimeError(f"a read at snapshot 5 over the write at 10 "
                           f"committed on {n_devices} shards: {second}")
    return {"shards": len(devices), "devices": [str(d) for d in devices],
            "first": list(first), "second": list(second)}
