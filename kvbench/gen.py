"""The one traffic generator: a configuration's key space and a traffic
file's mix, drawn from the seed, as the raw inputs that the program and the
plain reference both take (key bytes, ranges, snapshots, versions).

Nothing here imports the program: the reference must not take anything
the program made, and both sides start from a `Stream`.

A stream is a pool of P batches of T transactions, each with a fixed
number of read and write ranges. Batch j commits at version (j + 1) * step.
The window replays the pool in passes; pass p is the pool with every
version moved up by p * P * step (kvbench/harness.py rebases the engine by
the pool's span at each pass, so the card sees one continuous version
sequence). The MVCC floor before batch j is V(j - 1) - window in every
pass (the engine starts with its floor at -window).

Every part of a mix is drawn by a kind of its own, a module found by name
(kvbench/kinds/<part>/<kind>.py), so a new kind is a new file:

- keys/<format>.py, named by a configuration's "keys": "format":
  `keys(spec, records) -> list[bytes]`, the byte key of each record number;
- requests/<distribution>.py, named by a traffic's "requests":
  "distribution": `draw(rng, spec, records, shape) -> int64 record numbers`;
- ranges/<kind>.py, named by "ranges": "kind":
  `draw(rng, spec, begins, key_names) -> (keys, begin ids, end ids)`, each
  range [keys[begin], keys[end]) from the drawn record numbers `begins`,
  `key_names(records)` giving the configuration's byte keys;
- snapshot/<kind>.py, named by "snapshot": "kind":
  `draw(rng, spec, versions, step, window, shape) -> (P, T) int64`.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import numpy as np

KINDS = Path(__file__).resolve().parent / "kinds"
FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 0x100000001B3


def kind(part: str, name: str):
    """The module kvbench/kinds/<part>/<name>.py."""
    path = KINDS / part / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {part} kind {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        "kvbench_kind_" + "".join(c if c.isalnum() else "_"
                                  for c in f"{part}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fnv64(values: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64 over int64 values: FNV-1a over the 8 low-order
    bytes, then Math.abs of the signed result."""
    v = np.asarray(values, dtype=np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_64, dtype=np.uint64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        h *= np.uint64(FNV_PRIME_64)
        v >>= np.uint64(8)
    return np.abs(h.view(np.int64))


def record_keys(keys: dict, records: np.ndarray) -> list[bytes]:
    """The byte keys of record numbers under a configuration's key format."""
    return kind("keys", keys["format"]).keys(keys, np.asarray(records))


@dataclass
class Stream:
    """A pool of batches as raw inputs. Key ids index `keys`; every range
    is [keys[begin], keys[end])."""

    keys: list[bytes]
    rb: np.ndarray  # (P, T, reads) int32 key ids
    re: np.ndarray
    wb: np.ndarray  # (P, T, writes) int32 key ids
    we: np.ndarray
    snapshot: np.ndarray  # (P, T) int64, pass-0 versions
    versions: np.ndarray  # (P,) int64, pass-0 commit versions
    step: int
    window: int

    @property
    def batches(self) -> int:
        return self.snapshot.shape[0]

    @property
    def txns(self) -> int:
        return self.snapshot.shape[1]

    @property
    def span(self) -> int:
        """Versions a pass moves the stream up by."""
        return self.batches * self.step

    def floors(self) -> np.ndarray:
        """(P,) the MVCC floor before each batch: V(j - 1) - window."""
        return self.versions - self.step - self.window


def make_stream(config: dict, traffic: dict, seed: int) -> Stream:
    """The pool of a configuration under a traffic mix, from `seed`: the
    same seed gives the same stream, and every seed the same sizes."""
    rng = np.random.default_rng(seed)
    keys = config["keys"]
    records = int(keys["records"])
    window = int(config["engine"]["max_write_life"])
    P, T = int(traffic["pool_batches"]), int(traffic["txns_per_batch"])
    nr, nw = int(traffic["reads_per_txn"]), int(traffic["writes_per_txn"])
    step = int(traffic["version_step"])

    req = traffic["requests"]
    begins = kind("requests", req["distribution"]).draw(
        rng, req, records, (P, T, nr + nw))
    ranges = traffic["ranges"]
    table, b, e = kind("ranges", ranges["kind"]).draw(
        rng, ranges, begins, partial(record_keys, keys))
    versions = step * np.arange(1, P + 1, dtype=np.int64)
    snap = traffic["snapshot"]
    snapshot = kind("snapshot", snap["kind"]).draw(
        rng, snap, versions, step, window, (P, T))
    return Stream(keys=table, rb=b[:, :, :nr], re=e[:, :, :nr],
                  wb=b[:, :, nr:], we=e[:, :, nr:], snapshot=snapshot,
                  versions=versions, step=step, window=window)
