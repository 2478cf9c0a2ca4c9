"""Snapshots "lag_batches": a txn reads at V(j - 1 - lag), the commit
version of the batch `lag` batches before the one before its own, lag
uniform in ["min", "max"] (a read version is always a committed
batch's)."""

import numpy as np


def draw(rng, spec, versions, step, window, shape):
    lag = rng.integers(int(spec["min"]), int(spec["max"]) + 1, size=shape,
                       dtype=np.int64)
    return (versions - step)[:, None] - lag * step
