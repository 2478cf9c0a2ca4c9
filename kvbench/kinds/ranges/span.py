"""Ranges "span": [key(r), key(r + s)), s uniform in ["min", "max"]
records (skipListTest's key2 = key + 1 + randomInt(0, 10))."""

import numpy as np


def draw(rng, spec, begins, key_names):
    spans = rng.integers(int(spec["min"]), int(spec["max"]) + 1,
                         size=begins.shape, dtype=np.int64)
    uniq, ids = np.unique(np.concatenate([begins.ravel(),
                                          (begins + spans).ravel()]),
                          return_inverse=True)
    ids = ids.astype(np.int32)
    return (key_names(uniq), ids[:begins.size].reshape(begins.shape),
            ids[begins.size:].reshape(begins.shape))
