"""Keys "be32": the prefix and the record number as 4 big-endian bytes
(skipListTest's setK keys)."""

import numpy as np


def keys(spec, records):
    prefix = spec["prefix"].encode()
    n = len(records)
    raw = np.empty((n, len(prefix) + 4), dtype=np.uint8)
    raw[:, :len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    raw[:, len(prefix):] = np.asarray(records, dtype=">u4").view(
        np.uint8).reshape(n, 4)
    blob, w = raw.tobytes(), raw.shape[1]
    return [blob[i:i + w] for i in range(0, n * w, w)]
