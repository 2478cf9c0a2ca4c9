"""Ranges "point": [key, key + b"\\0"), the one key of the record."""

import numpy as np


def draw(rng, spec, begins, key_names):
    uniq, ids = np.unique(begins, return_inverse=True)
    ids = ids.reshape(begins.shape).astype(np.int32)
    table = key_names(uniq)
    table += [k + b"\x00" for k in table]
    return table, ids, ids + np.int32(len(uniq))
