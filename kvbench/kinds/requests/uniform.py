"""Requests "uniform": record numbers uniform over the key space."""

import numpy as np


def draw(rng, spec, records, shape):
    return rng.integers(0, records, size=shape, dtype=np.int64)
