"""Snapshots "window_floor": every read of batch j at V(j) - window, the
oldest snapshot still in the window (skipListTest reads at version i of
a batch that commits at i + 50 with the window 50)."""

import numpy as np


def draw(rng, spec, versions, step, window, shape):
    return np.broadcast_to((versions - window)[:, None], shape).copy()
