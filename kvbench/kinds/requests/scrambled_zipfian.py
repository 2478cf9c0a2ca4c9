"""Requests "scrambled_zipfian": YCSB's ScrambledZipfianGenerator, a
zipfian draw over "items" items with the given "theta" and precomputed
"zetan", hashed with FNV-1a 64 and taken modulo the record count."""

import numpy as np

from kvbench import gen


def ycsb_zipfian(u, items: int, theta: float, zetan: float):
    """YCSB ZipfianGenerator.nextLong over `items` items for uniform draws
    `u` in [0, 1) (Gray et al.'s method, as YCSB writes it)."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5 ** theta
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    ret = np.floor(items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ret = np.where(uz < 1.0 + 0.5 ** theta, 1, ret)
    return np.where(uz < 1.0, 0, ret)


def draw(rng, spec, records, shape):
    z = ycsb_zipfian(rng.random(shape), int(spec["items"]),
                     float(spec["theta"]), float(spec["zetan"]))
    return gen.fnv64(z) % records
