"""Deterministic RNG.

Reference: flow/DeterministicRandom.h — all simulation code must draw from one
seeded generator (`g_random`) so a run is a pure function of its seed; a
separate nondeterministic generator exists for things that must not affect the
simulation (flow/IRandom.h).

We wrap Python's Mersenne Twister (stable across versions, fast enough for the
host control plane). Device-side randomness uses jax PRNG keys derived from the
same seed.
"""

from __future__ import annotations

import random as _pyrandom


class DeterministicRandom:
    def __init__(self, seed: int):
        self.seed = seed
        self._r = _pyrandom.Random(seed)

    def random(self) -> float:
        return self._r.random()

    def randint(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi] inclusive."""
        return self._r.randint(lo, hi)

    def random_unique_id(self) -> int:
        return self._r.getrandbits(64)

    def random_bytes(self, n: int) -> bytes:
        return self._r.getrandbits(8 * n).to_bytes(n, "little") if n else b""

    def random_choice(self, seq):
        return seq[self._r.randrange(len(seq))]

    def shuffle(self, seq):
        self._r.shuffle(seq)

    def coinflip(self, p: float = 0.5) -> bool:
        return self._r.random() < p

    def fork(self) -> "DeterministicRandom":
        """Derive an independent deterministic stream."""
        return DeterministicRandom(self._r.getrandbits(63))
