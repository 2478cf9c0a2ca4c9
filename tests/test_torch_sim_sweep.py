"""tests/test_sim_tiers.py's fast-tier sweep, seed for seed on both
packages: each seed draws its cluster and picks its fast spec, and the
port's run must equal the JAX run exactly (the SpecResult, every attempt
and DBInfo with its virtual time, each workload's counters, the final
contents; see test_torch_sim_tiers.py). The 14 seeds draw every
replication mode, engine and backend between them; half run here, half
in test_torch_sim_sweep_rest.py, to keep each file short.
"""

import pytest

from test_torch_sim_tiers import (  # noqa: F401 — the autouse fixture
    FAST_SWEEP_SEEDS, _knobs, both, randomized)


HALF = FAST_SWEEP_SEEDS[:7]


@pytest.mark.parametrize("seed", HALF)
def test_sweep_seed_matches_jax(seed):
    port = both(randomized(seed))
    assert port.result.seed == seed
    assert port.result.result.elapsed > 0
