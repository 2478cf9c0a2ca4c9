"""The second half of tests/test_sim_tiers.py's fast-tier sweep, seed for
seed on both packages (see test_torch_sim_sweep.py)."""

import pytest

from test_torch_sim_sweep import HALF
from test_torch_sim_tiers import (  # noqa: F401 — the autouse fixture
    FAST_SWEEP_SEEDS, _knobs, both, randomized)

REST = [s for s in FAST_SWEEP_SEEDS if s not in HALF]


@pytest.mark.parametrize("seed", REST)
def test_sweep_seed_matches_jax(seed):
    port = both(randomized(seed))
    assert port.result.seed == seed
    assert port.result.result.elapsed > 0
