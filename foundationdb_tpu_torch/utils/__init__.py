"""Utility layer: key encoding, errors, knobs, RNG, tracing, device choice."""

from foundationdb_tpu_torch.utils.errors import FDBError  # noqa: F401
from foundationdb_tpu_torch.utils.knobs import KNOBS, Knobs  # noqa: F401
from foundationdb_tpu_torch.utils.rng import DeterministicRandom  # noqa: F401
